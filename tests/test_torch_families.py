"""The MoE and MLA families through the port's model, engines and
launcher on the CPU, held against the JAX package at fp32.

Models: the smoke Moonshot-v1-16B-A3B (a dense layer, then an MoE layer
of 8 experts top-2 with one shared expert) and the smoke DeepSeek-V3
(the same with MLA attention and an MTP block), and tinylm.  Parameters
are the port's seeded draw, handed to the reference in its own layout by
``bridge.params_to_jax`` (as numpy; drawing them with the reference's
``init_params`` costs a compile per leaf); token inputs come from numpy.

* ``decoder.forward`` logits, ``moe_aux``, statistics and cache material
  within 1e-5 of the reference's; ``decode_step`` from the filled caches
  within 1e-5 of the reference's;
* ``GenerationEngine`` greedy streams, dense and GRIFFIN 0.5, token for
  token the JAX engine's; GRIFFIN at sparsity 0.0 gives the dense stream;
* ``ContinuousBatcher`` (2 slots, 4 requests of mixed lengths, GRIFFIN
  0.5) streams equal the JAX batcher's on the MoE config and on tinylm
  (``tests/test_system.py``'s cases), and one request equals the engine;
* GRIFFIN budgets (``plan_k_tree``) and Adaptive Wanda's replaced
  weights cover the shared experts as the reference's do;
* the bridged tree has the reference's layout, shapes and dtypes (MTP
  block, stacked expert leaves and the fp32 router of a bf16 model
  included), and ``params_to_jax(params_from_jax(tree))`` gives it back;
* ``supports_paged`` is the reference's for every arch of its registry;
* ``launch.serve`` serves the MoE/MLA archs through the slot batcher and
  refuses what the reference refuses there.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.core import evaluate as jev  # noqa: E402
from repro.core import griffin as jg  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serving.engine import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serving.engine import GenerationEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import evaluate as tev  # noqa: E402
from repro_torch.core import griffin as tg  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.serving.engine import ContinuousBatcher, GenerationEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v3-671b")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    """Torch leaves -> numpy (bf16 as ``ml_dtypes.bfloat16``, bit for bit)."""
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return tree.numpy()


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, port cfg, numpy params, torch params)."""
    out = {}
    for arch in ARCHS + ("tinylm",):
        smoke = arch != "tinylm"
        cfg, tcfg = jreg.get_config(arch, smoke=smoke), tget(arch, smoke=smoke)
        tp = tdec.init_params(tcfg, 0, "cpu")
        out[arch] = (cfg, tcfg, _numpy(bridge.params_to_jax(tp, tcfg)), tp)
    return out


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


@pytest.fixture(scope="module")
def jax_forward(models):
    """arch -> the reference's jitted forward over 2 x 13 tokens with
    every statistic and the cache material (numpy trees)."""
    out = {}
    for arch in ARCHS:
        cfg, _, jp, _ = models[arch]
        f = jax.jit(lambda p, t, c=cfg: jdec.forward(
            p, c, t, collect_stats=True, want_kv=True, want_z=True, remat=False))
        logits, aux = f(jp, jnp.asarray(_tokens(0, (2, 13))))
        out[arch] = (np.asarray(logits), jax.tree.map(np.asarray, aux))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(models, jax_forward, arch):
    cfg, tcfg, _, tp = models[arch]
    want, aux_j = jax_forward[arch]
    got, aux = tdec.forward(tp, tcfg, torch.from_numpy(_tokens(0, (2, 13))),
                            collect_stats=True, want_kv=True, want_z=True, q_chunk=5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(float(aux.moe_aux), float(aux_j.moe_aux), **TOL)
    assert float(aux.moe_aux) > 0
    want_st = bridge.tree_from_jax(jdec.prune_stats_tree(aux_j.stats, cfg), tcfg, "cpu")
    assert sorted(aux.stats) == sorted(want_st) == [0, 1]
    assert aux.stats[1]["s_sq"].shape == (2, cfg.moe_d_ff * cfg.num_shared_experts)
    for li, st in want_st.items():
        for k, v in st.items():
            np.testing.assert_allclose(aux.stats[li][k].numpy(), v.numpy(),
                                       err_msg=f"layer {li} {k}", **TOL)
    want_kv = bridge.tree_from_jax(aux_j.kv, tcfg, "cpu")
    assert sorted(aux.kv[0]) == (["ckv", "kr"] if cfg.use_mla else ["k", "v"])
    for li, kv in want_kv.items():
        for k, v in kv.items():
            np.testing.assert_allclose(aux.kv[li][k].numpy(), v.numpy(), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_jax(models, jax_forward, arch):
    """Three steps after the 13-token prefill, from caches of 16, each
    within 1e-5 of the reference's step.  (Not held to the full forward:
    a 32-token forward gives each expert another capacity than a 2-token
    step, so the two drop different tokens, in both packages.)"""
    cfg, tcfg, jp, tp = models[arch]
    toks = np.concatenate([_tokens(0, (2, 13)), _tokens(1, (2, 3))], axis=1)
    _, aux = tdec.forward(tp, tcfg, torch.from_numpy(toks[:, :13]), want_kv=True,
                          logits_mode="last")
    cache = tdec.fill_cache_from_prefill(tcfg, tdec.init_cache(tcfg, 2, 16, "cpu"),
                                         aux.kv)
    jcache = jdec.fill_cache_from_prefill(cfg, jdec.init_cache(cfg, 2, 16),
                                          jax_forward[arch][1].kv)
    step = jax.jit(lambda c, t, pos: jdec.decode_step(jp, cfg, c, t, pos))
    for t in range(13, 16):
        tok = toks[:, t : t + 1]
        got, cache = tdec.decode_step(tp, tcfg, cache, torch.from_numpy(tok), t)
        want, jcache = step(jcache, jnp.asarray(tok), jnp.int32(t))
        np.testing.assert_allclose(got[:, 0].numpy(), np.asarray(want)[:, 0],
                                   err_msg=f"step {t}", **TOL)


@pytest.mark.parametrize("griffin", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_jax(models, arch, griffin):
    cfg, tcfg, jp, tp = models[arch]
    prompts = _tokens(3, (2, 16))
    g = dict(sparsity=0.5) if griffin else None
    want = JaxEngine(cfg, jax.tree.map(jnp.asarray, jp),
                     None if g is None else jg.GriffinConfig(**g),
                     max_len=32).generate(jnp.asarray(prompts), 12)
    got = GenerationEngine(tcfg, tp, None if g is None else tg.GriffinConfig(**g),
                           max_len=32, device="cpu").generate(prompts, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 4  # not degenerate


@pytest.mark.parametrize("arch", ARCHS)
def test_griffin_zero_sparsity_equals_dense(models, arch):
    """The paper's exactness anchor on the port: k = F keeps every column
    in order, so the compacted model is the dense one."""
    _, tcfg, _, tp = models[arch]
    prompts = _tokens(4, (2, 16))
    dense = GenerationEngine(tcfg, tp, None, max_len=32, device="cpu") \
        .generate(prompts, 10)
    eng = GenerationEngine(tcfg, tp, tg.GriffinConfig(sparsity=0.0), max_len=32,
                           device="cpu")
    assert torch.equal(eng.generate(prompts, 10), dense)
    _, aux = eng.prefill(torch.from_numpy(prompts))
    for li, ffn in eng.select_and_compact(aux.stats).items():
        full = tdec.extract_ffn_tree(tp, tcfg)[li]
        assert all(torch.equal(ffn[k], full[k]) for k in full)


def _batch(cls, cfg, params, **kw):
    """4 requests of prompt lengths 6/11/6/11 and 3-6 new tokens through
    2 slots with GRIFFIN 0.5 (``tests/test_system.py``'s mixed case)."""
    b = cls(cfg, params, n_slots=2, max_len=32, **kw)
    for i in range(4):
        b.submit((np.arange(6 + 5 * (i % 2)) * (7 + i)) % 256, max_new=3 + i, rid=i)
    return b.run()


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "tinylm"])
def test_continuous_batcher_matches_jax(models, arch):
    cfg, tcfg, jp, tp = models[arch]
    want = _batch(JaxBatcher, cfg, jax.tree.map(jnp.asarray, jp),
                  gcfg=jg.GriffinConfig(0.5, per_shard_topk=False))
    got = _batch(ContinuousBatcher, tcfg, tp, device="cpu",
                 gcfg=tg.GriffinConfig(0.5, per_shard_topk=False))
    assert got == want
    assert {k: len(v) for k, v in got.items()} == {0: 3, 1: 4, 2: 5, 3: 6}


def test_continuous_batcher_one_request_equals_engine(models):
    """``tests/test_system.py::test_continuous_batching_matches_engine``
    on the port's MLA model."""
    _, tcfg, _, tp = models["deepseek-v3-671b"]
    prompt = (np.arange(24) * 7) % 256
    want = GenerationEngine(tcfg, tp, None, max_len=64, device="cpu") \
        .generate(prompt[None].astype(np.int32), 5)[0].tolist()
    cb = ContinuousBatcher(tcfg, tp, n_slots=1, max_len=64, device="cpu")
    cb.submit(prompt, max_new=5, rid=0)
    assert cb.run() == {0: want}


@pytest.mark.parametrize("arch", ARCHS)
def test_griffin_budgets_and_wanda_cover_shared_experts(models, jax_forward, arch):
    cfg, tcfg, jp, tp = models[arch]
    for smoke in (True, False):  # the full configs' widths: 2816, 2048
        c, tc = jreg.get_config(arch, smoke=smoke), tget(arch, smoke=smoke)
        ks = jg.plan_k_tree(c, jg.GriffinConfig(sparsity=0.5))
        want = {li: ks[path][inst]
                for li, (path, inst, _) in enumerate(tdec.layer_paths(tc))}
        assert tg.plan_k_tree(tc, tg.GriffinConfig(sparsity=0.5)) == want
        assert tg.ffn_widths(tc)[c.num_layers - 1] == c.moe_d_ff * c.num_shared_experts
    # Adaptive Wanda masks the shared experts and leaves the routed ones
    stats = jax_forward[arch][1].stats
    _, want = jax.jit(lambda p, st: jev.build_pruned("wanda", p, cfg, st, 0.5))(
        jp, stats)
    _, got = tev.build_pruned("wanda", tp, tcfg,
                              bridge.tree_from_jax(stats, tcfg, "cpu"), 0.5)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, want), tcfg, "cpu")
    moe = got["layers"][1]["ffn"]
    assert moe["w1"] is tp["layers"][1]["ffn"]["w1"]  # routed: untouched
    assert float((moe["shared"]["w1"] == 0).float().mean()) == pytest.approx(0.5, abs=0.05)
    for li in (0, 1):
        ffn = got["layers"][li]["ffn"]
        for k, v in (ffn["shared"] if li else ffn).items():
            ref = want["layers"][li]["ffn"]
            np.testing.assert_array_equal(v.numpy(), (ref["shared"] if li else ref)[k])


def _layout(tree):
    return [(jax.tree_util.keystr(p), tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def test_bridge_round_trip_carries_mtp_and_dtypes(models):
    """The port's tree goes to the reference's layout (the shapes and
    dtypes of the reference's ``abstract_params``, fp32 and bf16) and
    comes back leaf for leaf, MTP block and stacked expert leaves
    included; a bf16 tree keeps its fp32 router."""
    cfg, tcfg, jp, _ = models["deepseek-v3-671b"]
    bf = jax.tree_util.tree_map_with_path(
        lambda p, v: v if "router" in jax.tree_util.keystr(p)
        else v.astype(ml_dtypes.bfloat16), jp)
    assert _layout(jp) == _layout(jdec.abstract_params(cfg))
    assert _layout(bf) == _layout(jdec.abstract_params(cfg.replace(dtype="bfloat16")))
    for tree in (jp, bf):
        tp = bridge.params_from_jax(tree, tcfg, "cpu")
        assert tp["mtp"]["layer"]["ffn"]["w1"].shape == (8, 64, 32)
        assert tp["layers"][1]["ffn"]["router"].dtype == torch.float32
        back = bridge.params_to_jax(tp, tcfg)
        flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
        flat_w = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [p for p, _ in flat_b] == [p for p, _ in flat_w]
        for (p, got), (_, want) in zip(flat_b, flat_w):
            if want.dtype == ml_dtypes.bfloat16:
                assert got.dtype == torch.bfloat16, p
                got, want = got.view(torch.int16).numpy(), want.view(np.int16)
            np.testing.assert_array_equal(np.asarray(got), want, err_msg=str(p))
    # the port's own bf16 draw honours the router spec's dtype the same way
    tb = tdec.init_params(tcfg.replace(dtype="bfloat16"), 0, "cpu")
    assert _layout(_numpy(bridge.params_to_jax(tb, tcfg))) == _layout(bf)


@pytest.mark.parametrize("arch", jreg.list_archs())
def test_supports_paged_is_the_reference_predicate(arch):
    """For every arch of the reference's registry, full and smoke size
    and with the int8 cache; the contiguous path admits the attention
    families and nothing else."""
    for smoke in (False, True):
        cfg = jreg.get_config(arch, smoke=smoke)
        for c in (cfg, cfg.replace(kv_cache_int8=True)):
            assert tdec.supports_paged(c) == jdec.supports_paged(c), (arch, smoke)
        attn = all(d.mixer == "attn" for d in jdec.layer_descs(cfg))
        assert tdec.supports_contiguous(cfg) == (attn and not cfg.frontend)


def test_launcher_serves_moe_through_the_slot_batcher(capsys):
    """``--arch moonshot-v1-16b-a3b`` serves the smoke config (seed-0
    init drawn on the CPU) through the ``ContinuousBatcher``: the streams
    of the batcher built directly, and the reference's summary line."""
    argv = ["--arch", "moonshot-v1-16b-a3b", "--device", "cpu", "--requests", "3",
            "--max-len", "48", "--slots", "2"]
    got = serve.main(argv)
    out = capsys.readouterr().out
    assert "[GRIFFIN@50%] slots: served 3 requests / " in out
    assert "tok/s, 2 slots)" in out
    cfg = tget("moonshot-v1-16b-a3b", smoke=True)
    cb = ContinuousBatcher(cfg, tdec.init_params(cfg, 0, "cpu"), n_slots=2,
                           max_len=48, gcfg=tg.GriffinConfig(sparsity=0.5),
                           device="cpu")
    for rid, (prompt, gen) in enumerate(serve.synthetic_requests(cfg, 3, 48)):
        cb.submit(prompt, max_new=gen, rid=rid)
    assert got == cb.run()
    assert f"{sum(len(v) for v in got.values())} tokens" in out


@pytest.mark.parametrize("argv,needle", [
    (["--arch", "deepseek-v3-671b", "--spec-k", "2"], "falls back to the slot batcher"),
    (["--arch", "deepseek-v3-671b", "--http", "127.0.0.1:0"], "--http requires"),
    (["--arch", "moonshot-v1-16b-a3b", "--trace-out", "t.json"], "observability"),
    (["--arch", "moonshot-v1-16b-a3b", "--flocking-telemetry", "2"], "observability"),
    (["--arch", "recurrentgemma-9b"], "item 11"),
    (["--arch", "hubert-xlarge"], "item 11"),
    (["--arch", "llava-next-34b"], "item 11"),
])
def test_launcher_refuses_on_the_slot_fallback(argv, needle, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu"] + argv)
    assert e.value.code == 2
    assert needle in capsys.readouterr().err
