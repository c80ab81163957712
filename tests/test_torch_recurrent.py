"""The recurrent families through the port's layers, model, engines,
protocols and launcher on the CPU, held against the JAX package at fp32.

Models: the smoke Mamba2-1.3B (2 SSD layers, no FF, chunk 32) and the
smoke RecurrentGemma-9B (rec, rec, local-attention MQA with a window of
16, a GeGLU FF in every block).  Parameters are the port's seeded draw
with the layers' projection matrices scaled by 2 (at the init's scale
the hybrid's greedy streams repeat one token), handed to the reference
in its own layout by ``bridge.params_to_jax``; inputs come from numpy.

* ``ssd_chunked``, ``ssm_forward`` / ``ssm_decode`` and ``rglru_forward``
  / ``rglru_decode`` within 1e-5 of the reference's, with a carried
  state, S not a multiple of the chunk and S < ``conv_width - 1``; the
  port's own scan against its own step loop within the reference's 2e-4
  (``tests/test_layers.py``: a log-depth scan and a step loop add in
  another order);
* ``decoder.forward`` logits and cache material, and ``decode_step``
  from the filled caches, within 1e-5 of the reference's (the hybrid's
  ring wraps in the prompt and in decode);
* ``GenerationEngine`` greedy streams token for token the JAX engine's
  (RecurrentGemma dense and GRIFFIN 0.5, Mamba2 dense), GRIFFIN 0.0 the
  dense stream; ``ContinuousBatcher`` streams the JAX batcher's;
* ``classification_sim`` and ``generation_ppl`` on the hybrid equal the
  reference's; with the full model as the "pruned" one the two steps
  agree everywhere, which they do only when the recurrent state is put
  back between them;
* the bridge round trip over the hybrid's ``seg0/pos{0,1,2}`` +
  ``seg1/layer{0,1}`` layout, fp32 and bf16, and GRIFFIN budgets of the
  full configs;
* ``launch.serve`` serves both archs through the slot batcher and
  refuses there what the reference refuses.
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
from repro.models.layers import rglru as jrglru  # noqa: E402
from repro.models.layers import ssm as jssm  # noqa: E402
from repro.serving.engine import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serving.engine import GenerationEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import evaluate as tev  # noqa: E402
from repro_torch.core import griffin as tg  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402
from repro_torch.models.layers import rglru as trglru  # noqa: E402
from repro_torch.models.layers import ssm as tssm  # noqa: E402
from repro_torch.serving.engine import ContinuousBatcher, GenerationEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
#: the reference's own tolerance for a scan against a step loop
SCAN_TOL = dict(rtol=2e-4, atol=2e-4)
SSM, HYB = "mamba2-1.3b", "recurrentgemma-9b"
ARCHS = (SSM, HYB)
#: prompt lengths of the model tests: shorter than the conv tail, and
#: longer than both the SSD chunk (32 is not a divisor) and the window
PROMPTS = (2, 37)
STEPS = 4


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


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def scaled_init(tcfg, s=2.0):
    """The port's seed-0 draw with every layer matrix but the gates and
    the conv taps multiplied by ``s``."""
    tp = tdec.init_params(tcfg, 0, "cpu")
    for lp in tp["layers"]:
        for group in ("mixer", "ffn"):
            for k, v in lp.get(group, {}).items():
                if v.dim() >= 2 and k not in ("w_a", "w_i", "conv_w"):
                    v.mul_(s)
    return tp


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, port cfg, numpy params, torch params)."""
    out = {}
    for arch in ARCHS:
        cfg, tcfg = jreg.get_config(arch, smoke=True), tget(arch, smoke=True)
        tp = scaled_init(tcfg)
        out[arch] = (cfg, tcfg, _numpy(bridge.params_to_jax(tp, tcfg)), tp)
    return out


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _mixer_params(arch, specs_fn, seed=1):
    """A mixer's seeded draw with every vector leaf (biases, a_log, lam,
    d_skip, norm) redrawn, so no term is a zero or a one."""
    tcfg = tget(arch, smoke=True)
    tp = tparam.init_params(specs_fn(tcfg), 0, "float32", "cpu")
    rng = np.random.default_rng(seed)
    for k, v in tp.items():
        if v.dim() == 1:
            tp[k] = torch.from_numpy(
                (0.3 * rng.standard_normal(v.shape)).astype(np.float32))
    return jreg.get_config(arch, smoke=True), tcfg, tp, \
        {k: jnp.asarray(v.numpy()) for k, v in tp.items()}


def _close(got, want, msg="", **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=msg,
                               **(tol or TOL))


@pytest.mark.parametrize("S,chunk", [(16, 4), (20, 8), (7, 16)])
def test_ssd_chunked_matches_jax(S, chunk):
    """Padded chunks (20 over 8, 7 over 16) and a carried state."""
    rng = np.random.default_rng(S)
    Bt, H, P, G, N = 2, 4, 8, 2, 16
    xh = 0.5 * rng.standard_normal((Bt, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bt, S, H)))).astype(np.float32)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(np.float32)
    Bv, Cv = (0.5 * rng.standard_normal((Bt, S, G, N)).astype(np.float32)
              for _ in range(2))
    init = rng.standard_normal((Bt, H, P, N)).astype(np.float32)
    args = (xh, dt, A, Bv, Cv, init)
    y_j, st_j = jssm.ssd_chunked(*map(jnp.asarray, args), chunk)
    y_t, st_t = tssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    _close(y_t, y_j)
    _close(st_t, st_j)


def _layer_case(fwd_j, fwd_t, dec_j, dec_t, cfg, tcfg, tp, jp, S, carry):
    """Forward over S tokens (after a carried state when ``carry``), then
    three decode steps from the forward's cache, each held to the
    reference's; returns the port's caches."""
    rng = np.random.default_rng(100 + S)
    x = rng.standard_normal((2, S + 3, cfg.d_model)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if carry is not None:
        shape = (2, cfg.ssm_nheads, cfg.ssm_head_dim, cfg.ssm_state) \
            if carry == "init_state" else (2, cfg.lru_width)
        st = rng.standard_normal(shape).astype(np.float32)
        kw_j, kw_t = {carry: jnp.asarray(st)}, {carry: torch.from_numpy(st)}
    fwd_j = jax.jit(fwd_j, static_argnums=2)
    dec_j = jax.jit(dec_j, static_argnums=3)
    y_j, c_j = fwd_j(jp, jnp.asarray(x[:, :S]), cfg, **kw_j)
    y_t, c_t = fwd_t(tp, torch.from_numpy(x[:, :S]), tcfg, **kw_t)
    _close(y_t, y_j, f"forward S={S}")
    assert sorted(c_t) == sorted(c_j)
    for k in c_j:
        _close(c_t[k], c_j[k], f"cache {k} S={S}")
    if S < cfg.conv_width - 1:  # the tail is left-padded with zeros
        assert not c_t["conv"][:, : cfg.conv_width - 1 - S].any()
    for t in range(S, S + 3):
        y_j, c_j = dec_j(jp, c_j, jnp.asarray(x[:, t : t + 1]), cfg)
        y_t, c_t = dec_t(tp, c_t, torch.from_numpy(x[:, t : t + 1]), tcfg)
        _close(y_t, y_j, f"decode {t}")
        for k in c_j:
            _close(c_t[k], c_j[k], f"decode {t} cache {k}")
    return c_t


@pytest.mark.parametrize("carry", [None, "init_state"])
@pytest.mark.parametrize("S", [2, 45])
def test_ssm_layer_matches_jax(S, carry):
    cfg, tcfg, tp, jp = _mixer_params(SSM, tssm.ssm_specs)
    _layer_case(jssm.ssm_forward, tssm.ssm_forward, jssm.ssm_decode,
                tssm.ssm_decode, cfg, tcfg, tp, jp, S, carry)


@pytest.mark.parametrize("carry", [None, "init_h"])
@pytest.mark.parametrize("S", [2, 45])
def test_rglru_layer_matches_jax(S, carry):
    cfg, tcfg, tp, jp = _mixer_params(HYB, trglru.rglru_specs)
    _layer_case(jrglru.rglru_forward, trglru.rglru_forward, jrglru.rglru_decode,
                trglru.rglru_decode, cfg, tcfg, tp, jp, S, carry)


@pytest.mark.parametrize("S", [1, 12, 45])
def test_rglru_scan_matches_steps(S):
    """The port's associative scan against its own step loop, at the
    reference's scan-versus-steps tolerance (the two add in another
    order), and the scan's odd/even recursion against a plain loop."""
    _, tcfg, tp, _ = _mixer_params(HYB, trglru.rglru_specs)
    x = torch.from_numpy(np.random.default_rng(S).standard_normal(
        (2, S, tcfg.d_model)).astype(np.float32))
    y_full, c_full = trglru.rglru_forward(tp, x, tcfg)
    cache = tparam.init_params(trglru.rglru_cache_specs(tcfg, 2), 0, "float32",
                               "cpu")
    y_steps = torch.cat([trglru.rglru_decode(tp, cache, x[:, t : t + 1], tcfg)[0]
                         for t in range(S)], dim=1)
    _close(y_steps, y_full, **SCAN_TOL)
    _close(cache["h"], c_full["h"], **SCAN_TOL)
    gen = torch.Generator().manual_seed(S)
    a, b = torch.rand(2, S, 5, generator=gen), torch.randn(2, S, 5, generator=gen)
    h, want = torch.zeros(2, 5), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    _close(trglru.associative_scan(a, b)[1], torch.stack(want, 1), **SCAN_TOL)


# ---------------------------------------------------------------------------
# Model: forward, caches, decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_model(models):
    """(arch, prompt length) -> the reference's forward logits and cache
    material over 2 x (S + STEPS) tokens and 2 x S, and its decode
    logits from the filled caches (numpy)."""
    out = {}
    for arch in ARCHS:
        cfg, _, jp, _ = models[arch]
        step = jax.jit(lambda c, t, pos, cfg=cfg, jp=jp: jdec.decode_step(
            jp, cfg, c, t, pos))
        for S in PROMPTS:
            toks = _tokens(S, (2, S + STEPS))
            full, _ = jdec.forward(jp, cfg, jnp.asarray(toks), remat=False)
            last, aux = jdec.forward(jp, cfg, jnp.asarray(toks[:, :S]),
                                     want_kv=True, remat=False, logits_mode="last")
            cache = jdec.fill_cache_from_prefill(
                cfg, jdec.init_cache(cfg, 2, S + STEPS), aux.kv)
            dec = []
            for t in range(S, S + STEPS):
                lg, cache = step(cache, jnp.asarray(toks[:, t : t + 1]), jnp.int32(t))
                dec.append(np.asarray(lg)[:, 0])
            out[arch, S] = dict(toks=toks, full=np.asarray(full),
                                last=np.asarray(last),
                                kv=jax.tree.map(np.asarray, aux.kv), dec=dec)
    return out


@pytest.mark.parametrize("S", PROMPTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_decode_match_jax(models, jax_model, arch, S):
    cfg, tcfg, _, tp = models[arch]
    ref = jax_model[arch, S]
    toks = torch.from_numpy(ref["toks"])
    full, _ = tdec.forward(tp, tcfg, toks)
    _close(full, ref["full"])
    last, aux = tdec.forward(tp, tcfg, toks[:, :S], want_kv=True,
                             logits_mode="last", q_chunk=8)
    _close(last, ref["last"])
    want_kv = bridge.tree_from_jax(ref["kv"], tcfg, "cpu")
    for li, kv in want_kv.items():
        assert sorted(aux.kv[li]) == sorted(kv)
        for k, v in kv.items():
            _close(aux.kv[li][k], v, f"layer {li} {k}")
    cache = tdec.fill_cache_from_prefill(
        tcfg, tdec.init_cache(tcfg, 2, S + STEPS, "cpu"), aux.kv)
    if arch == HYB:  # fp32 state, conv tail and a ring of the window
        assert cache[0]["h"].dtype == torch.float32
        assert cache[2]["k"].shape[1] == min(cfg.sliding_window, S + STEPS)
    for i, t in enumerate(range(S, S + STEPS)):
        got, cache = tdec.decode_step(tp, tcfg, cache, toks[:, t : t + 1], t)
        _close(got[:, 0], ref["dec"][i], f"step {t}")
        # and the decode path agrees with the full forward (the
        # reference's tests/test_decode_equivalence.py bound)
        _close(got[:, 0], ref["full"][:, t], **SCAN_TOL)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

ENGINE_CASES = [(HYB, None), (HYB, 0.5), (SSM, None)]


@pytest.mark.parametrize("arch,sparsity", ENGINE_CASES)
def test_engine_greedy_matches_jax(models, arch, sparsity):
    """16-token prompts and 12 new tokens: the hybrid's ring of 16 wraps."""
    cfg, tcfg, jp, tp = models[arch]
    prompts = _tokens(3, (2, 16))
    want = JaxEngine(cfg, jax.tree.map(jnp.asarray, jp),
                     None if sparsity is None else jg.GriffinConfig(sparsity),
                     max_len=32).generate(jnp.asarray(prompts), 12)
    eng = GenerationEngine(tcfg, tp, None if sparsity is None
                           else tg.GriffinConfig(sparsity), max_len=32, device="cpu")
    assert (eng.gcfg is None) == (sparsity is None or not tcfg.has_ffn)
    got = eng.generate(prompts, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 4  # not degenerate


def test_griffin_zero_sparsity_equals_dense(models):
    _, tcfg, _, tp = models[HYB]
    prompts = _tokens(4, (2, 16))
    dense = GenerationEngine(tcfg, tp, None, max_len=32, device="cpu") \
        .generate(prompts, 10)
    eng = GenerationEngine(tcfg, tp, tg.GriffinConfig(sparsity=0.0), max_len=32,
                           device="cpu")
    assert torch.equal(eng.generate(prompts, 10), dense)


def _batch(cls, cfg, params, **kw):
    """4 requests of prompt lengths 6/11/6/11 and 3-6 new tokens through
    2 slots with GRIFFIN 0.5 (dropped for Mamba2, which has no FF)."""
    b = cls(cfg, params, n_slots=2, max_len=32, **kw)
    for i in range(4):
        b.submit((np.arange(6 + 5 * (i % 2)) * (7 + i)) % 256, max_new=3 + i, rid=i)
    return b.run()


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_batcher_matches_jax(models, arch):
    cfg, tcfg, jp, tp = models[arch]
    want = _batch(JaxBatcher, cfg, jax.tree.map(jnp.asarray, jp),
                  gcfg=jg.GriffinConfig(0.5, per_shard_topk=False))
    got = _batch(ContinuousBatcher, tcfg, tp, device="cpu",
                 gcfg=tg.GriffinConfig(0.5, per_shard_topk=False))
    assert got == want
    assert {k: len(v) for k, v in got.items()} == {0: 3, 1: 4, 2: 5, 3: 6}


# ---------------------------------------------------------------------------
# Protocols
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_decode(models):
    """One jitted reference decode step shared by every method's PPL run."""
    cfg = models[HYB][0]
    return jax.jit(lambda p, c, pr, t, pos: jdec.decode_step(p, cfg, c, t, pos, pr))


@pytest.mark.parametrize("method", ["full", "griffin", "magnitude"])
def test_protocols_match_jax_on_the_hybrid(models, jax_decode, method):
    """``classification_sim`` takes a pruned and a full step from one
    cache: the port's recurrent state moves in place, so the protocol
    must put it back in between.  With ``full``, both steps are the same
    model and must agree on every row."""
    cfg, tcfg, jp, tp = models[HYB]
    jp = jax.tree.map(jnp.asarray, jp)
    seqs = _tokens(6, (8, 24))
    want = jev.classification_sim(jp, cfg, jnp.asarray(seqs), method)
    got = tev.classification_sim(tp, tcfg, seqs, method)
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-5)
    assert got["agree_full"] == want["agree_full"]
    assert got["acc"] == want["acc"]
    if method == "full":
        assert got["agree_full"] == 1.0
    want_ppl = jev.generation_ppl(jp, cfg, jnp.asarray(seqs[:2]), 18, method,
                                  decode_jit=jax_decode)
    got_ppl = tev.generation_ppl(tp, tcfg, seqs[:2], 18, method)
    np.testing.assert_allclose(got_ppl, want_ppl, rtol=1e-5)


def test_recurrent_state_round_trip(models):
    """``recurrent_state`` copies exactly the recurrent leaves, and
    restoring them undoes a step's in-place update."""
    _, tcfg, _, tp = models[HYB]
    toks = torch.from_numpy(_tokens(7, (1, 9)))
    _, aux = tdec.forward(tp, tcfg, toks[:, :8], want_kv=True, logits_mode="last")
    cache = tdec.fill_cache_from_prefill(tcfg, tdec.init_cache(tcfg, 1, 12, "cpu"),
                                         aux.kv)
    saved = tdec.recurrent_state(tcfg, cache)
    assert sorted(saved) == [0, 1] and sorted(saved[0]) == ["conv", "h"]
    first, _ = tdec.decode_step(tp, tcfg, cache, toks[:, 8:], 8)
    assert not torch.equal(cache[0]["h"], saved[0]["h"])
    tdec.restore_recurrent_state(cache, saved)
    again, _ = tdec.decode_step(tp, tcfg, cache, toks[:, 8:], 8)
    assert torch.equal(first, again)


# ---------------------------------------------------------------------------
# Bridge, budgets, launcher
# ---------------------------------------------------------------------------

def _layout(tree):
    return [(jax.tree_util.keystr(p), tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_hybrid_layout(dtype):
    """8 layers of the smoke hybrid lay out as the 38 of the full model
    do: ``seg0/pos{0,1,2}`` stacked (rec, rec, attn) and ``seg1/layer{0,1}``
    (rec, rec).  The port's tree goes to the reference's layout (its
    ``abstract_params``' shapes and dtypes) and comes back leaf for leaf."""
    cfg = jreg.get_config(HYB, smoke=True).replace(num_layers=8, dtype=dtype)
    tcfg = tget(HYB, smoke=True).replace(num_layers=8, dtype=dtype)
    full = jreg.get_config(HYB)
    assert [(s.kind, s.n, len(s.descs)) for s in jdec.build_plan(full)] == \
        [("scan", 12, 3), ("unroll", 2, 2)]
    assert [p for p, _, _ in tdec.layer_paths(tget(HYB))][-3:] == \
        ["seg0/pos2", "seg1/layer0", "seg1/layer1"]
    tp = tdec.init_params(tcfg, 0, "cpu")
    back = _numpy(bridge.params_to_jax(tp, tcfg))
    assert _layout(back) == _layout(jdec.abstract_params(cfg))
    rec = back["seg0"]["pos0"]["mixer"]
    assert rec["w_a"].shape == (2, 16, 4, 4) and rec["lam"].shape == (2, 64)
    assert rec["b_a"].dtype == back["embed"]["table"].dtype
    again = bridge.params_from_jax(back, tcfg, "cpu")
    for li in range(8):
        for k, v in tp["layers"][li]["mixer"].items():
            assert torch.equal(again["layers"][li]["mixer"][k], v), (li, k)
    ssm_tp = tdec.init_params(tget(SSM, smoke=True), 0, "cpu")
    ssm_tree = _numpy(bridge.params_to_jax(ssm_tp, tget(SSM, smoke=True)))
    assert _layout(ssm_tree) == _layout(jdec.abstract_params(jreg.get_config(SSM, smoke=True)))
    assert sorted(ssm_tree["seg0"]["pos0"]["mixer"]) == sorted(
        ["w_in", "conv_w", "conv_b", "a_log", "d_skip", "dt_bias", "norm", "w_out"])


def test_griffin_budgets_of_the_full_configs():
    """GRIFFIN covers the hybrid's 38 GeGLU blocks and nothing of Mamba2."""
    c, tc = jreg.get_config(HYB), tget(HYB)
    ks = jg.plan_k_tree(c, jg.GriffinConfig(sparsity=0.5))
    want = {li: ks[path][inst]
            for li, (path, inst, _) in enumerate(tdec.layer_paths(tc))}
    assert tg.plan_k_tree(tc, tg.GriffinConfig(sparsity=0.5)) == want
    assert sorted(want) == list(range(38)) and set(want.values()) == {6144}
    assert tdec.cache_specs(tget(SSM), 1, 8) and not tget(SSM).has_ffn
    assert not tdec.supports_paged(tc) and not tdec.supports_paged(tget(SSM))


@pytest.mark.parametrize("arch,mode", [(SSM, "full model"), (HYB, "GRIFFIN@50%")])
def test_launcher_serves_recurrent_archs_through_the_slot_batcher(arch, mode, capsys):
    argv = ["--arch", arch, "--device", "cpu", "--requests", "3", "--max-len", "48",
            "--slots", "2"]
    got = serve.main(argv)
    out = capsys.readouterr().out
    assert f"[{mode}] slots: served 3 requests / " in out
    cfg = tget(arch, smoke=True)
    gcfg = tg.GriffinConfig(sparsity=0.5) if cfg.has_ffn else None
    cb = ContinuousBatcher(cfg, tdec.init_params(cfg, 0, "cpu"), n_slots=2,
                           max_len=48, gcfg=gcfg, device="cpu")
    for rid, (prompt, gen) in enumerate(serve.synthetic_requests(cfg, 3, 48)):
        cb.submit(prompt, max_new=gen, rid=rid)
    assert got == cb.run()


@pytest.mark.parametrize("argv,needle", [
    (["--arch", HYB, "--spec-k", "2"], "falls back to the slot batcher"),
    (["--arch", HYB, "--trace-out", "t.json"], "observability"),
    (["--arch", SSM, "--http", "127.0.0.1:0"], "--http requires"),
    (["--arch", SSM, "--tier", "0.5"], "--tier requires GRIFFIN"),
])
def test_launcher_refuses_what_the_reference_refuses(argv, needle, capsys):
    """The slot fallback's refusals, as the reference makes them: no
    speculative rounds, observability flags or HTTP frontend without the
    paged path, and no GRIFFIN option for Mamba2 (it has no FF block)."""
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu"] + argv)
    assert e.value.code == 2
    assert needle in capsys.readouterr().err
