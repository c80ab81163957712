"""The last four model families through the port on the CPU, held
against the JAX package at fp32: Gemma-3-27B (5 local : 1 global layers,
``qk_norm``) and Command-R+ (a GQA group of 12 at full size) through the
paged server, LLaVA-NeXT-34B (a VLM backbone fed precomputed patch
embeddings) and HuBERT-XLarge (a bidirectional LayerNorm/GELU/bias
encoder fed precomputed frame embeddings).

Parameters are the reference's ``init_params(cfg, PRNGKey(0))`` draw of
each smoke config, carried across by ``bridge.params_from_jax``; the
launcher's own seed-0 draw goes the other way (``bridge.params_to_jax``).
Token and embedding inputs come from numpy.

* the four configs, ``ASSIGNED_ARCHS``, ``list_archs()`` and
  ``configs/shapes.py`` are the reference's, field for field, and
  ``cell_supported`` agrees for every (arch, shape);
* the bridge carries the ``frontend`` projection both ways;
* ``decoder.forward`` with ``prefix_emb`` (LLaVA logits, HuBERT hidden
  states) and its statistics (``s_sq``, ``x_sq``, ``z_sq``, ``z``) within
  1e-5 of the reference's (sums over the sequence: atol 1e-4); the
  projection runs before the cast to the model dtype;
* prefill + ``decode_step`` equal the full forward within 2e-4 for
  Gemma-3 (its ring caches wrap) and LLaVA (text-only decode), as the
  reference's ``tests/test_decode_equivalence.py`` asks of it;
* ``decode_step_paged`` over a window of 8 on pages of 4 equals the full
  forward within 2e-4, as ``tests/test_serving_paged.py`` asks of the
  reference;
* ``PagedServer`` streams of Gemma-3 (window 8, page 4) and Command-R+
  (its smoke group of 2, and a group of 12) are the JAX server's, token
  for token, at GRIFFIN 0.5;
* ``build_prefill_step`` with a prefix: last logits, KV and the
  compacted tree within 1e-5 of the reference's, then decode steps on
  the compacted FF;
* HuBERT's flocking analysis (``relative_activations``,
  ``flocking_score``) per layer equals the reference's on the same z;
* ``launch.serve`` serves each of the four where the reference's
  launcher does, with the reference's streams.
"""
import dataclasses

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.core import flocking as jfl  # noqa: E402
from repro.core import griffin as jg  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serving import steps as jsteps  # noqa: E402
from repro.serving.engine import ContinuousBatcher as JaxBatcher  # noqa: E402
from repro.serving.server import PagedServer as JaxServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs import shapes as tshapes  # noqa: E402
from repro_torch.core import flocking as tfl  # noqa: E402
from repro_torch.core import griffin as tg  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.serving import steps as tsteps  # noqa: E402
from repro_torch.serving.server import PagedServer  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SUM_TOL = dict(rtol=1e-5, atol=1e-4)  # sums over every row of a sequence
DECODE_TOL = 2e-4  # the reference's own decode-vs-forward bound
NEW = ("gemma3-27b", "command-r-plus-104b", "llava-next-34b", "hubert-xlarge")
_MATS = ("wq", "wk", "wv", "wo", "w1", "wg", "w2")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return tree.numpy()


def _scaled(tree, s):
    """Projection matrices times ``s``: at the init's scale the smoke
    models' greedy streams repeat a token or two, a weak check."""
    return {k: _scaled(v, s) if isinstance(v, dict)
            else (v * s if k in _MATS else v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def models():
    """arch -> (reference cfg, port cfg, numpy params, torch params):
    the reference's PRNGKey(0) draw of the smoke config, bridged."""
    out = {}
    for arch in NEW:
        cfg, tcfg = jreg.get_config(arch, smoke=True), treg.get_config(arch, smoke=True)
        jp = jax.tree.map(np.asarray, jdec.init_params(cfg, jax.random.PRNGKey(0)))
        if arch in ("gemma3-27b", "command-r-plus-104b"):
            jp = _scaled(jp, np.float32(2.0))
        out[arch] = (cfg, tcfg, jp, bridge.params_from_jax(jp, tcfg, "cpu"))
    return out


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_config_is_the_references(arch):
    for smoke in (False, True):
        assert dataclasses.asdict(treg.get_config(arch, smoke=smoke)) == \
            dataclasses.asdict(jreg.get_config(arch, smoke=smoke))
    assert treg.list_archs() == jreg.list_archs()
    assert treg.ASSIGNED_ARCHS == jreg.ASSIGNED_ARCHS


def test_shapes_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in tshapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    for arch in jreg.list_archs():
        cfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
        for name, shape in jshapes.SHAPES.items():
            assert tshapes.cell_supported(tcfg, tshapes.SHAPES[name]) == \
                jshapes.cell_supported(cfg, shape), (arch, name)
            assert dataclasses.asdict(tshapes.smoke_shape(tshapes.SHAPES[name])) \
                == dataclasses.asdict(jshapes.smoke_shape(shape))


@pytest.mark.parametrize("arch", ("llava-next-34b", "hubert-xlarge"))
def test_bridge_carries_the_frontend(models, arch):
    cfg, tcfg, jp, tp = models[arch]
    D = cfg.d_model
    assert tp["frontend"]["proj"].shape == (D, D)
    np.testing.assert_array_equal(tp["frontend"]["proj"].numpy(),
                                  jp["frontend"]["proj"])
    back = _numpy(bridge.params_to_jax(tp, tcfg))
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [p for p, _ in flat_b] == [p for p, _ in flat_w]
    for (p, got), (_, want) in zip(flat_b, flat_w):
        np.testing.assert_array_equal(got, want, err_msg=str(p))
    # the port's own draw has the reference's layout, frontend included
    own = jax.tree_util.tree_structure(
        _numpy(bridge.params_to_jax(tdec.init_params(tcfg, 0, "cpu"), tcfg)))
    assert own == jax.tree_util.tree_structure(jp)


# ---------------------------------------------------------------------------
# forward with a prefix, and the projection's order
# ---------------------------------------------------------------------------

def _prefix_inputs(cfg, arch, B=2):
    rng = np.random.default_rng(7)
    if arch == "hubert-xlarge":  # frames only
        return None, rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, 6)).astype(np.int32)
    pre = rng.standard_normal((B, cfg.num_prefix_embeddings, cfg.d_model))
    return toks, pre.astype(np.float32)


@pytest.mark.parametrize("arch", ("llava-next-34b", "hubert-xlarge"))
def test_forward_with_prefix_matches_jax(models, arch):
    cfg, tcfg, jp, tp = models[arch]
    toks, pre = _prefix_inputs(cfg, arch)
    mode = "none" if arch == "hubert-xlarge" else "all"
    want, jaux = jdec.forward(
        _j(jp), cfg, None if toks is None else jnp.asarray(toks), jnp.asarray(pre),
        collect_stats=True, want_z=True, remat=False, logits_mode=mode)
    got, aux = tdec.forward(
        tp, tcfg, None if toks is None else torch.from_numpy(toks),
        torch.from_numpy(pre), collect_stats=True, want_z=True, logits_mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    jst = bridge.tree_from_jax(jax.tree.map(np.asarray, jaux.stats), tcfg, "cpu")
    assert sorted(aux.stats) == sorted(jst) == list(range(cfg.num_layers))
    S = pre.shape[1] + (0 if toks is None else toks.shape[1])
    for li, st in aux.stats.items():
        assert st["z"].shape == (2, S, cfg.d_ff)
        np.testing.assert_allclose(st["z"].numpy(), jst[li]["z"].numpy(), **TOL)
        for k in ("s_sq", "x_sq", "z_sq"):
            np.testing.assert_allclose(st[k].numpy(), jst[li][k].numpy(),
                                       **SUM_TOL, err_msg=f"{li} {k}")


def test_prefix_projected_before_the_cast(models):
    """A bf16 LLaVA: the prefix is projected in fp32 (the type of the
    embeddings, as ``jnp.einsum`` promotes) and then rounded, as the
    reference's forward does; rounding first gives other hidden states."""
    cfg, tcfg, jp, tp = models["llava-next-34b"]
    bcfg = tcfg.replace(dtype="bfloat16")
    bp = {k: v for k, v in tdec.init_params(bcfg, 0, "cpu").items()}
    _, pre = _prefix_inputs(cfg, "llava-next-34b", B=1)
    pre = torch.from_numpy(pre)
    w = bp.pop("frontend")["proj"]
    got, _ = tdec.forward({**bp, "frontend": {"proj": w}}, bcfg, None, pre,
                          logits_mode="none")
    then_cast, _ = tdec.forward(bp, bcfg, None, (pre @ w.float()).bfloat16(),
                                logits_mode="none")
    cast_first, _ = tdec.forward(bp, bcfg, None, pre.bfloat16() @ w,
                                 logits_mode="none")
    assert torch.equal(got, then_cast)
    assert not torch.equal(got, cast_first)


# ---------------------------------------------------------------------------
# decode == forward (contiguous and paged)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ("gemma3-27b", "llava-next-34b"))
def test_decode_matches_forward(models, arch):
    cfg, tcfg, jp, tp = models[arch]
    B, S, G = 2, 32, 5  # Gemma-3's smoke window is 16: its rings wrap
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + G))
    toks = toks.astype(np.int32)
    want, _ = jdec.forward(_j(jp), cfg, jnp.asarray(toks), remat=False)
    want = np.asarray(want)
    full, _ = tdec.forward(tp, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(full.numpy(), want, **TOL)
    last, aux = tdec.forward(tp, tcfg, torch.from_numpy(toks[:, :S]), want_kv=True,
                             logits_mode="last")
    assert np.abs(last[:, 0].numpy() - want[:, S - 1]).max() < DECODE_TOL
    cache = tdec.fill_cache_from_prefill(
        tcfg, tdec.init_cache(tcfg, B, S + G, "cpu"), aux.kv)
    for t in range(G):
        step, cache = tdec.decode_step(
            tp, tcfg, cache, torch.from_numpy(toks[:, S + t:S + t + 1]), S + t)
        err = np.abs(step[:, 0].numpy() - want[:, S + t]).max()
        assert err < DECODE_TOL, (arch, t, err)


def test_paged_decode_local_window(models):
    """Gemma-3 with a window of 8 over pages of 4: a prefill in chunks of
    8, then decode steps past the window, equal the full forward."""
    cfg, tcfg, jp, tp = models["gemma3-27b"]
    cfg, tcfg = cfg.replace(sliding_window=8), tcfg.replace(sliding_window=8)
    assert tdec.supports_paged(tcfg)
    S, G, page, W, chunk = 16, 10, 4, 8, 8
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, S + G))
    toks = toks.astype(np.int32)
    want, _ = jdec.forward(_j(jp), cfg, jnp.asarray(toks), remat=False)
    want = np.asarray(want)
    pools = tdec.init_paged_pools(tcfg, 16, page, device="cpu")
    bt = np.full((1, W), -1, np.int32)
    need = -(-S // page)
    bt[0, :need] = np.arange(need)
    for c in range(0, S, chunk):
        logits, pools, _ = tdec.decode_step_paged(
            tp, tcfg, pools, torch.from_numpy(bt),
            torch.from_numpy(toks[:, c:c + chunk]), torch.tensor([c], dtype=torch.int32))
        assert np.abs(logits[0].numpy() - want[0, c:c + chunk]).max() < DECODE_TOL
    for t in range(G):
        pos = S + t
        if -(-(pos + 1) // page) > need:
            bt[0, need] = need
            need += 1
        logits, pools, _ = tdec.decode_step_paged(
            tp, tcfg, pools, torch.from_numpy(bt),
            torch.from_numpy(toks[:, pos:pos + 1]), torch.tensor([pos], dtype=torch.int32))
        err = np.abs(logits[0, 0].numpy() - want[0, pos]).max()
        assert err < DECODE_TOL, (t, err)


# ---------------------------------------------------------------------------
# PagedServer streams
# ---------------------------------------------------------------------------

SERVER_KW = dict(page_size=4, num_pages=64, n_slots=2, prefill_chunk=8, max_len=64)


@pytest.mark.parametrize("arch,over", [
    ("gemma3-27b", dict(sliding_window=8)),
    ("command-r-plus-104b", {}),
    ("command-r-plus-104b", dict(num_heads=12, num_kv_heads=1)),  # group 12
])
def test_paged_server_streams_match_jax(models, arch, over):
    cfg, tcfg, jp, tp = models[arch]
    cfg, tcfg = cfg.replace(**over), tcfg.replace(**over)
    if "num_heads" in over:  # another attention shape: a draw of its own
        jp = _scaled(jax.tree.map(np.asarray, jdec.init_params(
            cfg, jax.random.PRNGKey(1))), np.float32(2.0))
        tp = bridge.params_from_jax(jp, tcfg, "cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (11, 25, 18)]
    out = []
    for srv in (JaxServer(cfg, _j(jp), jg.GriffinConfig(sparsity=0.5), **SERVER_KW),
                PagedServer(tcfg, tp, tg.GriffinConfig(sparsity=0.5), device="cpu",
                            **SERVER_KW)):
        for rid, p in enumerate(prompts):
            srv.submit(p, 8, rid=rid)
        out.append({r: list(t) for r, t in srv.drain().items()})
    assert out[1] == out[0]
    assert len({t for s in out[0].values() for t in s}) > 6  # not degenerate


def test_one_slot_server_holds_one_compacted_copy(models):
    """With one slot the decode batch reads the request's own compacted
    tree: no second copy, and the streams are the two-slot server's.
    Once every request has finished, no slot buffer is left either."""
    cfg, tcfg, jp, tp = models["command-r-plus-104b"]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (13, 9)]
    out = []
    for n_slots in (1, 2):
        srv = PagedServer(tcfg, tp, tg.GriffinConfig(sparsity=0.5), device="cpu",
                          **{**SERVER_KW, "n_slots": n_slots})
        srv.submit(prompts[0], 6, rid=0)
        while not srv.pruned_slots:
            srv.step()
        if n_slots == 1:
            req = srv._compacted[0]
            assert all(srv.pruned_slots[li][k].data_ptr() == v.data_ptr()
                       for li, ffn in req.pruned_host.items() for k, v in ffn.items())
        srv.submit(prompts[1], 6, rid=1)
        out.append({r: list(t) for r, t in srv.drain().items()})
        assert srv.pruned_slots is None and not srv._compacted
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# build_prefill_step with a prefix (the VLM cells' prefill)
# ---------------------------------------------------------------------------

def test_prefill_step_with_prefix_matches_jax(models):
    cfg, tcfg, jp, tp = models["llava-next-34b"]
    toks, pre = _prefix_inputs(cfg, "llava-next-34b")
    B, G = toks.shape[0], 4
    S = pre.shape[1] + toks.shape[1]
    gj = jg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    gt = tg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    want = jsteps.build_prefill_step(cfg, gj)(_j(jp), jnp.asarray(toks), jnp.asarray(pre))
    got = tsteps.build_prefill_step(tcfg, gt)(tp, torch.from_numpy(toks),
                                              torch.from_numpy(pre))
    np.testing.assert_allclose(got["last_logits"].numpy(),
                               np.asarray(want["last_logits"]), **TOL)
    for name, tree in (("kv", "kv"), ("pruned", "pruned")):
        wt = bridge.tree_from_jax(jax.tree.map(np.asarray, want[tree]), tcfg, "cpu")
        gt_ = dict(enumerate(got[tree])) if name == "kv" else got[tree]
        assert sorted(gt_) == sorted(wt), name
        for li in wt:
            assert sorted(gt_[li]) == sorted(wt[li]), (name, li)
            for k in wt[li]:
                np.testing.assert_allclose(gt_[li][k].numpy(), wt[li][k].numpy(),
                                           **TOL, err_msg=f"{name} {li} {k}")
    # the compacted FF keeps half the columns of every layer
    assert {v["w1"].shape[1] for v in got["pruned"].values()} == {cfg.d_ff // 2}
    # text-only decode on the compacted FF from the prefix's caches
    jcache = jdec.fill_cache_from_prefill(cfg, jdec.init_cache(cfg, B, S + G),
                                          want["kv"])
    tcache = tdec.fill_cache_from_prefill(
        tcfg, tdec.init_cache(tcfg, B, S + G, "cpu"), got["kv"])
    jstep = jsteps.build_decode_step(cfg, True)
    tstep = tsteps.build_decode_step(tcfg, True)
    tok = np.asarray(jnp.argmax(want["last_logits"], -1))[:, None].astype(np.int32)
    for t in range(G):
        lj, jcache = jstep(_j(jp), jcache, want["pruned"], jnp.asarray(tok), S + t)
        lt, tcache = tstep(tp, tcache, got["pruned"], torch.from_numpy(tok), S + t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tok = np.asarray(jnp.argmax(lj[:, 0], -1))[:, None].astype(np.int32)


# ---------------------------------------------------------------------------
# HuBERT: the encoder's flocking analysis
# ---------------------------------------------------------------------------

def test_encoder_flocking_matches_jax(models):
    cfg, tcfg, jp, tp = models["hubert-xlarge"]
    assert not tcfg.griffin and not tdec.supports_paged(tcfg)
    _, frames = _prefix_inputs(cfg, "hubert-xlarge")
    _, jaux = jdec.forward(_j(jp), cfg, None, jnp.asarray(frames), collect_stats=True,
                           want_z=True, remat=False, logits_mode="none")
    _, aux = tdec.forward(tp, tcfg, None, torch.from_numpy(frames), collect_stats=True,
                          want_z=True, logits_mode="none")
    jz = bridge.tree_from_jax(jax.tree.map(np.asarray, jaux.stats), tcfg, "cpu")
    for li, st in aux.stats.items():
        z, zj = st["z"], jnp.asarray(jz[li]["z"].numpy())
        np.testing.assert_allclose(tfl.relative_activations(z).numpy(),
                                   np.asarray(jfl.relative_activations(zj)), **TOL)
        for b in range(z.shape[0]):
            got, want = tfl.flocking_score(z[b]), jfl.flocking_score(zj[b])
            assert np.isfinite(got) and abs(got - want) < 1e-6, (li, b, got, want)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,line", [
    ("gemma3-27b", "[GRIFFIN@50%] paged: served 2 requests"),
    ("command-r-plus-104b", "[GRIFFIN@50%] paged: served 2 requests"),
    ("llava-next-34b", "[GRIFFIN@50%] slots: served 2 requests"),
    ("hubert-xlarge", "[full model] slots: served 2 requests"),
])
def test_launcher_streams_match_jax(arch, line, capsys):
    """Each arch goes where the reference's launcher sends it (the paged
    server, or the slot batcher), at the launcher's defaults, and serves
    the reference's streams on the same weights."""
    got = serve.main(["--arch", arch, "--device", "cpu", "--requests", "2",
                      "--max-len", "64"])
    assert line in capsys.readouterr().out
    cfg, tcfg = jreg.get_config(arch, smoke=True), treg.get_config(arch, smoke=True)
    params = _j(_numpy(bridge.params_to_jax(tdec.init_params(tcfg, 0, "cpu"), tcfg)))
    gcfg = jg.GriffinConfig(sparsity=0.5) if cfg.griffin else None
    if jdec.supports_paged(cfg):
        srv = JaxServer(cfg, params, gcfg, page_size=16, num_pages=64, n_slots=4,
                        prefill_chunk=32, max_len=64)
    else:
        srv = JaxBatcher(cfg, params, n_slots=4, max_len=64, gcfg=gcfg)
    for rid, (prompt, gen) in enumerate(serve.synthetic_requests(tcfg, 2, 64)):
        srv.submit(prompt, max_new=gen, rid=rid)
    want = srv.drain() if jdec.supports_paged(cfg) else srv.run()
    assert {r: list(t) for r, t in got.items()} == {r: list(t) for r, t in want.items()}
