"""The port's contiguous generation path on the CPU, held against the JAX
package at fp32.

* ``decoder.forward`` logits (``all`` / ``last`` / hidden states, and
  the teacher-forced pruned model) and its statistics ``s_sq``/``x_sq``/
  ``z_sq``/``z`` are within 1e-5 of the reference's.
* ``decode_step`` after a prefill reproduces the full forward's logits
  within 2e-4 (the reference's own bar, ``tests/test_decode_
  equivalence.py``) for a global cache, a sliding-window ring cache
  decoded past its window, and the int8 cache (distribution-level, as
  the reference); each step is also within 1e-5 of the reference's
  ``decode_step``, and the int8 cache's codes equal the reference's.
* ``decode_step`` equals the port's ``decode_step_paged`` (gather
  backend) within 1e-5.
* ``GenerationEngine.generate`` greedy streams are token-identical to
  the JAX engine's with ``gcfg=None``, GRIFFIN 0.5 ``topk``, ``blocks``
  and the int8 cache.  Parameters: tinylm's ``PRNGKey(0)`` draw with
  the projection matrices scaled by 2 (the unscaled draw repeats a token
  per prompt, which would make stream identity a weak check).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core import griffin as jg  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serving.engine import GenerationEngine as JaxEngine  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import griffin as tg  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.serving.engine import GenerationEngine  # noqa: E402
from repro_torch.serving.steps import build_decode_step, build_prefill_step  # noqa: E402

CFG = get_config("tinylm")
TCFG = tget("tinylm")
TOL = dict(rtol=1e-5, atol=1e-5)
_MATS = ("wq", "wk", "wv", "wo", "w1", "wg", "w2")

#: cache variants: name -> (config overrides, prompt length, new tokens)
CACHES = {
    "global": ({}, 24, 5),
    # sliding window 8 on every other layer, decoded well past the window
    "ring": (dict(attn_pattern=("local", "global"), sliding_window=8), 16, 12),
    "int8": (dict(kv_cache_int8=True), 24, 5),
}


def _scaled(tree, s):
    return {k: _scaled(v, s) if isinstance(v, dict)
            else (v * s if k in _MATS else v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jdec.init_params(CFG, jax.random.PRNGKey(0)))
    js = _scaled(jp, np.float32(2.0))
    return {"plain": (jp, bridge.params_from_jax(jp, TCFG, "cpu")),
            "scaled": (js, bridge.params_from_jax(js, TCFG, "cpu"))}


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, CFG.vocab_size, (2, 29)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def jax_forward(params, tokens):
    """The reference's full forward with every statistic, run once."""
    jp, _ = params["plain"]
    logits, aux = jdec.forward(jp, CFG, jnp.asarray(tokens), collect_stats=True,
                               want_kv=True, want_z=True, remat=False)
    stats = jax.tree.map(np.asarray, jdec.prune_stats_tree(aux.stats, CFG))
    return np.asarray(logits), stats, bridge.tree_from_jax(stats, TCFG, "cpu")


def test_forward_and_stats_match_jax(params, tokens, jax_forward):
    _, tp = params["plain"]
    want_logits, _, want_stats = jax_forward
    logits, aux = tdec.forward(tp, TCFG, torch.from_numpy(tokens),
                               collect_stats=True, want_kv=True, want_z=True,
                               q_chunk=7)  # 29 = 4 full chunks + 1 padded
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    assert sorted(aux.stats) == sorted(want_stats) == list(range(CFG.num_layers))
    for li, st in want_stats.items():
        assert sorted(aux.stats[li]) == sorted(st) == ["s_sq", "x_sq", "z", "z_sq"]
        for k, v in st.items():
            np.testing.assert_allclose(aux.stats[li][k].numpy(), v.numpy(),
                                       err_msg=f"layer {li} {k}", **TOL)
    assert len(aux.kv) == CFG.num_layers
    assert aux.kv[0]["k"].shape == (2, 29, CFG.num_kv_heads, CFG.head_dim)


@pytest.mark.parametrize("mode", ["last", "none", "pruned"])
def test_forward_modes_match_jax(params, tokens, jax_forward, mode):
    """``logits_mode`` last / none, and the teacher-forced generation-phase
    model (``pruned``: GRIFFIN 0.5 from the prompt's statistics)."""
    jp, tp = params["plain"]
    toks_j, toks_t = jnp.asarray(tokens), torch.from_numpy(tokens)
    if mode == "pruned":
        gcfg_j, gcfg_t = jg.GriffinConfig(sparsity=0.5), tg.GriffinConfig(sparsity=0.5)
        _, stats_j, stats_t = jax_forward
        pr_j, _ = jg.select_and_compact(jax.tree.map(jnp.asarray, stats_j),
                                        jdec.extract_ffn_tree(jp, CFG), gcfg_j)
        pr_t, _ = tg.select_and_compact(stats_t, tdec.extract_ffn_tree(tp, TCFG),
                                        gcfg_t)
        want, _ = jdec.forward(jp, CFG, toks_j, remat=False, pruned=pr_j)
        got, _ = tdec.forward(tp, TCFG, toks_t, pruned=pr_t)
    else:
        want, _ = jdec.forward(jp, CFG, toks_j, remat=False, logits_mode=mode)
        got, aux = tdec.forward(tp, TCFG, toks_t, logits_mode=mode)
        assert aux.kv is None and aux.stats is None
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("cache", sorted(CACHES))
def test_decode_matches_forward_and_jax(params, cache):
    over, S, G = CACHES[cache]
    cfg, tcfg = CFG.replace(**over), TCFG.replace(**over)
    jp, tp = params["plain"]
    if cache == "ring":  # a period of two layers: its own reference layout
        jp = jax.tree.map(np.asarray, jdec.init_params(cfg, jax.random.PRNGKey(0)))
        tp = bridge.params_from_jax(jp, tcfg, "cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S + G)) \
        .astype(np.int32)
    ref, _ = tdec.forward(tp, tcfg, torch.from_numpy(toks))
    last, aux = tdec.forward(tp, tcfg, torch.from_numpy(toks[:, :S]),
                             want_kv=True, logits_mode="last")
    np.testing.assert_allclose(last[:, 0].numpy(), ref[:, S - 1].numpy(),
                               rtol=0, atol=2e-4)
    cache_t = tdec.fill_cache_from_prefill(
        tcfg, tdec.init_cache(tcfg, 2, S + G, "cpu"), aux.kv)
    _, aux_j = jdec.forward(jp, cfg, jnp.asarray(toks[:, :S]), want_kv=True,
                            remat=False, logits_mode="last")
    cache_j = jdec.fill_cache_from_prefill(cfg, jdec.init_cache(cfg, 2, S + G),
                                           aux_j.kv)
    if cache == "ring":
        assert cache_t[0]["k"].shape[1] == 8 and cache_t[1]["k"].shape[1] == S + G
    if cache == "int8":  # the same codes and scales as the reference's
        want_cache = bridge.tree_from_jax(jax.tree.map(np.asarray, cache_j), tcfg,
                                          "cpu")
        for got_l, want_l in zip(cache_t, want_cache.values()):
            assert got_l["k"].dtype == torch.int8
            for name in ("k", "v"):
                assert torch.equal(got_l[name], want_l[name])
            for name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(got_l[name], want_l[name], **TOL)
    step_j = jax.jit(lambda c, t, pos: jdec.decode_step(jp, cfg, c, t, pos))
    for t in range(G):
        tok = toks[:, S + t : S + t + 1]
        got, cache_t = tdec.decode_step(tp, tcfg, cache_t, torch.from_numpy(tok),
                                        S + t)
        want, cache_j = step_j(cache_j, jnp.asarray(tok), jnp.int32(S + t))
        got, want = got[:, 0].numpy(), np.array(want[:, 0])
        np.testing.assert_allclose(got, want, err_msg=f"step {t}", **TOL)
        if cache == "int8":
            # the reference's int8 bar: total variation to the fp forward
            p, q = torch.softmax(torch.from_numpy(got), -1), torch.softmax(ref[:, S + t], -1)
            tv = float(0.5 * (p - q).abs().sum(-1).max())
            assert tv < 0.05, (t, tv)
        else:
            np.testing.assert_allclose(got, ref[:, S + t].numpy(), rtol=0,
                                       atol=2e-4, err_msg=f"step {t}")


def test_decode_step_matches_paged(params):
    """The contiguous decode step against the port's paged step (gather
    backend) on the same prompt: prefill through each path's own entry,
    then 4 decode steps."""
    _, tp = params["plain"]
    S, G, page = 13, 4, 8
    toks = np.random.default_rng(2).integers(0, CFG.vocab_size, (2, S + G)) \
        .astype(np.int32)
    _, aux = tdec.forward(tp, TCFG, torch.from_numpy(toks[:, :S]), want_kv=True,
                          logits_mode="last")
    cache = tdec.fill_cache_from_prefill(
        TCFG, tdec.init_cache(TCFG, 2, S + G, "cpu"), aux.kv)
    pools = tdec.init_paged_pools(TCFG, 8, page, device="cpu")
    bt = torch.tensor([[0, 1, 2], [3, 4, 5]], dtype=torch.int32)
    tdec.decode_step_paged(tp, TCFG, pools, bt, torch.from_numpy(toks[:, :S]),
                           torch.zeros(2, dtype=torch.int32))
    for t in range(G):
        tok = torch.from_numpy(toks[:, S + t : S + t + 1])
        got, cache = tdec.decode_step(tp, TCFG, cache, tok, S + t)
        want, pools, _ = tdec.decode_step_paged(
            tp, TCFG, pools, bt, tok, torch.full((2,), S + t, dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


#: engine variants: name -> (config overrides, GRIFFIN config or None)
ENGINES = {
    "dense": ({}, None),
    "topk": ({}, dict(sparsity=0.5)),
    "blocks": ({}, dict(sparsity=0.5, mode="blocks", block_size=128)),
    "int8": (dict(kv_cache_int8=True), dict(sparsity=0.5)),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_greedy_matches_jax(params, name):
    over, g = ENGINES[name]
    cfg, tcfg = CFG.replace(**over), TCFG.replace(**over)
    js, ts = params["scaled"]
    prompts = np.random.default_rng(3).integers(0, CFG.vocab_size, (3, 20)) \
        .astype(np.int32)
    want = JaxEngine(cfg, jax.tree.map(jnp.asarray, js),
                     None if g is None else jg.GriffinConfig(**g),
                     max_len=48).generate(jnp.asarray(prompts), 16)
    eng = GenerationEngine(tcfg, ts, None if g is None else tg.GriffinConfig(**g),
                           max_len=48, device="cpu")
    got = eng.generate(prompts, 16)
    assert got.dtype == torch.int32 and got.shape == (3, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 4  # not degenerate


def test_steps_match_engine(params):
    """``build_prefill_step`` / ``build_decode_step`` give the engine's
    first two tokens."""
    _, ts = params["scaled"]
    prompts = torch.from_numpy(np.random.default_rng(3).integers(
        0, CFG.vocab_size, (3, 20)).astype(np.int32))
    gcfg = tg.GriffinConfig(sparsity=0.5)
    out = build_prefill_step(TCFG, gcfg)(ts, prompts)
    assert sorted(out["pruned"]) == list(range(CFG.num_layers))
    assert out["pruned"][0]["w1"].shape == (CFG.d_model, CFG.d_ff // 2)
    cache = tdec.fill_cache_from_prefill(
        TCFG, tdec.init_cache(TCFG, 3, 48, "cpu"), out["kv"])
    tok = torch.argmax(out["last_logits"], -1)[:, None]
    logits, _ = build_decode_step(TCFG, True)(ts, cache, out["pruned"], tok, 20)
    want = GenerationEngine(TCFG, ts, gcfg, max_len=48, device="cpu") \
        .generate(prompts, 2)
    assert torch.equal(torch.cat([tok, torch.argmax(logits[:, 0], -1)[:, None]], 1)
                       .to(torch.int32), want)


def test_engine_refuses():
    cpu_params = {"embed": {"table": torch.zeros(1)}}
    if torch.cuda.is_available():  # the card by default: CPU params refused
        with pytest.raises(ValueError, match="params live on"):
            GenerationEngine(TCFG, cpu_params)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GenerationEngine(TCFG, cpu_params)
    eng = GenerationEngine(TCFG, tdec.init_params(TCFG, 0, "cpu"), max_len=16,
                           device="cpu")
    with pytest.raises(ValueError, match="max_len"):
        eng.generate(np.zeros((1, 10), np.int32), 7)
