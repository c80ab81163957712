"""The port's layers on the CPU, held against the JAX package at fp32.

Tinylm parameters from ``PRNGKey(0)`` are carried to the port bit for
bit (``repro_torch.bridge``); activations and KV pools are made with
numpy from a seed and handed to both.  Tolerance 1e-5: the same fp32
math with sums taken in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.models.layers import ffn as jffn  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402
from repro_torch.models.layers import ffn as tffn  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("tinylm")
    jp = jax.tree.map(np.asarray, jdec.init_params(cfg, jax.random.PRNGKey(0)))
    tp = bridge.params_from_jax(jp, tget("tinylm"), "cpu")
    return cfg, jp, tp


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_bridge_is_bit_exact(tiny):
    cfg, jp, tp = tiny
    # layer 1 of the scan-stacked seg0/pos0 leaf
    np.testing.assert_array_equal(_np(tp["layers"][1]["ffn"]["w1"]),
                                  jp["seg0"]["pos0"]["ffn"]["w1"][1])
    np.testing.assert_array_equal(_np(tp["embed"]["table"]),
                                  jp["embed"]["table"])
    assert len(tp["layers"]) == cfg.num_layers


def test_common_blocks_match_jax(tiny):
    cfg, jp, tp = tiny
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    scale = {"scale": jp["final_norm"]["scale"]}
    np.testing.assert_allclose(
        _np(tcommon.apply_norm({"scale": tp["final_norm"]["scale"]},
                               torch.from_numpy(x), cfg)),
        np.asarray(jcommon.apply_norm(scale, jnp.asarray(x), cfg)), **TOL)
    for act in ("swiglu", "geglu", "reglu", "gelu"):
        np.testing.assert_allclose(
            _np(tcommon.activation_fn(act)(torch.from_numpy(x))),
            np.asarray(jcommon.activation_fn(act)(jnp.asarray(x))), **TOL)
    qh = rng.normal(size=(2, 5, 3, 32)).astype(np.float32)
    positions = rng.integers(0, 500, size=(2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        _np(tcommon.apply_rope(torch.from_numpy(qh), torch.from_numpy(positions),
                               cfg.rope_theta)),
        np.asarray(jcommon.apply_rope(jnp.asarray(qh), jnp.asarray(positions),
                                      cfg.rope_theta)), rtol=1e-5, atol=2e-5)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 5)).astype(np.int32)
    e_t = tcommon.embed_lookup(tp["embed"], torch.from_numpy(toks), cfg)
    e_j = jcommon.embed_lookup(jp["embed"], jnp.asarray(toks), cfg)
    np.testing.assert_array_equal(_np(e_t), np.asarray(e_j))
    np.testing.assert_allclose(
        _np(tcommon.lm_logits({}, tp["embed"], torch.from_numpy(x), cfg)),
        np.asarray(jcommon.lm_logits({}, jp["embed"], jnp.asarray(x), cfg)),
        **TOL)


def test_ffn_matches_jax(tiny):
    cfg, jp, tp = tiny
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32)
    fj = {k: v[2] for k, v in jp["seg0"]["pos0"]["ffn"].items()}
    ft = tp["layers"][2]["ffn"]
    z_t = tffn.ffn_activations(ft, torch.from_numpy(x), cfg)
    z_j = jffn.ffn_activations(fj, jnp.asarray(x), cfg)
    np.testing.assert_allclose(_np(z_t), np.asarray(z_j), **TOL)
    zm = np.asarray(z_j).copy()
    zm[1, 4:] = 0.0  # padded rows
    np.testing.assert_allclose(
        _np(tffn.griffin_stat_sq(torch.from_numpy(zm))),
        np.asarray(jffn.griffin_stat_sq(jnp.asarray(zm))), **TOL)
    # per-slot compacted FF: two slots with their own expert sets
    idx = [np.sort(rng.choice(cfg.d_ff, 200, replace=False)) for _ in range(2)]
    slots_j = [jffn.compact_ffn_params(fj, jnp.asarray(i)) for i in idx]
    slots_t = [tffn.compact_ffn_params(ft, torch.from_numpy(i)) for i in idx]
    for a, b in zip(slots_t, slots_j):
        for k in b:
            np.testing.assert_array_equal(_np(a[k]), np.asarray(b[k]))
    per_j = {k: jnp.stack([s[k] for s in slots_j]) for k in slots_j[0]}
    per_t = {k: torch.stack([s[k] for s in slots_t]) for k in slots_t[0]}
    np.testing.assert_allclose(
        _np(tffn.ffn_forward_perslot(per_t, torch.from_numpy(x), cfg)),
        np.asarray(jffn.ffn_forward_perslot(per_j, jnp.asarray(x), cfg)), **TOL)
    # zero-padding the expert axis is inert
    pad_t = tffn.pad_compacted(per_t, 256)
    pad_j = jffn.pad_compacted(per_j, 256)
    for k in pad_j:
        np.testing.assert_array_equal(_np(pad_t[k]), np.asarray(pad_j[k]))


@pytest.mark.parametrize("backend", ["gather", "fused"])
@pytest.mark.parametrize("S", [1, 5])
def test_paged_attn_step_matches_jax(tiny, backend, S):
    cfg, jp, tp = tiny
    rng = np.random.default_rng(10 + S)
    B, page, W, P = 3, 8, 6, 14
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    pool = {n: rng.normal(size=(P + 1, page, KV, hd)).astype(np.float32)
            for n in ("k", "v")}
    bt = np.full((B, W), -1, np.int32)
    bt[0, :3] = [4, 9, 1]
    bt[1, :2] = [7, 2]
    pos = np.array([17, 9 - S + 4, 0], np.int32)
    wm = np.ones((B, S), bool)
    wm[2] = False  # inactive slot
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    mj = {k: v[1] for k, v in jp["seg0"]["pos0"]["mixer"].items()}
    y_j, pool_j = jattn.paged_attn_step(
        mj, {n: jnp.asarray(v) for n, v in pool.items()}, jnp.asarray(bt),
        jnp.asarray(x), jnp.asarray(pos), jnp.asarray(wm), cfg,
        backend=backend)
    pool_t = {n: torch.from_numpy(v.copy()) for n, v in pool.items()}
    y_t, pool_t = tattn.paged_attn_step(
        tp["layers"][1]["mixer"], pool_t, torch.from_numpy(bt),
        torch.from_numpy(x), torch.from_numpy(pos), torch.from_numpy(wm), cfg,
        backend=backend)
    np.testing.assert_allclose(_np(y_t)[:2], np.asarray(y_j)[:2], **TOL)
    # the new rows come out of the projections (fp32 sums in another
    # order), so written slots agree to 1e-5; every other page is as given
    for n in ("k", "v"):
        np.testing.assert_allclose(_np(pool_t[n])[:-1],
                                   np.asarray(pool_j[n])[:-1], **TOL)
        untouched = [p for p in range(P) if p not in bt[:2]]
        np.testing.assert_array_equal(_np(pool_t[n])[untouched],
                                      pool[n][untouched])


def test_resolve_attn_backend():
    assert tattn.resolve_attn_backend("auto", "cpu") == "gather"
    assert tattn.resolve_attn_backend("auto", "cuda") == "fused"
    assert tattn.resolve_attn_backend("fused", "cpu") == "fused"
    with pytest.raises(ValueError):
        tattn.resolve_attn_backend("pallas", "cpu")
