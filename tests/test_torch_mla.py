"""The port's Multi-head Latent Attention on the CPU, held against the JAX
package at fp32.

Parameters are the port's seeded draw of ``mla_specs`` (the smoke
DeepSeek-V3 config: D=64, 4 heads, q rank 32, kv rank 16, nope 16 + rope
8 dims), with the query's low-rank path and without it, handed to the
reference as numpy; activations are drawn with numpy from a seed.

* ``mla_forward`` (expanded form, one query chunk and padded chunks) and
  its compressed cache material within 1e-5 of the reference's;
* ``mla_decode`` (absorbed form) over four steps from a filled cache,
  output and cache within 1e-5 of the reference's;
* within the port, absorbed decode equals the expanded forward at the
  last position (the reference's own bar, ``tests/test_layers.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.models.layers import mla as jmla  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402
from repro_torch.models.layers import mla as tmla  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "deepseek-v3-671b"


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mla():
    """q_lora_rank -> (reference cfg, port cfg, numpy params, torch params)."""
    out = {}
    for qr in (32, 0):
        tcfg = tget(ARCH, smoke=True).replace(q_lora_rank=qr)
        tp = tparam.init_params(tmla.mla_specs(tcfg), 0, "float32", "cpu")
        jp = {k: v.numpy() for k, v in tp.items()}
        out[qr] = (get_config(ARCH, smoke=True).replace(q_lora_rank=qr), tcfg, jp, tp)
    return out


def _rope(cfg, positions):
    return tcommon.rope_cos_sin(positions, cfg.qk_rope_head_dim, cfg.rope_theta)


def _x(seed, shape):
    return (np.random.default_rng(seed).normal(size=shape) * 0.5).astype(np.float32)


@pytest.mark.parametrize("q_chunk", [1024, 4])
@pytest.mark.parametrize("qr", [32, 0])
def test_mla_forward_matches_jax(mla, qr, q_chunk):
    """``q_chunk=4`` over 10 positions: two full chunks and a padded one."""
    cfg, tcfg, jp, tp = mla[qr]
    B, S = 2, 10
    x = _x(0, (B, S, cfg.d_model))
    pos = np.broadcast_to(np.arange(S), (B, S))
    y, (ckv, kr) = jax.jit(functools.partial(jmla.mla_forward, cfg=cfg,
                                             q_chunk=q_chunk))(
        jp, jnp.asarray(x), jnp.asarray(pos))
    tpos = torch.from_numpy(pos.copy())
    ty, (tckv, tkr) = tmla.mla_forward(tp, torch.from_numpy(x), tpos, tcfg,
                                       q_chunk, rope=_rope(tcfg, tpos))
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(tckv.numpy(), np.asarray(ckv), **TOL)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(kr), **TOL)
    # the rope argument is only a precomputation: without it, the same
    ty2, _ = tmla.mla_forward(tp, torch.from_numpy(x), tpos, tcfg, q_chunk)
    assert torch.equal(ty, ty2)


@pytest.mark.parametrize("qr", [32, 0])
def test_mla_decode_matches_jax(mla, qr):
    """Prefill 7 positions, then 4 absorbed decode steps into a cache of
    12 (the port writes its cache in place, the reference returns one)."""
    cfg, tcfg, jp, tp = mla[qr]
    B, P, G, L = 2, 7, 4, 12
    x = _x(1, (B, P + G, cfg.d_model))
    pos = np.broadcast_to(np.arange(P), (B, P))
    _, (ckv, kr) = jax.jit(functools.partial(jmla.mla_forward, cfg=cfg))(
        jp, jnp.asarray(x[:, :P]), jnp.asarray(pos))
    ckv, kr = np.array(ckv), np.array(kr)
    zeros = {k: jnp.zeros(s.shape, jnp.float32)
             for k, s in jmla.mla_cache_specs(cfg, B, L).items()}
    jcache = jmla.mla_fill_cache(zeros, jnp.asarray(ckv), jnp.asarray(kr))
    tcache = tmla.mla_fill_cache(
        {k: torch.zeros(s.shape) for k, s in tmla.mla_cache_specs(tcfg, B, L).items()},
        torch.from_numpy(ckv), torch.from_numpy(kr))
    step = jax.jit(functools.partial(jmla.mla_decode, cfg=cfg))
    for t in range(P, P + G):
        xt = x[:, t : t + 1]
        want, jcache = step(jp, jcache, jnp.asarray(xt), jnp.int32(t))
        rope = _rope(tcfg, torch.full((B, 1), t))
        got, tcache = tmla.mla_decode(tp, tcache, torch.from_numpy(xt), t, tcfg,
                                      rope=rope)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"step {t}", **TOL)
    for k in ("ckv", "kr"):
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]), **TOL)


def test_mla_absorbed_equals_expanded(mla):
    """``tests/test_layers.py::test_mla_absorbed_equals_expanded`` on the
    port: decode at the last position from the cache of the first S-1
    equals the expanded forward's last row."""
    _, tcfg, _, tp = mla[32]
    B, S = 2, 10
    x = torch.from_numpy(_x(9, (B, S, tcfg.d_model)))
    positions = torch.arange(S)[None].expand(B, S)
    y_exp, (ckv, kr) = tmla.mla_forward(tp, x, positions, tcfg)
    cache = {"ckv": torch.zeros(B, S, tcfg.kv_lora_rank),
             "kr": torch.zeros(B, S, tcfg.qk_rope_head_dim)}
    cache = tmla.mla_fill_cache(cache, ckv[:, : S - 1], kr[:, : S - 1])
    y_dec, _ = tmla.mla_decode(tp, cache, x[:, -1:], S - 1, tcfg)
    np.testing.assert_allclose(y_dec[:, 0].numpy(), y_exp[:, -1].numpy(),
                               rtol=2e-4, atol=2e-4)
