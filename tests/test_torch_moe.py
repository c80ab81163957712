"""The port's MoE block on the CPU, held against the JAX package at fp32.

Parameters are the port's seeded draw of ``moe_specs`` (the smoke
Moonshot-v1-16B-A3B and DeepSeek-V3 configs: D=64, 8 experts top-2, one
shared expert of 32), handed to the reference as numpy; activations are
drawn with numpy from a seed.  Tolerance 1e-5: the same fp32 math
with sums taken in another order.

* ``moe_forward``: output, load-balance loss and the shared expert's
  statistics, in one dispatch and in two chunks of ``chunk_tokens``;
* ``moe_decode`` with the shared expert compacted (and without);
* routing ties go to the lower expert id, as ``jax.lax.top_k`` sends
  them, and the tokens an expert's capacity drops are the reference's;
* the capacity-drop and top-1 cases of the reference's own layer tests
  (``tests/test_layers.py``).
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.models import param as jparam  # noqa: E402
from repro.models.layers import ffn as jffn  # noqa: E402
from repro.models.layers import moe as jmoe  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402
from repro_torch.models.layers import ffn as tffn  # noqa: E402
from repro_torch.models.layers import moe as tmoe  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ARCHS = ("moonshot-v1-16b-a3b", "deepseek-v3-671b")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def blocks():
    """arch -> (reference cfg, port cfg, numpy params, torch params)."""
    out = {}
    for arch in ARCHS:
        tcfg = tget(arch, smoke=True)
        tp = tparam.init_params(tmoe.moe_specs(tcfg), 0, "float32", "cpu")
        jp = jax.tree.map(lambda v: v.numpy(), tp)
        out[arch] = (get_config(arch, smoke=True), tcfg, jp, tp)
    return out


def _jax_forward(jp, x, cfg, **kw):
    """The reference's ``moe_forward``, jitted (one compile instead of
    one per eager op)."""
    f = jax.jit(functools.partial(jmoe.moe_forward, cfg=cfg, **kw))
    return f(jp, jnp.asarray(x))


def _x(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


@pytest.mark.parametrize("chunk", [16_384, 13])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(blocks, arch, chunk):
    """Output, aux loss and shared-expert statistics; ``chunk=13`` cuts
    the 26 tokens into two dispatches, each with its own capacity."""
    cfg, tcfg, jp, tp = blocks[arch]
    x = _x(0, (2, 13, cfg.d_model))
    y, aux, st = _jax_forward(jp, x, cfg, chunk_tokens=chunk,
                              collect_stats=True, want_z=True)
    ty, taux, tst = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg,
                                     chunk_tokens=chunk, collect_stats=True,
                                     want_z=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), **TOL)
    np.testing.assert_allclose(float(taux), float(aux), **TOL)
    assert sorted(tst) == sorted(st) == ["s_sq", "x_sq", "z", "z_sq"]
    assert tst["s_sq"].shape == (2, cfg.moe_d_ff * cfg.num_shared_experts)
    for k in st:
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(st[k]),
                                   err_msg=k, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_matches_jax(blocks, arch):
    """Routed experts plus the shared expert compacted to half its
    neurons, and plus the full shared expert."""
    cfg, tcfg, jp, tp = blocks[arch]
    x = _x(1, (3, 1, cfg.d_model))
    Fs = cfg.moe_d_ff * cfg.num_shared_experts
    idx = np.sort(np.random.default_rng(2).permutation(Fs)[: Fs // 2])
    jpr = jffn.compact_ffn_params(jax.tree.map(jnp.asarray, jp["shared"]),
                                  jnp.asarray(idx))
    tpr = tffn.compact_ffn_params(tp["shared"], torch.from_numpy(idx))
    dec = jax.jit(functools.partial(jmoe.moe_decode, cfg=cfg))
    for jpruned, tpruned in ((jpr, tpr), (None, None)):
        want = dec(jp, jpruned, jnp.asarray(x))
        got = tmoe.moe_decode(tp, tpruned, torch.from_numpy(x), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_routing_ties_and_drops_match_jax(blocks):
    """A zero router ties every expert: both packages route every token to
    experts 0 and 1 (the lower ids), whose capacity then drops the same
    tokens."""
    cfg, tcfg, jp, tp = blocks[ARCHS[0]]
    cfg, tcfg = (c.replace(num_shared_experts=0) for c in (cfg, tcfg))
    jp = {k: v for k, v in jp.items() if k != "shared"}
    jp["router"] = np.zeros_like(jp["router"])
    tp = _torch(jp)
    x = _x(3, (2, 16, cfg.d_model))
    gate, idx, _ = tmoe._route(tp, torch.from_numpy(x.reshape(32, -1)), tcfg)
    assert (idx == torch.tensor([0, 1])).all() and (gate == 0.5).all()
    want, _, _ = _jax_forward(jp, x, cfg)
    got, _, _ = tmoe.moe_forward(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # capacity 16 of the 32 tokens: rows 16.. get nothing from either expert
    C = tmoe._capacity(32, tcfg)
    flat = got.reshape(32, -1)
    assert C == 16 and bool((flat[C:] == 0).all()) and bool((flat[:C] != 0).any())


def test_moe_capacity_drops_tokens(blocks):
    """``tests/test_layers.py::test_moe_capacity_drops_tokens`` on the
    port: with capacity_factor ~0 the buffers saturate and outputs
    shrink toward zero — and the dropped tokens are the reference's."""
    cfg, tcfg, jp, _ = blocks[ARCHS[0]]
    jp = {k: v for k, v in jp.items() if k != "shared"}
    tp = _torch(jp)
    x = _x(4, (2, 16, cfg.d_model), 1.0)
    ys = {}
    for cf in (0.01, 8.0):
        c, tc = (k.replace(capacity_factor=cf, num_shared_experts=0)
                 for k in (cfg, tcfg))
        want, _, _ = _jax_forward(jp, x, c)
        ys[cf], _, _ = tmoe.moe_forward(tp, torch.from_numpy(x), tc)
        np.testing.assert_allclose(ys[cf].numpy(), np.asarray(want), **TOL)
    assert float(ys[0.01].abs().mean()) < float(ys[8.0].abs().mean())


def test_moe_top1_equals_dense_expert(blocks):
    """``tests/test_layers.py::test_moe_top1_equals_dense_expert`` on the
    port: with k=1 and ample capacity, each token's output is its
    expert's dense GLU FF output."""
    _, tcfg, jp, _ = blocks[ARCHS[0]]
    tcfg = tcfg.replace(experts_per_token=1, capacity_factor=16.0,
                        num_shared_experts=0)
    tp = _torch({k: v for k, v in jp.items() if k != "shared"})
    x = torch.from_numpy(_x(5, (2, 9, tcfg.d_model), 0.3))
    y, _, _ = tmoe.moe_forward(tp, x, tcfg)
    xt = x.reshape(-1, tcfg.d_model)
    eid = torch.argmax(xt @ tp["router"], -1)
    for t in range(xt.shape[0]):
        e = int(eid[t])
        z = torch.nn.functional.silu(xt[t] @ tp["wg"][e]) * (xt[t] @ tp["w1"][e])
        np.testing.assert_allclose(y.reshape(-1, tcfg.d_model)[t].numpy(),
                                   (z @ tp["w2"][e]).numpy(), rtol=2e-4, atol=2e-4)


def test_router_keeps_fp32_in_a_bf16_model():
    """The router's spec names fp32: ``init_params`` of a bf16 model
    draws it in fp32 and every other leaf in bf16, as the reference."""
    cfg = tget(ARCHS[0], smoke=True)
    p = tparam.init_params(tmoe.moe_specs(cfg), 0, "bfloat16", "cpu")
    assert p["router"].dtype == torch.float32
    assert {v.dtype for k, v in p.items() if k not in ("router", "shared")} \
        == {torch.bfloat16}
    assert p["shared"]["w1"].dtype == torch.bfloat16
    ref = jparam.abstract_params(jmoe.moe_specs(get_config(ARCHS[0], smoke=True)),
                                 "bfloat16")
    assert str(ref["router"].dtype) == "float32"
