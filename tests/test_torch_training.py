"""The port's schedules and optimizers (``repro_torch.training``) held
against the JAX package's on the CPU.

* every schedule at steps 0-600: equal within rtol 1e-6 (fp32 ``cos`` /
  ``sqrt`` may differ by an ulp from XLA's);
* one update and 20 updates of each optimizer on a small tree (a leaf
  whose last dim 256 divides, one it does not, a 1-D leaf, a bf16 leaf,
  and two stacked leaves given to the port as lists of per-layer
  tensors, as ``bridge.ref_view`` gives them), gradients from a numpy
  seed with a global norm above 1 so that ``clip_by_global_norm`` acts:
  parameters and fp32 state within rtol 1e-5 / atol 1e-7 after one
  update and rtol 1e-4 / atol 1e-6 after 20; 8-bit Adam's int8 codes
  equal except a few that differ by one, where the reference's division
  lands within an ulp of a .5 boundary (none after one update, 5 codes
  over 20), and the elements they touch within ``FLIP_ATOL``;
* ``clip_by_global_norm`` itself, bf16 leaf included;
* the quadratic convergence cases of ``tests/test_optimizers.py``.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.training import optimizer as jopt  # noqa: E402
from repro.training import schedule as jsched  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import schedule as tsched  # noqa: E402

SCHEDULES = [
    ("constant", (3e-3,)),
    ("warmup_cosine", (3e-3, 25, 500)),
    ("warmup_cosine", (1.0, 10, 110, 0.2)),
    ("warmup_rsqrt", (1.0, 100)),
    ("warmup_rsqrt", (2e-3, 0)),
]


@pytest.mark.parametrize("name,args", SCHEDULES)
def test_schedule_matches_jax(name, args):
    steps = np.arange(601, dtype=np.int32)
    want = np.asarray(jax.jit(getattr(jsched, name)(*args))(jnp.asarray(steps)))
    got = getattr(tsched, name)(*args)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np.broadcast_to(got.numpy(), want.shape), want,
                               rtol=1e-6, atol=0)


# leaf -> (shape, dtype, stacked layers or 0)
LEAVES = {
    "blocks": ((8, 512), np.float32, 0),     # 256 divides the last dim
    "whole": ((3, 300), np.float32, 0),      # one block per row
    "vec": ((40,), np.float32, 0),
    "half": ((4, 256), ml_dtypes.bfloat16, 0),
    "stack2": ((16, 256), np.float32, 3),    # [3, 16, 256] in the reference
    "stack1": ((64,), np.float32, 3),        # [3, 64]: factored across layers
}


def _draw(rng, shape, dtype, scale):
    return (rng.normal(size=shape) * scale).astype(np.float32).astype(dtype)


def _trees(seed, scale):
    """(reference numpy tree, port tree with per-layer lists)."""
    rng = np.random.default_rng(seed)
    ref, port = {}, {}
    for k, (shape, dt, n) in LEAVES.items():
        full = (n,) + shape if n else shape
        a = _draw(rng, full, dt, scale)
        ref[k] = a
        port[k] = [_torch(x) for x in a] if n else _torch(a)
    return ref, port


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    if isinstance(t, list):
        return np.stack([_np(x) for x in t])
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


#: 8-bit Adam after a flipped moment code (lr 3e-2: 20 updates of lr / 127)
FLIP_ATOL = 5e-3

OPTIMIZERS = [
    ("adamw", dict(lr=tsched.warmup_cosine(3e-2, 5, 30)), jsched.warmup_cosine(3e-2, 5, 30)),
    ("adam8bit", dict(lr=3e-2), None),
    ("adafactor", dict(lr=1e-2, weight_decay=0.01), None),
    ("sgdm", dict(lr=0.05), None),
    ("sgdm", dict(lr=0.05, grad_clip=1.0), None),
]


def _run(name, kw, jlr, n_steps):
    jkw = dict(kw, lr=jlr) if jlr is not None else kw
    jo = getattr(jopt, name)(**jkw)
    to = getattr(topt, name)(**kw)
    jp, tp = _trees(0, 1.0)
    jp = jax.tree.map(jnp.asarray, jp)
    js, ts = jo.init(jp), to.init(tp)
    jupd = jax.jit(jo.update)
    flips = 0  # int8 moment codes that differ, summed over the updates
    for step in range(n_steps):
        jg, tg = _trees(100 + step, 0.5)  # global norm ~ 60: clipping acts
        jp, js = jupd(jax.tree.map(jnp.asarray, jg), js, jp)
        tp, ts = to.update(tg, ts, tp)
        got = dict(_leaves_with_paths(_np(ts)))
        for path, want in _leaves_with_paths(jax.tree.map(np.asarray, js)):
            if want.dtype == np.int8:
                d = np.abs(got[path].astype(np.int32) - want.astype(np.int32))
                assert d.max() <= 1, path
                flips += int((d > 0).sum())
    return jax.tree.map(np.asarray, (jp, js)), (_np(tp), _np(ts)), flips


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("n_steps,rtol,atol", [(1, 1e-5, 1e-7), (20, 1e-4, 1e-6)])
@pytest.mark.parametrize("name,kw,jlr", OPTIMIZERS)
def test_optimizer_matches_jax(name, kw, jlr, n_steps, rtol, atol):
    (jp, js), (tp, ts), flips = _run(name, kw, jlr, n_steps)
    assert int(ts["step"]) == int(js["step"]) == n_steps
    # 8-bit Adam: a code differs by one where x / scale lands within an
    # ulp of a .5 boundary, which the two packages' divisions round apart
    # (no such code after one update, 5 over the 20); the element's next
    # updates then differ by about lr / 127 each, within ``FLIP_ATOL``
    assert flips <= (0 if n_steps == 1 else 8), flips
    off = 0
    got_p = dict(_leaves_with_paths(tp))
    for path, want in _leaves_with_paths(jp):
        got = got_p[path]
        assert got.dtype == want.dtype and got.shape == want.shape, path
        tol = 1e-2 if want.dtype == ml_dtypes.bfloat16 else rtol
        g, w = got.astype(np.float32), want.astype(np.float32)
        close = np.abs(g - w) <= atol + tol * np.abs(w)
        off += int((~close).sum())
        np.testing.assert_allclose(g, w, rtol=tol, atol=FLIP_ATOL if flips else atol,
                                   err_msg=path)
    assert off <= flips, (off, flips)
    got_state = dict(_leaves_with_paths(ts))
    for path, want in _leaves_with_paths(js):
        got = got_state[path]
        assert got.dtype == want.dtype and got.shape == want.shape, path
        if want.dtype != np.int8:
            np.testing.assert_allclose(got, want, rtol=rtol,
                                       atol=FLIP_ATOL if flips else atol,
                                       err_msg=path)


def test_adam8bit_block_layouts():
    o = topt.adam8bit(0.1)
    st = o.init({"a": torch.zeros(64, 512), "b": torch.zeros(64, 300),
                 "s": [torch.zeros(4, 256)] * 3})
    assert st["m"]["a"]["q"].dtype == torch.int8
    assert st["m"]["a"]["s"].shape == (64, 2)   # 256-wide blocks
    assert st["m"]["b"]["s"].shape == (64, 1)   # the whole last dim
    assert st["v"]["s"]["q"].shape == (3, 4, 256)  # a stacked leaf
    x = torch.linspace(-3, 3, 2 * 512).reshape(2, 512)
    q, s = topt._quantize(x)
    jq, js = jopt._quantize(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_allclose(topt._dequantize(q, s, x.shape).numpy(),
                               np.asarray(jopt._dequantize(jq, js, x.shape)))


def test_clip_by_global_norm_matches_jax():
    jt, tt = _trees(7, 2.0)
    want = jax.tree.map(np.asarray, jopt.clip_by_global_norm(
        jax.tree.map(jnp.asarray, jt), 1.0))
    got = _np(topt.clip_by_global_norm(tt, 1.0))
    for path, w in _leaves_with_paths(want):
        g = dict(_leaves_with_paths(got))[path]
        assert g.dtype == w.dtype, path
        np.testing.assert_allclose(g.astype(np.float32), w.astype(np.float32),
                                   rtol=1e-6, err_msg=path)
    g = {"a": torch.tensor([3.0, 4.0])}  # norm 5
    np.testing.assert_allclose(topt.clip_by_global_norm(g, 1.0)["a"].numpy(),
                               [0.6, 0.8], rtol=1e-6)
    assert topt.clip_by_global_norm(g, 0.0) is g


def _quadratic(seed=0, dim=32):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(dim, dim)) / np.sqrt(dim)
    H = A @ A.T + 0.1 * np.eye(dim)
    b = rng.normal(size=dim)
    return (torch.tensor(H, dtype=torch.float32), torch.tensor(b, dtype=torch.float32),
            np.linalg.solve(H, b))


@pytest.mark.parametrize("name,lr,steps,tol", [
    ("adamw", 0.05, 500, 1e-2),
    ("adam8bit", 0.05, 500, 5e-2),
    ("adafactor", 0.5, 500, 5e-2),
    ("sgdm", 0.05, 800, 1e-2),
])
def test_converges_on_quadratic(name, lr, steps, tol):
    """``tests/test_optimizers.py``'s cases on the port."""
    H, b, x_star = _quadratic()
    opt = topt.get_optimizer(name, lr)
    params = {"x": torch.zeros(32)}
    state = opt.init(params)
    for _ in range(steps):
        params, state = opt.update({"x": H @ params["x"] - b}, state, params)
    err = float(np.max(np.abs(params["x"].numpy() - x_star)))
    assert err < tol * max(1.0, float(np.max(np.abs(x_star)))), (name, err)
