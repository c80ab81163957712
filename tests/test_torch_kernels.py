"""The port's kernel layer on the CPU, held against the JAX package.

On the CPU every port wrapper runs its kernel's plain PyTorch version
(``repro_torch/kernels/ref.py``); the JAX side runs its Pallas kernels in
interpret mode and its ``ref.py`` oracles, as ``tests/test_kernels.py``
and ``tests/test_paged_attn_kernel.py`` do.  The same numpy inputs go to
both.  Tolerances: ctx and statistics within 1e-5 (fp32 sums in another
order); pools bit-identical except the trash page, which the reference's
fused kernel never writes and no reader attends; gathers exact.
"""
import subprocess
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import backend, ops  # noqa: E402


def _t(a):
    return torch.from_numpy(np.array(a))


def _paged_case(rng, B, S, H, KV, hd, page, W, pool_dtype, shared=False):
    """Random paged-attention inputs with prefix-allocated tables; row B-1
    inactive (write mask all False).  ``shared``: every request's first
    page is one read-only prefix page (its positions are all cached, so
    no new row lands there)."""
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    kn = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    vn = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    lo = page if shared else 0
    lens = rng.integers(lo, (W - 1) * page - S, size=B)
    need = [-(-(int(n) + S) // page) for n in lens]
    P = sum(need) + 2
    pk = rng.normal(size=(P + 1, page, KV, hd)).astype(np.float32)
    pv = rng.normal(size=(P + 1, page, KV, hd)).astype(np.float32)
    bt = np.full((B, W), -1, np.int32)
    perm = rng.permutation(P)
    c = 0
    for b in range(B):
        bt[b, : need[b]] = perm[c : c + need[b]]
        c += need[b]
    if shared:
        bt[:, 0] = perm[-1]
    wm = rng.random((B, S)) > 0.25
    wm[:, 0] = True
    if B > 1:
        wm[-1] = False
    return q, kn, vn, pk, pv, bt, lens.astype(np.int32), wm


def _jax_args(case, pool_dtype):
    q, kn, vn, pk, pv, bt, pos, wm = case
    jd = jnp.bfloat16 if pool_dtype == "bf16" else jnp.float32
    return (jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
            jnp.asarray(pk).astype(jd), jnp.asarray(pv).astype(jd),
            jnp.asarray(bt), jnp.asarray(pos), jnp.asarray(wm))


def _torch_args(case, pool_dtype):
    q, kn, vn, pk, pv, bt, pos, wm = case
    td = torch.bfloat16 if pool_dtype == "bf16" else torch.float32
    return (_t(q), _t(kn), _t(vn), _t(pk).to(td), _t(pv).to(td), _t(bt),
            _t(pos), _t(wm))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("pool_dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("B,S,H,KV,hd,page,W,window,shared", [
    (3, 1, 4, 2, 8, 4, 8, 0, False),     # decode, GQA 2:1, inactive row
    (2, 5, 6, 3, 16, 8, 8, 0, False),    # verify-sized rows
    (2, 8, 4, 2, 8, 4, 10, 0, True),     # shared read-only prefix page
    (2, 5, 4, 4, 8, 4, 12, 5, False),    # sliding window
    (2, 8, 8, 2, 8, 4, 10, 6, True),     # window + shared page, G = 4
])
def test_paged_attn_plain_matches_jax(pool_dtype, B, S, H, KV, hd, page, W,
                                      window, shared):
    rng = np.random.default_rng(B * 1000 + S * 10 + W + window)
    case = _paged_case(rng, B, S, H, KV, hd, page, W, pool_dtype, shared)
    ctx, pk, pv = ops.paged_attention(*_torch_args(case, pool_dtype),
                                      window=window)
    jk = jops.paged_attention(*_jax_args(case, pool_dtype), window=window)
    jr = jops.paged_attn_ref(*_jax_args(case, pool_dtype), window=window)
    rows = case[7].any(axis=1)  # fully inactive rows are never read
    for want in (jk, jr):
        np.testing.assert_allclose(ctx.numpy()[rows], _f32(want[0])[rows],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(_f32(pk)[:-1], _f32(want[1])[:-1])
        np.testing.assert_array_equal(_f32(pv)[:-1], _f32(want[2])[:-1])
    if shared:  # the shared page was read, never written
        p0 = case[5][0, 0]
        np.testing.assert_array_equal(_f32(pk)[p0],
                                      _f32(_torch_args(case, pool_dtype)[3])[p0])


@pytest.mark.parametrize("shape", [(40, 96), (3, 20, 72)])
def test_expert_stat_plain_matches_jax(shape):
    rng = np.random.default_rng(5)
    z = rng.normal(size=shape).astype(np.float32)
    z[..., -4:, :] = 0.0  # padded chunk rows contribute exactly 0
    got = ops.griffin_stat(_t(z)).numpy()
    for want in (jops.griffin_stat(jnp.asarray(z)),
                 jops.expert_stat_ref(jnp.asarray(z)) if z.ndim == 2 else
                 jnp.stack([jops.expert_stat_ref(jnp.asarray(zz)) for zz in z])):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_paged_gather_plain_matches_jax_exactly(dtype):
    rng = np.random.default_rng(6)
    pool = rng.normal(size=(9, 4, 24)).astype(np.float32)
    bt = rng.integers(-1, 9, size=(3, 5)).astype(np.int32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" \
        else (jnp.float32, torch.float32)
    got = ops.paged_gather(_t(pool).to(td), _t(bt))
    want = jops.paged_gather(jnp.asarray(pool).astype(jd), jnp.asarray(bt))
    np.testing.assert_array_equal(_f32(got), _f32(want))
    kv = ops.paged_kv_gather(_t(pool).to(td).reshape(9, 4, 3, 8), _t(bt))
    np.testing.assert_array_equal(
        _f32(kv), _f32(jops.paged_kv_gather(
            jnp.asarray(pool).astype(jd).reshape(9, 4, 3, 8), jnp.asarray(bt))))


@pytest.mark.parametrize("W,ctas", [(0, 8), (1, 8), (64, 8), (32, 64),
                                    (48, 8), (8, 512), (7, 3),
                                    (40, 8),    # Yi-9B decode, B=2 x KV=4
                                    (40, 16),   # Yi-9B prefill: 4 row tiles
                                    (400, 8),   # long context: many rounds
                                    (5, 1)])    # under two rounds of pages
def test_paged_attn_page_splits_cover_the_table(W, ctas):
    """The fused kernel's page splits cover every block-table column
    exactly once, leave no split empty of columns, cut no split below one
    round of pages, make at most one cluster's worth of splits, and stop
    splitting once the (b, kv, row tile) triples alone fill the card."""
    from repro_torch.kernels.paged_attn import (CTAS_PER_SM, MAX_SPLITS,
                                                MIN_PAGES_PER_SPLIT,
                                                page_splits)

    n_sm = 132
    pps, splits = page_splits(W, ctas, n_sm)
    assert pps >= 1 and splits >= 1
    assert (splits - 1) * pps < max(W, 1) <= splits * pps
    assert splits <= min(max(W, 1), MAX_SPLITS)
    if splits > 1:
        assert pps >= MIN_PAGES_PER_SPLIT
    if ctas >= CTAS_PER_SM * n_sm:
        assert splits == 1
    else:
        assert ctas * splits >= min(CTAS_PER_SM * n_sm, ctas * MAX_SPLITS,
                                    ctas * (W // MIN_PAGES_PER_SPLIT)) / 2


@pytest.mark.parametrize("F,itemsize,address", [
    (11008, 2, 0),      # Yi-9B prefill chunk, bf16: 16-byte loads
    (11008, 4, 0),      # fp32: 2752 vectors
    (512, 4, 0), (520, 4, 0), (1, 2, 0), (33, 4, 0),
    (301, 2, 0),        # odd bf16 row: 2-byte loads
    (8193, 2, 0),       # wider than 8 CTAs of 256 threads
    (1024, 2, 4),       # a view 4 bytes into its storage
    (1024, 2, 8),
    (300000, 4, 16),
])
def test_expert_stat_plan_covers_every_column(F, itemsize, address):
    """The statistic's launch: loads as wide as the row and the address
    allow (at most 16 bytes), a cluster of at most 8 CTAs, at most 512
    threads a CTA, and every vector of a row owned by exactly one thread
    of one CTA."""
    from repro_torch.kernels.expert_stat import (MAX_CLUSTER, MAX_THREADS,
                                                 stat_plan, stat_vec)

    vec = stat_vec(F, itemsize, address)
    assert vec >= 1 and vec * itemsize <= 16 and F % vec == 0
    assert address % (vec * itemsize) == 0
    if 2 * vec * itemsize <= 16:  # the next width up would not fit
        assert F % (2 * vec) or address % (2 * vec * itemsize)
    n_vec = F // vec
    cluster, threads = stat_plan(n_vec)
    assert 1 <= cluster <= MAX_CLUSTER
    assert 32 <= threads <= MAX_THREADS and threads % 32 == 0
    vpc = -(-n_vec // cluster)
    owned = np.zeros(n_vec, np.int64)
    for r in range(cluster):
        v_hi = min(n_vec, (r + 1) * vpc)
        for tid in range(threads):
            owned[r * vpc + tid:v_hi:threads] += 1
    assert (owned == 1).all()
    if n_vec <= cluster * MAX_THREADS:  # one vector a thread: z read once
        assert vpc <= threads


def test_no_hidden_device():
    """Without a card, asking for CUDA (explicitly or by default) raises;
    nothing runs on the CPU instead."""
    from repro_torch import bridge
    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder
    from repro_torch.serving.server import PagedServer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_config("tinylm")
    for dev in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            backend.resolve_device(dev)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            decoder.init_params(cfg, device=dev)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            decoder.init_paged_pools(cfg, 4, 8, device=dev)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bridge.params_from_jax({}, cfg, device=dev)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bridge.tree_from_jax({}, cfg, device=dev)
    params = decoder.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagedServer(cfg, params)
    # a meta tensor is an explicit request for shapes (the dry-run): the
    # plain version runs there and does no arithmetic; any other device
    # is refused
    out = ops.griffin_stat(torch.zeros((2, 3, 5), device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (2, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        backend.is_cuda(types.SimpleNamespace(device=torch.device("xpu")),
                        "griffin_stat")


def test_port_imports_no_jax():
    """Importing every module of the port leaves ``jax`` and the JAX
    package out of ``sys.modules``."""
    prog = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'jaxlib')) or m == 'repro' "
        "or m.startswith('repro.'))\n"
        "assert len(names) > 25, names\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    import os
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src)
    r = subprocess.run([sys.executable, "-c", prog], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
