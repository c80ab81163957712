"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: every test skips where no CUDA device is present
(the check runs inside a fixture, never at import time).

Run on a machine with the card (no JAX needed there, hence
``--noconftest``)::

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(rng, B, S, H, KV, hd, page, W, pool_dtype, dev, in_dtype):
    q = torch.tensor(rng.normal(size=(B, S, H, hd)), dtype=torch.float32).to(in_dtype)
    kn = torch.tensor(rng.normal(size=(B, S, KV, hd)), dtype=torch.float32).to(in_dtype)
    vn = torch.tensor(rng.normal(size=(B, S, KV, hd)), dtype=torch.float32).to(in_dtype)
    lens = rng.integers(0, (W - 1) * page - S, size=B)
    need = [-(-(int(n) + S) // page) for n in lens]
    P = sum(need) + 2
    pk = torch.tensor(rng.normal(size=(P + 1, page, KV, hd)),
                      dtype=torch.float32).to(pool_dtype)
    pv = torch.tensor(rng.normal(size=(P + 1, page, KV, hd)),
                      dtype=torch.float32).to(pool_dtype)
    bt = np.full((B, W), -1, np.int32)
    perm = rng.permutation(P)
    c = 0
    for b in range(B):
        bt[b, : need[b]] = perm[c : c + need[b]]
        c += need[b]
    wm = rng.random((B, S)) > 0.25
    if B > 1:
        wm[-1] = False
    args = [q, kn, vn, pk, pv, torch.tensor(bt),
            torch.tensor(lens.astype(np.int32)), torch.tensor(wm)]
    return [a.to(dev) for a in args]


@pytest.mark.parametrize("in_dtype,pool_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("B,S,H,KV,hd,page,W,window", [
    (3, 1, 4, 2, 8, 4, 8, 0),
    (2, 5, 6, 3, 16, 8, 8, 0),
    (2, 5, 4, 4, 8, 4, 12, 5),
    (1, 32, 32, 4, 128, 16, 48, 0),   # Yi-9B prefill chunk
    (2, 1, 32, 4, 128, 16, 48, 0),    # Yi-9B decode
    (8, 32, 32, 4, 128, 16, 8, 0),    # enough CTAs for one page split
])
def test_paged_attn_kernel_matches_plain(dev, in_dtype, pool_dtype, B, S, H,
                                         KV, hd, page, W, window):
    rng = np.random.default_rng(B * 1000 + S * 10 + W + window)
    args = _case(rng, B, S, H, KV, hd, page, W, pool_dtype, dev, in_dtype)
    kern = [a.clone() for a in args]
    plain = [a.clone() for a in args]
    ctx_k, pk_k, pv_k = ops.paged_attention(*kern, window=window)
    ctx_r, pk_r, pv_r = ref.paged_attn_ref(*plain, window=window)
    torch.cuda.synchronize()
    rows = args[7].any(dim=1)
    torch.testing.assert_close(ctx_k[rows], ctx_r[rows], rtol=1e-5, atol=1e-5)
    # pools bit-identical except the trash page (the kernel never writes it)
    assert torch.equal(pk_k[:-1], pk_r[:-1])
    assert torch.equal(pv_k[:-1], pv_r[:-1])


@pytest.mark.parametrize("shape,dtype", [
    ((37, 300), torch.float32),
    ((3, 33, 520), torch.float32),
    ((1, 32, 11008), torch.bfloat16),
])
def test_expert_stat_kernel_matches_plain(dev, shape, dtype):
    rng = np.random.default_rng(1)
    z = torch.tensor(rng.normal(size=shape), dtype=torch.float32).to(dtype)
    z[..., -3:, :] = 0  # padded rows contribute 0
    z = z.to(dev)
    got = ops.griffin_stat(z)
    want = ref.expert_stat_ref(z)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # deterministic: the same bits on a second run
    assert torch.equal(got, ops.griffin_stat(z))


@pytest.mark.parametrize("dtype,E", [(torch.float32, 96), (torch.bfloat16, 512),
                                     (torch.float32, 3)])
def test_paged_gather_kernel_is_exact(dev, dtype, E):
    rng = np.random.default_rng(2)
    pool = torch.tensor(rng.normal(size=(9, 8, E)), dtype=torch.float32).to(dtype)
    bt = torch.tensor(rng.integers(-1, 9, size=(3, 5)), dtype=torch.int32)
    got = ops.paged_gather(pool.to(dev), bt.to(dev))
    assert torch.equal(got.cpu(), ref.paged_gather_ref(pool, bt))


# ---------------------------------------------------------------------------
# quantized pools (int8 / fp8)
# ---------------------------------------------------------------------------

def _warm_quant_case(rng, B, S, H, KV, hd, page, W, kvd, dev, in_dtype,
                     grow=1.0):
    """Paged-attention inputs over warm quantized pools (every real page
    holds live bits under a grown scale, made by the plain scatter on the
    card).  ``grow`` scales the new rows: above 1 they raise the scales of
    the pages they land in, so old rows are re-encoded while live."""
    from repro_torch.kernels import kv_quant

    args = _case(rng, B, S, H, KV, hd, page, W, torch.float32, dev, in_dtype)
    q, kn, vn, pkf, pvf, bt, pos, wm = args
    P1 = pkf.shape[0]
    gp = torch.arange(P1, device=dev).repeat_interleave(page)
    off = torch.arange(page, device=dev).repeat(P1)
    zero = torch.zeros(pkf.shape, dtype=kv_quant.pool_torch_dtype(kvd, "float32"),
                       device=dev)
    s0 = torch.zeros((P1, 1, KV, 1), device=dev)
    pk, sk = kv_quant.quantize_scatter_ref(zero, s0, gp, off,
                                           pkf.reshape(-1, KV, hd), kvd)
    pv, sv = kv_quant.quantize_scatter_ref(zero, s0, gp, off,
                                           pvf.reshape(-1, KV, hd), kvd)
    kn, vn = (kn.float() * grow).to(in_dtype), (vn.float() * grow).to(in_dtype)
    return [q, kn, vn, pk, pv, bt, pos, wm], sk, sv


@pytest.mark.parametrize("kvd", ["int8", "fp8"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,page,W,window,grow", [
    (3, 1, 4, 2, 8, 4, 8, 0, 1.0),
    (2, 5, 6, 3, 16, 8, 8, 0, 4.0),       # scales grow under live rows
    (2, 5, 4, 4, 8, 4, 12, 5, 1.0),
    (1, 32, 32, 4, 128, 16, 48, 0, 3.0),  # Yi-9B prefill: 16 row tiles, splits
    (2, 1, 32, 4, 128, 16, 48, 0, 1.0),   # Yi-9B decode
    (8, 32, 32, 4, 128, 16, 8, 0, 2.0),   # one page split
])
def test_quantized_paged_attn_kernel_matches_plain(dev, kvd, in_dtype, B, S,
                                                   H, KV, hd, page, W, window,
                                                   grow):
    from repro_torch.kernels import kv_quant

    rng = np.random.default_rng(B * 1000 + S * 10 + W + window)
    args, sk, sv = _warm_quant_case(rng, B, S, H, KV, hd, page, W, kvd, dev,
                                    in_dtype, grow)
    kern = [a.clone() for a in args] + [sk.clone(), sv.clone()]
    plain = [a.clone() for a in args] + [sk.clone(), sv.clone()]
    out_k = ops.paged_attention(*kern[:8], scale_k=kern[8], scale_v=kern[9],
                                kv_dtype=kvd, window=window)
    out_r = ref.paged_attn_ref(*plain[:8], scale_k=plain[8], scale_v=plain[9],
                               kv_dtype=kvd, window=window)
    torch.cuda.synchronize()
    assert len(out_k) == 5
    rows = args[7].any(dim=1)
    torch.testing.assert_close(out_k[0][rows], out_r[0][rows], rtol=1e-5,
                               atol=1e-5)
    # pools and scales bit-identical except the trash page
    for a, b in zip(out_k[1:], out_r[1:]):
        assert torch.equal(kv_quant.as_bytes(a)[:-1], kv_quant.as_bytes(b)[:-1])
    if grow > 1.0:  # some scale really grew
        assert bool((out_k[3][:-1] > sk[:-1]).any())


# ---------------------------------------------------------------------------
# the FF kernels
# ---------------------------------------------------------------------------

def _ffn_tol(dtype):
    # bf16: the plain version rounds g, h and z to bf16, the kernel only z
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else \
        dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,D,F,BK,nsel", [
    (1, 128, 512, 128, 2),
    (4, 256, 1024, 128, 4),
    (8, 128, 2048, 256, 3),
    (6, 100, 512, 128, 2),    # D not a multiple of the vector width
    (2, 4096, 11008, 128, 43),  # Yi-9B width
])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "reglu"])
def test_griffin_ffn_kernel_matches_plain(dev, dtype, B, D, F, BK, nsel, act):
    from repro_torch.kernels import griffin_ffn

    rng = np.random.default_rng(B * D + F)
    t = lambda a: torch.tensor(a, dtype=torch.float32).to(dtype).to(dev)  # noqa: E731
    x = t(rng.normal(size=(B, D)))
    wg, w1 = (t(rng.normal(size=(F, D)) / np.sqrt(D)) for _ in range(2))
    w2 = t(rng.normal(size=(F, D)) / np.sqrt(nsel * BK))
    ids = torch.tensor(np.sort(rng.choice(F // BK, size=nsel, replace=False)),
                       dtype=torch.int32, device=dev)
    before = griffin_ffn.launches
    got = ops.griffin_ffn_decode(x, wg, w1, w2, ids, block_size=BK,
                                 activation=act)
    want = ref.griffin_ffn_ref(x, wg, w1, w2, ids, BK, activation=act)
    torch.cuda.synchronize()
    assert griffin_ffn.launches == before + 1
    tol = _ffn_tol(dtype) if D < 4096 or dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, want, **tol)
    assert torch.equal(got, ops.griffin_ffn_decode(
        x, wg, w1, w2, ids, block_size=BK, activation=act))  # deterministic


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,D,F", [(64, 128, 512), (300, 256, 1024),
                                   (3, 96, 200), (32, 4096, 11008)])
@pytest.mark.parametrize("act", ["swiglu", "geglu"])
def test_glu_ffn_kernel_matches_plain(dev, dtype, S, D, F, act):
    rng = np.random.default_rng(S + D)
    t = lambda a: torch.tensor(a, dtype=torch.float32).to(dtype).to(dev)  # noqa: E731
    x = t(rng.normal(size=(S, D)))
    wg, w1 = (t(rng.normal(size=(D, F)) / np.sqrt(D)) for _ in range(2))
    w2 = t(rng.normal(size=(F, D)) / np.sqrt(F))
    got = ops.glu_ffn_forward(x, wg, w1, w2, activation=act)
    want = ref.glu_ffn_ref(x, wg, w1, w2, activation=act)
    torch.cuda.synchronize()
    tol = _ffn_tol(dtype) if D < 4096 or dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, want, **tol)
