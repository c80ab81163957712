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
