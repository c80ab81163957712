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


def _case(rng, B, S, H, KV, hd, page, W, pool_dtype, dev, in_dtype, lens=None):
    q = torch.tensor(rng.normal(size=(B, S, H, hd)), dtype=torch.float32).to(in_dtype)
    kn = torch.tensor(rng.normal(size=(B, S, KV, hd)), dtype=torch.float32).to(in_dtype)
    vn = torch.tensor(rng.normal(size=(B, S, KV, hd)), dtype=torch.float32).to(in_dtype)
    if lens is None:
        lens = rng.integers(0, (W - 1) * page - S, size=B)
    lens = np.asarray(lens)
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


def _check_paged_attn(args, window=0):
    """The kernel and the plain version on copies of the same inputs: ctx
    within 1e-5 on rows that write, pools bit-identical except the trash
    page.  Returns the kernel's ctx."""
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
    return ctx_k


@pytest.mark.parametrize("in_dtype,pool_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("B,S,H,KV,hd,page,W,window", [
    (3, 1, 4, 2, 8, 4, 8, 0),
    (2, 5, 6, 3, 16, 8, 8, 0),
    (2, 5, 4, 4, 8, 4, 12, 5),
    (1, 32, 32, 4, 128, 16, 48, 0),   # Yi-9B prefill chunk
    (2, 1, 32, 4, 128, 16, 48, 0),    # Yi-9B decode
    (8, 32, 32, 4, 128, 16, 8, 0),    # 128 (b, kv, row tile) CTAs, 2 splits
])
def test_paged_attn_kernel_matches_plain(dev, in_dtype, pool_dtype, B, S, H,
                                         KV, hd, page, W, window):
    rng = np.random.default_rng(B * 1000 + S * 10 + W + window)
    args = _case(rng, B, S, H, KV, hd, page, W, pool_dtype, dev, in_dtype)
    _check_paged_attn(args, window=window)


@pytest.mark.parametrize("in_dtype,pool_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_paged_attn_long_context_decode(dev, in_dtype, pool_dtype):
    """Hundreds of pages per (b, kv) and several rounds per split: the
    kernel's ring of page stages wraps many times."""
    from repro_torch.kernels.paged_attn import MIN_PAGES_PER_SPLIT, page_splits

    rng = np.random.default_rng(11)
    W, page = 400, 16
    args = _case(rng, 2, 1, 32, 4, 128, page, W, pool_dtype, dev, in_dtype,
                 lens=[6100, 4711])
    pps, _ = page_splits(W, 2 * 4, torch.cuda.get_device_properties(dev)
                         .multi_processor_count)
    assert pps >= 4 * MIN_PAGES_PER_SPLIT
    _check_paged_attn(args)


@pytest.mark.parametrize("in_dtype,pool_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("B,window", [(1, 0), (2, 100), (2, 300)])
def test_paged_attn_decode_b1_and_window(dev, in_dtype, pool_dtype, B, window):
    """B=1 decode at Yi-9B width, and decode with a sliding window over
    several page splits (whole splits skipped, one split cut in two)."""
    rng = np.random.default_rng(B * 7 + window)
    args = _case(rng, B, 1, 32, 4, 128, 16, 40, pool_dtype, dev, in_dtype,
                 lens=[583, 431][:B])
    _check_paged_attn(args, window=window)


@pytest.mark.parametrize("kvd", ["fp32", "bf16", "int8", "fp8"])
def test_paged_attn_yi9b_prefill_every_pool_format(dev, kvd):
    """A Yi-9B prefill chunk (S=32, 4 row tiles, bf16 queries) over each
    pool format; quantized pools also within ERROR_BUDGET of fp32 pools."""
    from repro_torch.kernels import kv_quant

    rng = np.random.default_rng(32)
    if kvd in ("fp32", "bf16"):
        pool_dtype = torch.float32 if kvd == "fp32" else torch.bfloat16
        args = _case(rng, 1, 32, 32, 4, 128, 16, 40, pool_dtype, dev,
                     torch.bfloat16, lens=[448])
        _check_paged_attn(args)
        return
    args, sk, sv, (pkf, pvf) = _warm_quant_case(
        rng, 1, 32, 32, 4, 128, 16, 40, kvd, dev, torch.bfloat16, lens=[448],
        with_fp32=True)
    out_k, _ = _run_quant(args, sk, sv, kvd)
    q, kn, vn, _, _, bt, pos, wm = args
    ctx_f = ref.paged_attn_ref(q, kn, vn, pkf.clone(), pvf.clone(), bt, pos,
                               wm)[0]
    assert (out_k[0] - ctx_f).abs().max().item() <= kv_quant.ERROR_BUDGET[kvd]


#: the Yi-9B speculative verify call (spec_k 4): request 0's 5 rows cross
#: a page boundary (589 cached, rows at 589..593, page 16), request 1
#: drafted k_r = 2, so its rows 3-4 are masked
VERIFY_LENS = [589, 431]


def verify_mask(dev):
    wm = torch.ones((2, 5), dtype=torch.bool, device=dev)
    wm[1, 3:] = False
    return wm


@pytest.mark.parametrize("kvd", ["fp32", "bf16", "int8", "fp8"])
def test_paged_attn_yi9b_verify_every_pool_format(dev, kvd):
    """The verify shape [n_slots=2, k+1=5] at Yi-9B width over each pool
    format (bf16 queries): ctx within 1e-5, pools (and scales) bit-identical
    except the trash page; quantized, some new rows grow their page's
    scale and ctx stays within ERROR_BUDGET of fp32 pools."""
    from repro_torch.kernels import kv_quant

    rng = np.random.default_rng(45)
    if kvd in ("fp32", "bf16"):
        pool_dtype = torch.float32 if kvd == "fp32" else torch.bfloat16
        args = _case(rng, 2, 5, 32, 4, 128, 16, 40, pool_dtype, dev,
                     torch.bfloat16, lens=VERIFY_LENS)
        args[7] = verify_mask(dev)
        _check_paged_attn(args)
        return
    args, sk, sv, (pkf, pvf) = _warm_quant_case(
        rng, 2, 5, 32, 4, 128, 16, 40, kvd, dev, torch.bfloat16,
        lens=VERIFY_LENS, with_fp32=True)
    args[7] = verify_mask(dev)
    out_k, _ = _run_quant(args, sk, sv, kvd)
    assert bool((out_k[3][:-1] > sk[:-1]).any() or (out_k[4][:-1] > sv[:-1]).any())
    q, kn, vn, _, _, bt, pos, wm = args
    ctx_f = ref.paged_attn_ref(q, kn, vn, pkf.clone(), pvf.clone(), bt, pos,
                               wm)[0]
    rows = wm.any(dim=1)
    assert (out_k[0][rows] - ctx_f[rows]).abs().max().item() <= \
        kv_quant.ERROR_BUDGET[kvd]


@pytest.mark.parametrize("kvd", ["int8", "fp8"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
def test_quantized_decode_reencodes_live_rows_in_launch(dev, kvd, in_dtype):
    """Yi-9B decode with new rows 4x the cached ones: each page receiving a
    row grows its scale, and the one CTA that reads it re-encodes its old
    rows inside the attention launch."""
    rng = np.random.default_rng(4)
    args, sk, sv = _warm_quant_case(rng, 2, 1, 32, 4, 128, 16, 40, kvd, dev,
                                    in_dtype, grow=4.0, lens=[583, 431])
    out_k, _ = _run_quant(args, sk, sv, kvd)
    assert bool((out_k[3][:-1] > sk[:-1]).any())


@pytest.mark.parametrize("kvd", ["fp32", "int8"])
def test_paged_attn_back_to_back_calls_agree(dev, kvd):
    """Two calls on the same inputs give bit-identical ctx: the in-launch
    merge of the page splits (a thread block cluster) sums them in split
    order whatever order the CTAs finish in, and leaves no state behind."""
    rng = np.random.default_rng(5)
    if kvd == "fp32":
        args = _case(rng, 2, 1, 32, 4, 128, 16, 40, torch.bfloat16, dev,
                     torch.bfloat16, lens=[583, 431])
        ctxs = [ops.paged_attention(*[a.clone() for a in args])[0]
                for _ in range(2)]
    else:
        args, sk, sv = _warm_quant_case(rng, 2, 1, 32, 4, 128, 16, 40, kvd,
                                        dev, torch.bfloat16, lens=[583, 431])
        ctxs = [_run_quant(args, sk, sv, kvd)[0][0] for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(ctxs[0], ctxs[1])


def test_paged_attn_refuses_another_row_tile(dev):
    """The C entry points check the row tile the wrapper sizes its scratch
    for against the compiled one."""
    from repro_torch.kernels import backend
    from repro_torch.kernels.paged_attn import ROWS_PER_CTA

    lib = backend.lib()
    args = [None] * 9 + [1, 1, 8, 2, 128, 16, 4, 0, 1.0, 1, 2,
                         ROWS_PER_CTA // 2, 1, 1, None]
    assert lib.paged_attn(*args) != 0


@pytest.mark.parametrize("shape,dtype", [
    ((37, 300), torch.float32),
    ((3, 33, 520), torch.float32),
    ((1, 32, 11008), torch.bfloat16),
    ((2, 300, 11008), torch.bfloat16),  # 19 row tiles, 2 clusters
    ((4, 33, 520), torch.float32),
    ((1, 1, 11008), torch.bfloat16),    # S = 1
    ((1, 32, 11008), torch.float32),    # 2752 vectors: 344 a CTA, 2 a thread
    ((1, 17, 301), torch.bfloat16),     # rows not 16-byte aligned: 2-byte loads
    ((2, 20, 8193), torch.bfloat16),    # 1025 vectors a CTA: 5 a thread
    ((2, 512, 11008), torch.float32),   # GenerationEngine's whole-prompt
    ((2, 512, 11008), torch.bfloat16),  # prefill at Yi-9B width: 16 tiles
    # the engine's prompt shape at the MoE/MLA families' GRIFFIN widths:
    # Moonshot's shared experts and dense layer, DeepSeek-V3's
    ((2, 512, 2816), torch.bfloat16),
    ((2, 512, 11264), torch.bfloat16),
    ((2, 512, 2048), torch.bfloat16),
    ((2, 512, 18432), torch.bfloat16),
])
def test_expert_stat_kernel_matches_plain(dev, shape, dtype):
    from repro_torch.kernels import expert_stat

    rng = np.random.default_rng(1)
    z = torch.tensor(rng.normal(size=shape), dtype=torch.float32).to(dtype)
    pad = 3 if shape[-2] > 3 else 0
    if pad:
        z[..., -pad:, :] = 0  # padded rows contribute 0
    z = z.to(dev)
    before = expert_stat.launches
    got = ops.griffin_stat(z)
    assert expert_stat.launches == before + 1
    want = ref.expert_stat_ref(z)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # deterministic: the same bits on a second run
    assert torch.equal(got, ops.griffin_stat(z))
    if pad:  # all-zero rows add exactly nothing, in any row tile
        assert torch.equal(got, ops.griffin_stat(z[..., :-pad, :].contiguous()))


def test_expert_stat_all_zero_rows_and_offset_view(dev):
    """Every row zero gives zeros; a z whose address is only 4-byte
    aligned (a view one bf16 pair in) takes narrower loads."""
    z = torch.zeros((2, 40, 1024), dtype=torch.bfloat16, device=dev)
    assert torch.equal(ops.griffin_stat(z), torch.zeros((2, 1024), device=dev))
    rng = np.random.default_rng(7)
    flat = torch.tensor(rng.normal(size=32 * 1024 + 2),
                        dtype=torch.float32).to(torch.bfloat16).to(dev)
    z = flat[2:].view(32, 1024)
    got = ops.griffin_stat(z)
    torch.testing.assert_close(got, ref.expert_stat_ref(z), rtol=1e-5, atol=1e-5)
    assert torch.equal(got, ops.griffin_stat(z))


@pytest.mark.parametrize("dtype,E", [(torch.float32, 96), (torch.bfloat16, 512),
                                     (torch.float32, 3)])
def test_paged_gather_kernel_is_exact(dev, dtype, E):
    rng = np.random.default_rng(2)
    pool = torch.tensor(rng.normal(size=(9, 8, E)), dtype=torch.float32).to(dtype)
    bt = torch.tensor(rng.integers(-1, 9, size=(3, 5)), dtype=torch.int32)
    got = ops.paged_gather(pool.to(dev), bt.to(dev))
    assert torch.equal(got.cpu(), ref.paged_gather_ref(pool, bt))


@pytest.mark.parametrize("dtype,E", [(torch.bfloat16, 512), (torch.float32, 3)])
def test_paged_gather_kernel_clips_negative_entries(dev, dtype, E):
    """A raw table with unallocated (-1) entries goes straight to the
    kernel's wrapper, which reads page 0 for them in one launch."""
    from repro_torch.kernels import paged_gather

    rng = np.random.default_rng(3)
    pool = torch.tensor(rng.normal(size=(9, 16, E)), dtype=torch.float32).to(dtype)
    bt = torch.full((2, 64), -1, dtype=torch.int32)
    bt[0, :37] = torch.tensor(rng.permutation(9 * 5)[:37] % 9, dtype=torch.int32)
    bt[1, :5] = torch.tensor([3, 0, 8, 1, 1], dtype=torch.int32)
    before = paged_gather.launches
    got = paged_gather.paged_gather(pool.to(dev), bt.to(dev))
    assert paged_gather.launches == before + 1
    assert torch.equal(got.cpu(), ref.paged_gather_ref(pool, bt))


# ---------------------------------------------------------------------------
# quantized pools (int8 / fp8)
# ---------------------------------------------------------------------------

def _warm_quant_case(rng, B, S, H, KV, hd, page, W, kvd, dev, in_dtype,
                     grow=1.0, lens=None, with_fp32=False):
    """Paged-attention inputs over warm quantized pools (every real page
    holds live bits under a grown scale, made by the plain scatter on the
    card).  ``grow`` scales the new rows: above 1 they raise the scales of
    the pages they land in, so old rows are re-encoded while live."""
    from repro_torch.kernels import kv_quant

    args = _case(rng, B, S, H, KV, hd, page, W, torch.float32, dev, in_dtype,
                 lens)
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
    out = [q, kn, vn, pk, pv, bt, pos, wm], sk, sv
    return out + ((pkf, pvf),) if with_fp32 else out


def _run_quant(args, sk, sv, kvd, window=0):
    """The kernel and the plain version on copies of the same quantized
    inputs; ctx within 1e-5, pools and scales bit-identical except the
    trash page.  Returns both outputs."""
    from repro_torch.kernels import kv_quant

    kern = [a.clone() for a in args] + [sk.clone(), sv.clone()]
    plain = [a.clone() for a in args] + [sk.clone(), sv.clone()]
    out_k = ops.paged_attention(*kern[:8], scale_k=kern[8], scale_v=kern[9],
                                kv_dtype=kvd, window=window)
    out_r = ref.paged_attn_ref(*plain[:8], scale_k=plain[8], scale_v=plain[9],
                               kv_dtype=kvd, window=window)
    torch.cuda.synchronize()
    rows = args[7].any(dim=1)
    torch.testing.assert_close(out_k[0][rows], out_r[0][rows], rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(out_k[1:], out_r[1:]):
        assert torch.equal(kv_quant.as_bytes(a)[:-1], kv_quant.as_bytes(b)[:-1])
    return out_k, out_r


@pytest.mark.parametrize("kvd", ["int8", "fp8"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV,hd,page,W,window,grow", [
    (3, 1, 4, 2, 8, 4, 8, 0, 1.0),
    (2, 5, 6, 3, 16, 8, 8, 0, 4.0),       # scales grow under live rows
    (2, 5, 4, 4, 8, 4, 12, 5, 1.0),
    (1, 32, 32, 4, 128, 16, 48, 0, 3.0),  # Yi-9B prefill: 4 row tiles, splits
    (2, 1, 32, 4, 128, 16, 48, 0, 1.0),   # Yi-9B decode
    (8, 32, 32, 4, 128, 16, 8, 0, 2.0),   # 128 CTAs before splitting, 2 splits
])
def test_quantized_paged_attn_kernel_matches_plain(dev, kvd, in_dtype, B, S,
                                                   H, KV, hd, page, W, window,
                                                   grow):
    rng = np.random.default_rng(B * 1000 + S * 10 + W + window)
    args, sk, sv = _warm_quant_case(rng, B, S, H, KV, hd, page, W, kvd, dev,
                                    in_dtype, grow)
    out_k, _ = _run_quant(args, sk, sv, kvd, window=window)
    assert len(out_k) == 5
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
    rng = np.random.default_rng(B * D + F)
    t = lambda a: torch.tensor(a, dtype=torch.float32).to(dtype).to(dev)  # noqa: E731
    x = t(rng.normal(size=(B, D)))
    wg, w1 = (t(rng.normal(size=(F, D)) / np.sqrt(D)) for _ in range(2))
    w2 = t(rng.normal(size=(F, D)) / np.sqrt(nsel * BK))
    ids = torch.tensor(np.sort(rng.choice(F // BK, size=nsel, replace=False)),
                       dtype=torch.int32, device=dev)
    _check_griffin_ffn(x, wg, w1, w2, ids, BK, act)


def _check_griffin_ffn(x, wg, w1, w2, ids, BK, act):
    """The kernel against its plain version on the same block ids (2e-2
    bf16, 1e-4 fp32 at D >= 4096, else 1e-5), one launch counted, the same
    bits on a second call."""
    from repro_torch.kernels import griffin_ffn

    before = griffin_ffn.launches
    got = ops.griffin_ffn_decode(x, wg, w1, w2, ids, block_size=BK,
                                 activation=act)
    want = ref.griffin_ffn_ref(x, wg, w1, w2, ids, BK, activation=act)
    torch.cuda.synchronize()
    assert griffin_ffn.launches == before + 1
    D = x.shape[1]
    tol = _ffn_tol(x.dtype) if D < 4096 or x.dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, want, **tol)
    assert torch.equal(got, ops.griffin_ffn_decode(
        x, wg, w1, w2, ids, block_size=BK, activation=act))


@pytest.mark.parametrize("B,D,F,BK,nsel,dtype,act,order", [
    (1, 4096, 11008, 128, 43, torch.bfloat16, "swiglu", "sorted"),  # B = 1
    (9, 4096, 11008, 128, 43, torch.bfloat16, "swiglu", "sorted"),  # past n8
    (17, 4096, 11008, 128, 43, torch.bfloat16, "reglu", "sorted"),  # 64-row tile
    (33, 4096, 11008, 128, 43, torch.bfloat16, "geglu", "sorted"),
    (33, 256, 1024, 128, 4, torch.float32, "swiglu", "sorted"),
    (2, 4096, 11008, 128, 1, torch.bfloat16, "swiglu", "sorted"),   # nb = 1
    (2, 4096, 11008, 128, 86, torch.bfloat16, "swiglu", "sorted"),  # all blocks
    (2, 4096, 11008, 128, 86, torch.float32, "swiglu", "sorted"),
    (2, 4096, 11008, 64, 87, torch.bfloat16, "swiglu", "sorted"),   # bs = box
    (2, 4096, 11008, 256, 21, torch.bfloat16, "geglu", "sorted"),   # 4 boxes
    (2, 4096, 11008, 32, 170, torch.bfloat16, "swiglu", "sorted"),  # no TMA
    (3, 100, 512, 128, 2, torch.bfloat16, "reglu", "sorted"),  # D = 100
    (3, 101, 512, 128, 2, torch.bfloat16, "swiglu", "sorted"),  # 2-byte rows
    (2, 4096, 11008, 128, 43, torch.bfloat16, "swiglu", "unsorted"),
    (5, 256, 1024, 64, 7, torch.float32, "geglu", "unsorted"),
])
def test_griffin_ffn_kernel_ragged_shapes(dev, B, D, F, BK, nsel, dtype, act,
                                          order):
    """Decode rows across the row-tile edges, one and every block, block
    sizes against the 64-row TMA box and the k tile, unaligned D, and
    block ids in any order (taken as given, as the plain version takes
    them)."""
    rng = np.random.default_rng(B * 13 + D + nsel)
    t = lambda a: torch.tensor(a, dtype=torch.float32).to(dtype).to(dev)  # noqa: E731
    x = t(rng.normal(size=(B, D)))
    wg, w1 = (t(rng.normal(size=(F, D)) / np.sqrt(D)) for _ in range(2))
    w2 = t(rng.normal(size=(F, D)) / np.sqrt(nsel * BK))
    ids = rng.choice(F // BK, size=nsel, replace=False)
    if order == "sorted":
        ids = np.sort(ids)
    else:
        assert not (np.diff(ids) > 0).all()
    _check_griffin_ffn(x, wg, w1, w2, torch.tensor(ids, dtype=torch.int32,
                                                   device=dev), BK, act)


@pytest.mark.parametrize("M", [1, 16, 17, 64])
@pytest.mark.parametrize("dtype,tma", [(torch.float32, False),
                                       (torch.bfloat16, False),
                                       (torch.bfloat16, True)])
def test_griffin_ffn_passes_fit_the_plan(dev, M, dtype, tma):
    """Every instantiation of both passes fits as many CTAs per SM, by
    registers and shared memory, as ``griffin_plan`` counts on (3 at a
    16-row tile, 2 at 64 rows), so no pass runs in a second wave."""
    from repro_torch.kernels import griffin_ffn

    up, down = griffin_ffn.resident_ctas(M, dtype, tma)
    want = griffin_ffn.ctas_per_sm(M)
    assert up >= want and down >= want, (up, down, want)


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
    _check_glu_ffn(x, wg, w1, w2, act)


def _check_glu_ffn(x, wg, w1, w2, act):
    """The kernel against its plain version (``FF_TOL`` of chip_smoke:
    2e-2 bf16, 1e-4 fp32 at D >= 4096, else 1e-5), one launch counted,
    the same bits on a second call."""
    from repro_torch.kernels import glu_ffn

    before = glu_ffn.launches
    got = ops.glu_ffn_forward(x, wg, w1, w2, activation=act)
    want = ref.glu_ffn_ref(x, wg, w1, w2, activation=act)
    torch.cuda.synchronize()
    assert glu_ffn.launches == before + 1
    D = x.shape[1]
    tol = _ffn_tol(x.dtype) if D < 4096 or x.dtype == torch.bfloat16 else \
        dict(rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, want, **tol)
    assert torch.equal(got, ops.glu_ffn_forward(x, wg, w1, w2, activation=act))


@pytest.mark.parametrize("S,D,F,dtype,act", [
    (1, 4096, 11008, torch.bfloat16, "swiglu"),   # M = 1: one row of 32
    (33, 4096, 11008, torch.bfloat16, "swiglu"),  # a ragged 64-row tile
    (1, 128, 512, torch.float32, "reglu"),
    (33, 256, 1024, torch.float32, "reglu"),
    (33, 256, 1024, torch.bfloat16, "reglu"),
    (5, 96, 1001, torch.bfloat16, "reglu"),       # odd F: 2-byte rows
    (5, 96, 1001, torch.float32, "geglu"),
    (7, 100, 300, torch.bfloat16, "swiglu"),      # D, F rows 8-byte aligned
    (2, 4096, 64, torch.bfloat16, "geglu"),       # one k tile of z: one split
])
def test_glu_ffn_kernel_ragged_shapes(dev, S, D, F, dtype, act):
    rng = np.random.default_rng(S * 7 + F)
    t = lambda a: torch.tensor(a, dtype=torch.float32).to(dtype).to(dev)  # noqa: E731
    x = t(rng.normal(size=(S, D)))
    wg, w1 = (t(rng.normal(size=(D, F)) / np.sqrt(D)) for _ in range(2))
    w2 = t(rng.normal(size=(F, D)) / np.sqrt(F))
    _check_glu_ffn(x, wg, w1, w2, act)


@pytest.mark.parametrize("BK,F,bad", [(128, 8192, 64), (32, 1536, 48)])
def test_griffin_ffn_bad_block_id_adds_nothing(dev, BK, F, bad):
    """A block id one past the last block (F / BK) on the TMA path (block
    size 128) and on the cp.async path (block size 32): a block that adds
    nothing, as in the plain version (its rows are read in bounds)."""
    rng = np.random.default_rng(F + bad)
    t = lambda a: torch.tensor(a, dtype=torch.float32).to(torch.bfloat16).to(dev)  # noqa: E731
    D = 256
    x = t(rng.normal(size=(2, D)))
    wg, w1 = (t(rng.normal(size=(F, D)) / np.sqrt(D)) for _ in range(2))
    w2 = t(rng.normal(size=(F, D)) / np.sqrt(4 * BK))
    good = [3, 10, F // BK - 1]
    ids = torch.tensor([3, bad, 10, F // BK - 1], dtype=torch.int32, device=dev)
    _check_griffin_ffn(x, wg, w1, w2, ids, BK, "swiglu")
    without = ops.griffin_ffn_decode(
        x, wg, w1, w2, torch.tensor(good, dtype=torch.int32, device=dev),
        block_size=BK)
    torch.testing.assert_close(ops.griffin_ffn_decode(x, wg, w1, w2, ids,
                                                      block_size=BK),
                               without, **_ffn_tol(torch.bfloat16))


# ---------------------------------------------------------------------------
# a speculative round
# ---------------------------------------------------------------------------

def _tinylm_round(dev, seed=0):
    """tinylm (projections scaled by 2, as the server tests scale them) on
    the card with random pools, tables for 3 slots, and per-slot compacted
    FF weights (each slot's own random half of the neurons)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder
    from repro_torch.models.layers import ffn as ffn_lib

    cfg = get_config("tinylm")
    params = decoder.init_params(cfg, seed=seed, device="cpu")
    for lp in params["layers"]:
        for group in ("mixer", "ffn"):
            for k, v in lp[group].items():
                if k.startswith("w"):
                    v.mul_(2.0)
    to = lambda t: ({k: to(v) for k, v in t.items()} if isinstance(t, dict)  # noqa: E731
                    else [to(v) for v in t] if isinstance(t, list) else t.to(dev))
    params = to(params)
    rng = np.random.default_rng(seed)
    page, P = 8, 12
    pools = decoder.init_paged_pools(cfg, P, page, device=dev)
    for layer in pools:
        for buf in layer.values():
            buf.copy_(torch.tensor(rng.normal(size=buf.shape), dtype=torch.float32))
    pos = np.array([13, 7, 20], np.int32)
    bt = np.full((3, 4), -1, np.int32)
    perm, c = rng.permutation(P), 0
    for b in range(3):
        need = -(-(int(pos[b]) + 4) // page)
        bt[b, :need] = perm[c : c + need]
        c += need
    F = cfg.d_ff
    pruned = {}
    for li, lp in enumerate(params["layers"]):
        slots = [ffn_lib.compact_ffn_params(
            lp["ffn"], torch.tensor(np.sort(rng.permutation(F)[: F // 2]), device=dev))
            for _ in range(3)]
        pruned[li] = {k: torch.stack([s[k] for s in slots]) for k in slots[0]}
    tok = rng.integers(0, cfg.vocab_size, size=(3, 1)).astype(np.int32)
    t = lambda a: torch.tensor(a, device=dev)  # noqa: E731
    inputs = (t(bt), t(tok), t(pos), t(np.array([2, 0, 3], np.int32)),
              t(np.array([True, True, False])))
    return cfg, params, pools, pruned, inputs


def test_draft_verify_round_fused_equals_plain(dev, monkeypatch):
    """One ``draft_verify_paged`` round (k_r = [2, 0, 3], slot 2 not live)
    through the attention kernel against the same round through its plain
    version, both on the card: equal drafts, verify logits within 1e-5,
    pools within 1e-5 except the trash page; the kernel counts its calls
    as decode and verify launches."""
    from repro_torch.kernels import paged_attn
    from repro_torch.models import decoder

    cfg, params, pools, pruned, inputs = _tinylm_round(dev)
    plain_pools = [{k: v.clone() for k, v in layer.items()} for layer in pools]
    before = (paged_attn.launches, paged_attn.verify_launches,
              paged_attn.prefill_launches)
    dk, lk, pk = decoder.draft_verify_paged(
        params, cfg, pools, *inputs, pruned, num_steps=3, spec_k=3,
        backend="fused")
    torch.cuda.synchronize()
    L = cfg.num_layers
    assert (paged_attn.launches - before[0], paged_attn.verify_launches - before[1],
            paged_attn.prefill_launches - before[2]) == (4 * L, L, 0)
    monkeypatch.setattr(ops, "paged_attention",
                        lambda *a, **k: ref.paged_attn_ref(*a, **k))
    dp, lp, pp = decoder.draft_verify_paged(
        params, cfg, plain_pools, *inputs, pruned, num_steps=3, spec_k=3,
        backend="fused")
    torch.cuda.synchronize()
    assert torch.equal(dk, dp)
    vm = inputs[4][:, None] & (torch.arange(4, device=dev)[None] <= inputs[3][:, None])
    torch.testing.assert_close(lk[vm], lp[vm], rtol=1e-5, atol=1e-5)
    for a, b in zip(pk, pp):
        for key in a:
            torch.testing.assert_close(a[key][:-1], b[key][:-1], rtol=1e-5, atol=1e-5)


def _tinylm_host_params():
    """tinylm drawn on the CPU (a CUDA generator draws other values),
    projection matrices scaled by 2 so that greedy streams vary."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder

    cfg = get_config("tinylm")
    params = decoder.init_params(cfg, seed=0, device="cpu")
    for lp in params["layers"]:
        for group in ("mixer", "ffn"):
            for k, v in lp[group].items():
                if k.startswith("w"):
                    v.mul_(2.0)
    return cfg, params


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_flocking_probe_leaves_fused_pools_bit_identical(dev, kv_dtype):
    """The probe's fused-kernel writes (and, int8, page re-encodes) are
    undone: every pool and scale pool is bit-identical around each probe,
    and the streams equal those with telemetry off."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.kernels import kv_quant
    from repro_torch.serving.server import PagedServer

    cfg, host = _tinylm_host_params()
    params = _to(host, dev)
    rng = np.random.default_rng(19)
    trace = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 10)
             for n in (13, 22, 17)]
    kw = dict(page_size=8, num_pages=48, n_slots=2, prefill_chunk=16,
              max_len=96, kernel_backend="fused", kv_dtype=kv_dtype,
              device=dev)
    outs, probes = {}, 0
    for every in (0, 2):
        srv = PagedServer(cfg, params, gcfg=GriffinConfig(sparsity=0.5),
                          flocking_every=every, **kw)
        if every:
            probe = srv._run_flocking_probe

            def checked(reqs, probe=probe, srv=srv):
                nonlocal probes
                before = [{k: kv_quant.as_bytes(v).clone() for k, v in p.items()}
                          for p in srv.pools]
                probe(reqs)
                torch.cuda.synchronize()
                probes += 1
                for b, p in zip(before, srv.pools):
                    for k in b:
                        assert torch.equal(b[k], kv_quant.as_bytes(p[k])), k

            srv._run_flocking_probe = checked
        for i, (p, m) in enumerate(trace):
            srv.submit(p, m, rid=i)
        outs[every] = srv.drain()
    assert outs[0] == outs[2]
    assert probes > 0 and srv.flocking.probes.value > 0


def test_launcher_on_card_equals_cpu(dev, tmp_path, capsys):
    """``launch.serve.main`` on the card returns the streams of the same
    call with ``--device cpu``, from one checkpoint the port wrote."""
    from repro_torch import bridge
    from repro_torch.checkpoint import checkpointer
    from repro_torch.launch import serve

    cfg, host = _tinylm_host_params()
    checkpointer.save(str(tmp_path), 1, {"params": bridge.params_to_jax(host, cfg)})
    base = ["--arch", "tinylm", "--requests", "4", "--max-len", "64",
            "--ckpt-dir", str(tmp_path)]
    for extra in ([], ["--kv-dtype", "int8", "--spec-k", "3"]):
        card = serve.main(base + extra + ["--device", "cuda"])
        cpu = serve.main(base + extra + ["--device", "cpu"])
        assert card == cpu and len({t for s in cpu.values() for t in s}) > 4
    assert "[device] cuda" in capsys.readouterr().out


def test_generation_engine_on_card_equals_cpu(dev):
    """``GenerationEngine`` with GRIFFIN 0.5 ``topk`` on the card: the
    greedy tokens of the same call on the CPU, one ``expert_stat`` launch
    per FF layer of the prefill."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.kernels import expert_stat
    from repro_torch.serving.engine import GenerationEngine

    cfg, host = _tinylm_host_params()
    prompts = np.random.default_rng(23).integers(0, cfg.vocab_size, (3, 20)) \
        .astype(np.int32)
    out = {}
    for d in (dev, torch.device("cpu")):
        eng = GenerationEngine(cfg, _to(host, d), GriffinConfig(sparsity=0.5),
                               max_len=48, device=d)
        before = expert_stat.launches
        out[d.type] = eng.generate(prompts, 16).cpu()
        launched = expert_stat.launches - before
        assert launched == (cfg.num_layers if d.type == "cuda" else 0)
    assert torch.equal(out["cuda"], out["cpu"])
    assert len(torch.unique(out["cpu"])) > 4


def test_moe_on_card_is_deterministic_and_equals_cpu(dev):
    """One MoE call (smoke Moonshot experts, 64 tokens) run twice on the
    card gives the same bits, bf16 and fp32 — the combine adds a token's
    contributions in a fixed order, no atomics — and the fp32 call is
    within 1e-5 of the CPU's; likewise ``moe_decode``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import param
    from repro_torch.models.layers import moe

    cfg = get_config("moonshot-v1-16b-a3b", smoke=True)
    host = param.init_params(moe.moe_specs(cfg), 0, "float32", "cpu")
    x = torch.tensor(np.random.default_rng(4).normal(size=(2, 32, cfg.d_model)),
                     dtype=torch.float32)
    want, aux_h, _ = moe.moe_forward(host, x, cfg)
    for dtype in (torch.float32, torch.bfloat16):
        # the router stays fp32 in a bf16 model, as its spec says
        card = {k: v.to(dev) if k == "router" else
                {n: w.to(dev, dtype) for n, w in v.items()} if isinstance(v, dict)
                else v.to(dev, dtype) for k, v in host.items()}
        xc = x.to(dev, dtype)
        y1, a1, _ = moe.moe_forward(card, xc, cfg)
        y2, a2, _ = moe.moe_forward(card, xc, cfg)
        assert torch.equal(y1, y2) and torch.equal(a1, a2)
        d1 = moe.moe_decode(card, None, xc[:, :1], cfg)
        assert torch.equal(d1, moe.moe_decode(card, None, xc[:, :1], cfg))
        if dtype == torch.float32:
            torch.testing.assert_close(y1.cpu(), want, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(a1.cpu(), aux_h, rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(
                d1.cpu(), moe.moe_decode(host, None, x[:, :1], cfg),
                rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v3-671b"])
def test_continuous_batcher_on_card_equals_cpu(dev, arch):
    """A smoke-config ``ContinuousBatcher`` (2 slots, 4 requests of mixed
    lengths, GRIFFIN 0.5) at fp32 gives the CPU's streams, with one
    ``expert_stat`` launch per prunable FF block of each insert."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.kernels import expert_stat
    from repro_torch.models import decoder
    from repro_torch.serving.engine import ContinuousBatcher

    cfg = get_config(arch, smoke=True)
    host = decoder.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(8)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((6, 3), (17, 6), (11, 4), (25, 5))]
    out = {}
    for d in (dev, torch.device("cpu")):
        cb = ContinuousBatcher(cfg, _to(host, d), n_slots=2, max_len=48,
                               gcfg=GriffinConfig(sparsity=0.5), device=d)
        for rid, (p, m) in enumerate(reqs):
            cb.submit(p, m, rid)
        before = expert_stat.launches
        out[d.type] = cb.run()
        n_ff = len(decoder.extract_ffn_tree(host, cfg))
        assert expert_stat.launches - before == (
            n_ff * len(reqs) if d.type == "cuda" else 0)
    assert out["cuda"] == out["cpu"]
    assert {k: len(v) for k, v in out["cpu"].items()} == {0: 3, 1: 6, 2: 4, 3: 5}
