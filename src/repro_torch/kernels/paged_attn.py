"""Wrapper of the fused paged-attention kernel (``csrc/paged_attn.cu``),
which replaces the TPU kernel ``repro/kernels/paged_attn.py::paged_attn``
for fp32/bf16 pools and for quantized (int8 / fp8 e4m3) pools.

One call per attention layer and step: the step's new K/V rows are
merged into the pages they land in (positions ``pos[b] + s`` with
``write_mask[b, s]`` set) and causal, optionally sliding-window, GQA
attention runs with an online softmax over only the ``num_pages[b] =
min(ceil((pos[b]+S)/page), allocated[b])`` pages each request owns,
which the kernel counts from the block table itself (no host sync).
Each request's pages are cut into splits (``page_splits``) so a decode
step at small batch still fills the card; the splits of one (request,
kv head, row tile) run as one thread block cluster and merge their
partial softmax states in split order through distributed shared
memory, inside the same launch.

Write-back differs from the TPU body on purpose: the Pallas kernel
rewrites every visited page, which is safe only because TPU grid steps
run in order.  Here CTAs run concurrently, so only the slots that
received new rows are written, and by one CTA per ``(b, kv)``.  By the
copy-on-write contract (``serving/paged.py``) those pages belong to the
writing request alone; read-only shared pages and the trash page are
never written.  Masked rows are not written at all (the plain version
sends them to the trash page, which no reader attends).

Quantized pools (``kv_dtype`` int8/fp8, scale pools ``[P+1, 1, KV, 1]``
fp32) grow a page's scale and re-encode the whole page
(``kernels/kv_quant.py``) when it receives rows.  When a step's query
rows fit one row tile (every decode step) only one CTA reads such a page,
and it re-encodes the page inside the attention launch; otherwise
(quantized prefill) a scatter launch, one CTA per (request, page
receiving rows, kv head), runs first, so no CTA reads a page while it is
re-encoded.

CUDA tensors only; ``ops.paged_attention`` dispatches CPU tensors to
``ref.paged_attn_ref``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch

from repro_torch.kernels import backend, kv_quant

#: calls since the last reset (one per wrapper call): fp32/bf16 pools,
#: and quantized (int8/fp8) pools; of those, the speculative verify calls
#: (made inside ``counting_as("verify")``) and the other prefill calls
#: (S > 1) apart, so decode calls are the difference
launches = 0
launches_quant = 0
prefill_launches = 0
prefill_launches_quant = 0
verify_launches = 0
verify_launches_quant = 0

#: the kind the calls made now are counted as (None: by their shape)
_counting: Optional[str] = None


@contextlib.contextmanager
def counting_as(kind: str) -> Iterator[None]:
    """Count the calls made inside as ``kind`` ("verify"): a verify call
    ``[n_slots, k+1]`` has the shape of a short prefill chunk, so only its
    caller can tell them apart.  A host-side flag, no sync."""
    global _counting
    if kind != "verify":
        raise ValueError(f"counting_as: unknown kind {kind!r}")
    prev, _counting = _counting, kind
    try:
        yield
    finally:
        _counting = prev

#: largest head_dim the kernel's registers are sized for (4 features a
#: lane in P.V, 8 mma k-steps)
MAX_HEAD_DIM = 128

#: query rows of one CTA; the C entry points refuse any other value, so
#: this cannot drift from ``kRows`` in ``csrc/paged_attn.cu``
ROWS_PER_CTA = 64

#: CTAs per SM the page split aims at (a CTA keeps 8 pages in flight and
#: holds 70-175 KB of shared memory at hd=128, page 16)
CTAS_PER_SM = 1

#: fewest pages a split is cut to: one round of the kernel's ring (a page
#: per warp)
MIN_PAGES_PER_SPLIT = 4

#: most splits: the splits of a row tile are one thread block cluster, at
#: most the portable cluster size (``kMaxSplits`` in the kernel)
MAX_SPLITS = 8


def paged_attn(
    q: torch.Tensor,             # [B, S, H, hd] (rope applied)
    k_new: torch.Tensor,         # [B, S, KV, hd]
    v_new: torch.Tensor,         # [B, S, KV, hd]
    pool_k: torch.Tensor,        # [P+1, page, KV, hd] fp32/bf16/int8/fp8
    pool_v: torch.Tensor,        # [P+1, page, KV, hd]
    block_tables: torch.Tensor,  # [B, W] int32 page ids, -1 = unallocated
    pos: torch.Tensor,           # [B] int32 tokens already cached
    write_mask: torch.Tensor,    # [B, S] bool
    *,
    window: int = 0,
    scale_k: Optional[torch.Tensor] = None,  # [P+1, 1, KV, 1] fp32
    scale_v: Optional[torch.Tensor] = None,
    kv_dtype: str = "fp32",
):
    """Fused scatter + paged attention.  Returns ``(ctx [B,S,H,hd] fp32,
    pool_k, pool_v)`` and, for ``kv_dtype`` int8/fp8, ``scale_k,
    scale_v`` after them; pools and scale pools are updated in place.

    Contract (the server's block tables satisfy both): tables are
    prefix-allocated, and a page written this step is owned by its
    request alone."""
    global launches, launches_quant, prefill_launches, prefill_launches_quant
    global verify_launches, verify_launches_quant
    what = "paged_attn"
    quantized = kv_quant.is_quantized(kv_dtype)
    dev = backend.same_cuda_device(what, q, k_new, v_new, pool_k, pool_v,
                                   block_tables, pos, write_mask)
    backend.require(q.ndim == 4 and k_new.ndim == 4 and v_new.ndim == 4,
                    what, "q, k_new, v_new must be 4-D")
    B, S, H, hd = q.shape
    KV = k_new.shape[2]
    backend.require(tuple(k_new.shape) == (B, S, KV, hd)
                    and tuple(v_new.shape) == (B, S, KV, hd), what,
                    f"k_new/v_new must be {(B, S, KV, hd)}")
    backend.require(KV > 0 and H % KV == 0, what, f"H={H} not a multiple of KV={KV}")
    backend.require(4 <= hd <= MAX_HEAD_DIM and hd & (hd - 1) == 0, what,
                    f"head_dim {hd} must be a power of two in [4, {MAX_HEAD_DIM}]")
    backend.require(pool_k.ndim == 4 and pool_k.shape == pool_v.shape, what,
                    "pools must be matching [P+1, page, KV, hd]")
    P1, page, KVp, hdp = pool_k.shape
    backend.require((KVp, hdp) == (KV, hd), what,
                    f"pool heads {(KVp, hdp)} != {(KV, hd)}")
    if quantized:
        want = kv_quant.pool_torch_dtype(kv_dtype, "float32")
        backend.require(pool_k.dtype == pool_v.dtype == want, what,
                        f"{kv_dtype} pools must be {want}, got {pool_k.dtype}")
        backend.require(scale_k is not None and scale_v is not None, what,
                        f"kv_dtype={kv_dtype} needs scale_k and scale_v")
        backend.same_cuda_device(what, q, scale_k, scale_v)
        for sc in (scale_k, scale_v):
            backend.require(tuple(sc.shape) == (P1, 1, KV, 1)
                            and sc.dtype == torch.float32
                            and sc.is_contiguous(), what,
                            f"scale pools must be contiguous float32 "
                            f"{(P1, 1, KV, 1)}")
    else:
        backend.require(pool_k.dtype == pool_v.dtype
                        and pool_k.dtype in (torch.float32, torch.bfloat16),
                        what, f"pools must be float32 or bfloat16, got "
                        f"{pool_k.dtype}")
    backend.require(pool_k.is_contiguous() and pool_v.is_contiguous(), what,
                    "pools must be contiguous (they are written in place)")
    backend.require(block_tables.ndim == 2 and block_tables.shape[0] == B,
                    what, "block_tables must be [B, W]")
    backend.require(tuple(pos.shape) == (B,), what, "pos must be [B]")
    backend.require(tuple(write_mask.shape) == (B, S)
                    and write_mask.dtype == torch.bool, what,
                    "write_mask must be [B, S] bool")
    backend.require(q.dtype == k_new.dtype == v_new.dtype
                    and q.dtype in (torch.float32, torch.bfloat16), what,
                    f"q/k_new/v_new must share a float32 or bfloat16 dtype")
    W = block_tables.shape[1]
    # already contiguous int32/bool on the serving path: no launches here
    qc, knc, vnc = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    bt = block_tables.to(torch.int32).contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    wm = write_mask.contiguous().view(torch.uint8)
    ctx = torch.empty((B, S, H, hd), dtype=torch.float32, device=dev)
    outs = (ctx, pool_k, pool_v) + ((scale_k, scale_v) if quantized else ())
    if B * S * H == 0:
        return outs
    SG = S * (H // KV)
    pps, splits = page_splits(
        W, B * KV * -(-SG // ROWS_PER_CTA),
        torch.cuda.get_device_properties(dev).multi_processor_count)
    common = (B, S, H, KV, hd, page, W, int(window), 1.0 / math.sqrt(hd),
              pps, splits, ROWS_PER_CTA, int(q.dtype == torch.bfloat16))
    ptrs = (qc.data_ptr(), knc.data_ptr(), vnc.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr())
    tail = (bt.data_ptr(), pos32.data_ptr(), wm.data_ptr(), ctx.data_ptr())
    with torch.cuda.device(dev):
        if quantized:
            err = backend.lib().paged_attn_quant(
                *ptrs, scale_k.data_ptr(), scale_v.data_ptr(), *tail, *common,
                int(kv_dtype == "fp8"), 1.0 / kv_quant.qmax(kv_dtype),
                kv_quant.EPS, backend.stream_of(q))
        else:
            err = backend.lib().paged_attn(
                *ptrs, *tail, *common, int(pool_k.dtype == torch.bfloat16),
                backend.stream_of(q))
    backend.check(err, what)
    verify = _counting == "verify"
    prefill = S > 1 and not verify
    if quantized:
        launches_quant += 1
        verify_launches_quant += verify
        prefill_launches_quant += prefill
    else:
        launches += 1
        verify_launches += verify
        prefill_launches += prefill
    return outs


def page_splits(W: int, ctas: int, n_sm: int):
    """``(pages_per_split, splits)``: cut the ``W`` block-table columns
    into ranges so that ``ctas`` (b, kv, row tile) triples times
    ``splits`` come to about ``CTAS_PER_SM`` per SM, but no range is cut
    below ``MIN_PAGES_PER_SPLIT`` pages (a CTA keeps a round of pages in
    flight, so fewer, longer splits pay the prologue and the merge less
    often) and there are at most ``MAX_SPLITS`` (one cluster).  Pages past
    a request's count leave their split empty, so the choice needs no
    host sync."""
    splits = max(1, min(W // MIN_PAGES_PER_SPLIT, MAX_SPLITS,
                        -(-CTAS_PER_SM * n_sm // ctas)))
    pps = max(1, -(-W // splits))
    return pps, max(1, -(-W // pps))
