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
step at small batch still fills the card; when there is more than one,
a second launch merges the splits' partial softmax states in order.

Write-back differs from the TPU body on purpose: the Pallas kernel
rewrites every visited page, which is safe only because TPU grid steps
run in order.  Here CTAs run concurrently, so only the slots that
received new rows are written, and by one CTA per ``(b, kv)``.  By the
copy-on-write contract (``serving/paged.py``) those pages belong to the
writing request alone; read-only shared pages and the trash page are
never written.  Masked rows are not written at all (the plain version
sends them to the trash page, which no reader attends).

Quantized pools (``kv_dtype`` int8/fp8, scale pools ``[P+1, 1, KV, 1]``
fp32) take two launches in this order on the stream: the scatter, one
CTA per (request, page receiving rows, kv head), grows the page's scale
and re-encodes the whole page (``kernels/kv_quant.py``), and only then
does attention read ``bits * scale``, so no CTA reads a page while it is
re-encoded.

CUDA tensors only; ``ops.paged_attention`` dispatches CPU tensors to
``ref.paged_attn_ref``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import backend, kv_quant

#: launches since the last reset (one per wrapper call): fp32/bf16
#: pools, and quantized (int8/fp8) pools
launches = 0
launches_quant = 0

#: largest head_dim the kernel's shared-memory tiles are sized for
MAX_HEAD_DIM = 256

#: query rows of one CTA (``kRows`` in ``csrc/paged_attn.cu``)
ROWS_PER_CTA = 16

#: CTAs per SM the page split aims at (a CTA holds ~34 KB of shared
#: memory at hd=128, page 16, so several fit beside each other)
CTAS_PER_SM = 2


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
    global launches, launches_quant
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
    backend.require(hd <= MAX_HEAD_DIM, what, f"head_dim {hd} > {MAX_HEAD_DIM}")
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
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty((B, KV, splits, SG, hd), dtype=torch.float32,
                               device=dev)
        part_ml = torch.empty((B, KV, splits, SG, 2), dtype=torch.float32,
                              device=dev)
    common = (B, S, H, KV, hd, page, W, int(window), 1.0 / math.sqrt(hd),
              pps, splits, int(q.dtype == torch.bfloat16))
    ptrs = (qc.data_ptr(), knc.data_ptr(), vnc.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr())
    tail = (bt.data_ptr(), pos32.data_ptr(), wm.data_ptr(), ctx.data_ptr(),
            None if part_acc is None else part_acc.data_ptr(),
            None if part_ml is None else part_ml.data_ptr())
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
    if quantized:
        launches_quant += 1
    else:
        launches += 1
    return outs


def page_splits(W: int, ctas: int, n_sm: int):
    """``(pages_per_split, splits)``: cut the ``W`` block-table columns
    into ranges so that ``ctas`` (b, kv, row tile) triples times
    ``splits`` come to about ``CTAS_PER_SM`` per SM.  Pages past a
    request's count leave their split empty, so the choice needs no host
    sync."""
    splits = max(1, min(W, -(-CTAS_PER_SM * n_sm // ctas)))
    pps = max(1, -(-W // splits))
    return pps, max(1, -(-W // pps))
