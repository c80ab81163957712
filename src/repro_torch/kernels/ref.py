"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py`` for the kernels this slice carries).

They run for CPU tensors (the wrappers in ``kernels/ops.py`` dispatch on
the device) and serve as the oracle the CUDA kernels are held against on
the card (``chip_smoke.py``).
"""
from __future__ import annotations

import torch

NEG_INF = -2.0e38  # large finite negative (matches attention.py)


def expert_stat_ref(z: torch.Tensor) -> torch.Tensor:
    """Eq. 6 squared statistic: z [..., S, F] -> s_sq [..., F] fp32.

    ``s_sq[j] = sum_t z[t,j]^2 / ||z[t]||^2``; all-zero rows (padding)
    contribute 0."""
    sq = z.float().square()
    row = sq.sum(dim=-1, keepdim=True)
    inv = torch.where(row > 0, 1.0 / row, torch.zeros_like(row))
    return (sq * inv).sum(dim=-2)


def paged_gather_ref(pool: torch.Tensor,
                     block_tables: torch.Tensor) -> torch.Tensor:
    """Block-table page gather. pool [P, page, E]; block_tables [B, n]
    (negative entries clipped to page 0) -> [B, n, page, E]."""
    return pool[block_tables.clamp(min=0).long()]


def scatter_rows(pool_k: torch.Tensor, pool_v: torch.Tensor,
                 block_tables: torch.Tensor, positions: torch.Tensor,
                 write_mask: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> None:
    """Write new K/V rows into their pages, **in place**.

    Row ``[b, s]`` lands in page ``block_tables[b, positions[b,s] //
    page]`` at offset ``positions[b,s] % page``; rows with ``write_mask``
    False, or whose page is unallocated, go to the trash page (the last
    page of the pool).  Rows are cast to the pool dtype (bf16 pools
    round to nearest even)."""
    B, S, KV, hd = k_new.shape
    page = pool_k.shape[1]
    trash = pool_k.shape[0] - 1
    W = block_tables.shape[1]
    bt = block_tables.long()
    positions = positions.long()
    logical_page = positions // page
    offset = positions % page
    gp = torch.gather(bt, 1, logical_page.clamp(0, W - 1))
    ok = write_mask & (gp >= 0) & (logical_page < W)
    gp = torch.where(ok, gp, torch.full_like(gp, trash))
    gpf, off = gp.reshape(-1), offset.reshape(-1)
    pool_k[gpf, off] = k_new.reshape(B * S, KV, hd).to(pool_k.dtype)
    pool_v[gpf, off] = v_new.reshape(B * S, KV, hd).to(pool_v.dtype)


def paged_attn_ref(
    q: torch.Tensor,            # [B, S, H, hd]
    k_new: torch.Tensor,        # [B, S, KV, hd]
    v_new: torch.Tensor,        # [B, S, KV, hd]
    pool_k: torch.Tensor,       # [P+1, page, KV, hd] fp32 or bf16
    pool_v: torch.Tensor,       # [P+1, page, KV, hd]
    block_tables: torch.Tensor, # [B, W] int32, -1 = unallocated
    pos: torch.Tensor,          # [B] int32
    write_mask: torch.Tensor,   # [B, S] bool
    window: int = 0,
):
    """Gather-then-attend version of the fused ``paged_attn`` kernel:
    scatter the new K/V (masked rows -> trash page), materialize every
    request's full page view, masked softmax over every position.

    The pools are updated **in place** (the reference returns new
    arrays).  Returns ``(ctx [B,S,H,hd] fp32, pool_k, pool_v)``."""
    B, S, H, hd = q.shape
    KV = k_new.shape[2]
    G = H // KV
    page = pool_k.shape[1]
    W = block_tables.shape[1]
    dev = q.device
    positions = pos.long()[:, None] + torch.arange(S, device=dev)[None, :]
    scatter_rows(pool_k, pool_v, block_tables, positions, write_mask,
                 k_new, v_new)
    C = W * page
    # attention math always in fp32 (bf16 pools round on write, upcast
    # on read — the same as the kernel)
    k_cache = paged_gather_ref(pool_k.reshape(pool_k.shape[0], page, KV * hd),
                               block_tables).reshape(B, C, KV, hd).float()
    v_cache = paged_gather_ref(pool_v.reshape(pool_v.shape[0], page, KV * hd),
                               block_tables).reshape(B, C, KV, hd).float()
    scale = 1.0 / (hd ** 0.5)
    qg = q.float().reshape(B, S, KV, G, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k_cache) * scale
    kpos = torch.arange(C, device=dev)[None, None, :]
    qpos = positions[:, :, None]
    valid = kpos <= qpos
    if window:
        valid &= kpos > qpos - window
    page_alloc = (block_tables >= 0)[:, :, None].expand(B, W, page)
    valid &= page_alloc.reshape(B, 1, C)
    scores = torch.where(valid[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bkgqs,bskh->bqkgh", probs, v_cache)
    return ctx.reshape(B, S, H, hd), pool_k, pool_v
