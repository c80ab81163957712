"""Plain PyTorch versions of the port's kernels (port of
``repro/kernels/ref.py``).

They run for CPU tensors (the wrappers in ``kernels/ops.py`` dispatch on
the device) and serve as the oracle the CUDA kernels are held against on
the card (``chip_smoke.py``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import kv_quant
from repro_torch.models.common import activation_fn

NEG_INF = -2.0e38  # large finite negative (matches attention.py)


def _act(name: str):
    """GLU activations of the FF kernels (geglu: tanh-approximate gelu)."""
    if name not in ("swiglu", "geglu", "reglu"):
        raise ValueError(f"activation must be swiglu|geglu|reglu, got {name!r}")
    return activation_fn(name)


def griffin_ffn_ref(
    x: torch.Tensor,          # [B, D]
    wg: torch.Tensor,         # [F, D] (neuron rows)
    w1: torch.Tensor,         # [F, D]
    w2: torch.Tensor,         # [F, D]
    block_ids: torch.Tensor,  # [nb] int32, block granularity
    block_size: int,
    activation: str = "swiglu",
) -> torch.Tensor:
    """GRIFFIN decode FF: ``act(x Wg^T) * (x W1^T) @ W2`` over the
    selected neuron blocks only.  Returns fp32 [B, D].

    A block id outside ``[0, F / block_size)`` is a block that adds
    nothing, as in both kernel paths: its rows are read clamped in range
    and its z columns are zero.  Such ids lie outside the
    contract: selection never makes them, and the TPU reference clamps
    them (its ``jnp`` gather), so no parity test covers them."""
    ids = block_ids.long()
    nblk = wg.shape[0] // block_size
    ok = ((ids >= 0) & (ids < nblk)).repeat_interleave(block_size)
    idx = (ids.clamp(0, nblk - 1)[:, None] * block_size
           + torch.arange(block_size, device=ids.device)[None, :]).reshape(-1)
    wg_s, w1_s, w2_s = wg[idx], w1[idx], w2[idx]
    g = x @ wg_s.T
    h = x @ w1_s.T
    z = torch.where(ok, _act(activation)(g) * h, 0)  # bad blocks add 0
    return (z @ w2_s).float()


def glu_ffn_ref(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor, activation: str = "swiglu") -> torch.Tensor:
    """Dense GLU FF forward. x [S, D]; wg/w1 [D, F]; w2 [F, D] -> fp32."""
    z = _act(activation)(x @ wg) * (x @ w1)
    return (z @ w2).float()


def expert_stat_ref(z: torch.Tensor) -> torch.Tensor:
    """Eq. 6 squared statistic: z [..., S, F] -> s_sq [..., F] fp32.

    ``s_sq[j] = sum_t z[t,j]^2 / ||z[t]||^2``; all-zero rows (padding)
    contribute 0."""
    sq = z.float().square()
    return _stat_from_sq(sq, sq.sum(dim=-1))


def _stat_from_sq(sq: torch.Tensor, row_sq: torch.Tensor) -> torch.Tensor:
    """``sum_t sq[t] / row_sq[t]`` over rows with ``row_sq > 0``: sq
    [..., S, F] fp32, row_sq [..., S] -> [..., F]."""
    row = row_sq[..., None]
    inv = torch.where(row > 0, 1.0 / row, torch.zeros_like(row))
    return (sq * inv).sum(dim=-2)


def expert_stat_row_sq_ref(z: torch.Tensor) -> torch.Tensor:
    """Squared row norms: z [..., S, F] -> [..., S] fp32 (step 1 of the
    tensor-parallel statistic: a rank's partial sums over its columns)."""
    return z.float().square().sum(dim=-1)


def expert_stat_from_norm_ref(z: torch.Tensor, row_sq: torch.Tensor) -> torch.Tensor:
    """The statistic from given squared row norms (step 2; under tensor
    parallelism ``row_sq`` is summed over the ranks first): z [..., S, F],
    row_sq [..., S] -> [..., F] fp32, rows with norm <= 0 contributing 0."""
    return _stat_from_sq(z.float().square(), row_sq)


def paged_gather_ref(pool: torch.Tensor,
                     block_tables: torch.Tensor) -> torch.Tensor:
    """Block-table page gather. pool [P, page, E]; block_tables [B, n]
    (negative entries clipped to page 0) -> [B, n, page, E]."""
    idx = block_tables.clamp(min=0).long()
    return kv_quant.as_bytes(pool)[idx].view(pool.dtype)


def scatter_rows(pool_k: torch.Tensor, pool_v: torch.Tensor,
                 block_tables: torch.Tensor, positions: torch.Tensor,
                 write_mask: torch.Tensor, k_new: torch.Tensor,
                 v_new: torch.Tensor, *, scale_k: torch.Tensor = None,
                 scale_v: torch.Tensor = None, kv_dtype: str = "fp32") -> None:
    """Write new K/V rows into their pages, **in place**.

    Row ``[b, s]`` lands in page ``block_tables[b, positions[b,s] //
    page]`` at offset ``positions[b,s] % page``; rows with ``write_mask``
    False, or whose page is unallocated, go to the trash page (the last
    page of the pool).  Rows are cast to the pool dtype (bf16 pools
    round to nearest even); quantized pools (``kv_dtype`` int8/fp8) run
    ``kv_quant.quantize_scatter_ref`` and update their scale pools too."""
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
    rows_k, rows_v = k_new.reshape(B * S, KV, hd), v_new.reshape(B * S, KV, hd)
    if not kv_quant.is_quantized(kv_dtype):
        pool_k[gpf, off] = rows_k.to(pool_k.dtype)
        pool_v[gpf, off] = rows_v.to(pool_v.dtype)
        return
    for pool, scale, rows in ((pool_k, scale_k, rows_k),
                              (pool_v, scale_v, rows_v)):
        bits, s_new = kv_quant.quantize_scatter_ref(pool, scale, gpf, off,
                                                    rows, kv_dtype)
        kv_quant.as_bytes(pool).copy_(kv_quant.as_bytes(bits))
        scale.copy_(s_new)


def paged_view(pool: torch.Tensor, scale, block_tables: torch.Tensor,
               gather=None) -> torch.Tensor:
    """Every request's pages as fp32 rows: pool [P+1, page, KV, hd] ->
    [B, n*page, KV, hd], dequantized (``bits * scale``) when ``scale`` is
    given.  ``gather`` is the page gather to use (default: the plain
    one)."""
    P1, page, KV, hd = pool.shape
    B, n = block_tables.shape
    if gather is None:
        flat = paged_gather_ref(pool.reshape(P1, page, KV * hd), block_tables)
        rows = flat.reshape(B, n * page, KV, hd)
    else:
        rows = gather(pool, block_tables)
    if scale is None:
        return rows.float()
    return kv_quant.dequantize(
        rows, kv_quant.gather_scales(scale, block_tables, page))


def paged_attn_ref(
    q: torch.Tensor,            # [B, S, H, hd]
    k_new: torch.Tensor,        # [B, S, KV, hd]
    v_new: torch.Tensor,        # [B, S, KV, hd]
    pool_k: torch.Tensor,       # [P+1, page, KV, hd]
    pool_v: torch.Tensor,       # [P+1, page, KV, hd]
    block_tables: torch.Tensor, # [B, W] int32, -1 = unallocated
    pos: torch.Tensor,          # [B] int32
    write_mask: torch.Tensor,   # [B, S] bool
    window: int = 0,
    *,
    scale_k: torch.Tensor = None,  # [P+1, 1, KV, 1] fp32 (quantized pools)
    scale_v: torch.Tensor = None,
    kv_dtype: str = "fp32",
):
    """Gather-then-attend version of the fused ``paged_attn`` kernel:
    scatter the new K/V (masked rows -> trash page), materialize every
    request's full page view, masked softmax over every position.  For
    ``kv_dtype`` int8/fp8 the scatter runs the page-boundary quantization
    program (``kernels/kv_quant.py``) and attention reads ``bits * scale``
    in fp32.

    The pools (and scale pools) are updated **in place** (the reference
    returns new arrays).  Returns ``(ctx [B,S,H,hd] fp32, pool_k,
    pool_v)`` and, when quantized, ``scale_k, scale_v`` after them."""
    quantized = kv_quant.is_quantized(kv_dtype)
    if quantized and (scale_k is None or scale_v is None):
        raise ValueError(f"kv_dtype={kv_dtype!r} needs scale_k and scale_v")
    B, S, H, hd = q.shape
    KV = k_new.shape[2]
    G = H // KV
    page = pool_k.shape[1]
    W = block_tables.shape[1]
    dev = q.device
    positions = pos.long()[:, None] + torch.arange(S, device=dev)[None, :]
    scatter_rows(pool_k, pool_v, block_tables, positions, write_mask,
                 k_new, v_new, scale_k=scale_k, scale_v=scale_v,
                 kv_dtype=kv_dtype)
    C = W * page
    # attention math always in fp32 (bf16 pools round on write, upcast
    # on read; quantized pools read bits * scale — the same as the kernel)
    k_cache = paged_view(pool_k, scale_k if quantized else None, block_tables)
    v_cache = paged_view(pool_v, scale_v if quantized else None, block_tables)
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
    ctx = ctx.reshape(B, S, H, hd)
    if quantized:
        return ctx, pool_k, pool_v, scale_k, scale_v
    return ctx, pool_k, pool_v
