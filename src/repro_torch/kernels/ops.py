"""Public kernel wrappers (port of ``repro/kernels/ops.py``).

Each dispatches on the device of its tensors: a CUDA tensor launches the
hand-written kernel (or raises), a CPU tensor runs the plain version in
``kernels/ref.py``.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend, kv_quant, ref
from repro_torch.kernels.expert_stat import expert_stat as _expert_stat
from repro_torch.kernels.glu_ffn import glu_ffn as _glu_ffn
from repro_torch.kernels.griffin_ffn import griffin_ffn as _griffin_ffn
from repro_torch.kernels.paged_attn import paged_attn as _paged_attn
from repro_torch.kernels.paged_gather import paged_gather as _paged_gather


def griffin_ffn_decode(x, wg, w1, w2, block_ids, *, block_size: int = 128,
                       activation: str = "swiglu"):
    """Zero-copy pruned decode FF over the selected neuron blocks.
    x [B, D]; wg/w1/w2 [F, D] neuron rows; block_ids [nb] sorted ->
    [B, D] fp32 (see ``kernels/griffin_ffn.py``)."""
    if backend.is_cuda(x, "griffin_ffn_decode"):
        return _griffin_ffn(x, wg, w1, w2, block_ids, block_size=block_size,
                            activation=activation)
    return ref.griffin_ffn_ref(x, wg, w1, w2, block_ids, block_size,
                               activation=activation)


def glu_ffn_forward(x, wg, w1, w2, *, activation: str = "swiglu"):
    """Dense GLU FF forward. x [S, D]; wg/w1 [D, F]; w2 [F, D] -> [S, D]
    fp32 (see ``kernels/glu_ffn.py``)."""
    if backend.is_cuda(x, "glu_ffn_forward"):
        return _glu_ffn(x, wg, w1, w2, activation=activation)
    return ref.glu_ffn_ref(x, wg, w1, w2, activation=activation)


def griffin_stat(z: torch.Tensor) -> torch.Tensor:
    """Eq. 6 statistic. z: [S, F] -> [F] or [B, S, F] -> [B, F], fp32."""
    if backend.is_cuda(z, "griffin_stat"):
        return _expert_stat(z.contiguous())
    return ref.expert_stat_ref(z)


def paged_gather(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Block-table page gather. pool [P, page, E]; bt [B, n] -> [B, n, page, E]
    (unallocated entries read page 0; the attention mask hides them)."""
    bt = block_tables.clamp(min=0).to(torch.int32).contiguous()
    if backend.is_cuda(pool, "paged_gather"):
        return _paged_gather(pool.contiguous(), bt)
    return ref.paged_gather_ref(pool, bt)


def paged_kv_gather(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """KV-shaped wrapper: pool [P, page, KV, hd] -> [B, n*page, KV, hd]."""
    P, page, KV, hd = pool.shape
    B, n = block_tables.shape
    out = paged_gather(pool.reshape(P, page, KV * hd), block_tables)
    return out.reshape(B, n * page, KV, hd)


def paged_attention(q, k_new, v_new, pool_k, pool_v, block_tables, pos,
                    write_mask, *, scale_k=None, scale_v=None,
                    kv_dtype: str = "fp32", window: int = 0):
    """Fused paged-attention step: K/V scatter + online-softmax attention
    over the pages each request owns.  Returns ``(ctx [B,S,H,hd] fp32,
    pool_k, pool_v)`` with the pools updated in place; for ``kv_dtype``
    int8/fp8 the scale pools go in and come back too, appended as
    ``(scale_k, scale_v)``, also updated in place."""
    kv_quant.resolve_kv_dtype(kv_dtype)
    kw = {}
    if kv_quant.is_quantized(kv_dtype):
        kw = dict(scale_k=scale_k, scale_v=scale_v, kv_dtype=kv_dtype)
    if backend.is_cuda(q, "paged_attention"):
        return _paged_attn(q, k_new, v_new, pool_k, pool_v, block_tables,
                           pos, write_mask, window=window, **kw)
    return ref.paged_attn_ref(q, k_new, v_new, pool_k, pool_v, block_tables,
                              pos, write_mask, window=window, **kw)
