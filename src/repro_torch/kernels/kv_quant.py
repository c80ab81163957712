"""Page-boundary KV quantization (port of ``repro/kernels/kv_quant.py``):
the quantize/dequantize program and the byte accounting.

``kv_dtype`` picks how the paged KV pools hold their bytes:

* ``fp32`` — the pool inherits the model dtype (float32 for tinylm,
  bfloat16 for Yi-9B): the unquantized pools.
* ``bf16`` — bfloat16 pages, no scales: the scatter rounds rows to bf16
  (round to nearest even), attention upcasts to fp32.
* ``int8`` / ``fp8`` (``float8_e4m3fn``) — quantized pages behind a
  parallel fp32 *scale pool* per data pool, one scale per page per KV
  head, shape ``[P+1, 1, KV, 1]``, addressed by the same block table.

Only the attention kernel and its plain version see quantized bytes:
the allocator, the prefix cache and copy-on-write treat pages as opaque,
and ``decoder.copy_pool_pages`` copies the scale leaves with their pages.

The program (identical float ops in the CUDA kernel, the gather path and
``kernels/ref.py``, so all three agree bit for bit on pool contents):

* per (page, kv head) absmax scale, **monotone**: on scatter
  ``s_new = max(s_old, absmax(new rows) * (1/qmax))`` — a reciprocal
  multiply, as the reference writes it — so old rows re-encode by
  dividing by a larger scale and never clip;
* the page's old rows are re-encoded under the new scale,
  ``quantize(bits * s_old / max(s_new, EPS))``: exact when the scale did
  not change, one extra rounding when it grew;
* attention runs in fp32 over ``bits * scale``.

A page's scale is never reset when the page is reallocated: the new
owner's rows are encoded under ``max(previous scale, amax/qmax)``, as in
the reference server.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.param import torch_dtype

KV_DTYPES = ("fp32", "bf16", "int8", "fp8")

#: guards division by a zero scale (page never written); kernel and
#: plain version use the same constant for bit parity
EPS = 1e-8

#: documented max absolute context error vs the fp32 plain version for
#: quantized pools on unit-Gaussian K/V
ERROR_BUDGET = {"int8": 0.05, "fp8": 0.12}

#: committed floor for the greedy token-match rate vs an fp32-pool server
#: on the reference's trained tiny model
TOKEN_MATCH_FLOOR = {"int8": 0.85, "fp8": 0.80}


def resolve_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    return kv_dtype


def is_quantized(kv_dtype: str) -> bool:
    return kv_dtype in ("int8", "fp8")


def pool_torch_dtype(kv_dtype: str, model_dtype) -> torch.dtype:
    """Concrete page dtype.  ``fp32`` inherits the model dtype."""
    resolve_kv_dtype(kv_dtype)
    if kv_dtype == "fp32":
        return torch_dtype(model_dtype)
    return {"bf16": torch.bfloat16, "int8": torch.int8,
            "fp8": torch.float8_e4m3fn}[kv_dtype]


def qmax(kv_dtype: str) -> float:
    """Largest representable quantized magnitude (scale denominator)."""
    return {"int8": 127.0, "fp8": 448.0}[kv_dtype]


def quantize(x: torch.Tensor, s_eff: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """fp32 values -> quantized bits under the (EPS-guarded) scale.

    int8 rounds half to even and clips to +-127; fp8 rounds to nearest
    even.  ``s_eff >= absmax(x)/qmax`` by the monotone construction, so
    the clip only pins float round-off at the boundary."""
    v = x.float() / s_eff
    if kv_dtype == "int8":
        return torch.clamp(torch.round(v), -127.0, 127.0).to(torch.int8)
    return v.to(torch.float8_e4m3fn)


def dequantize(bits: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return bits.float() * s


def new_scale(s_old: torch.Tensor, amax_new: torch.Tensor,
              kv_dtype: str) -> torch.Tensor:
    """Monotone per-(page, head) scale update.  Multiplies by the
    reciprocal (rounded to fp32, as the reference's weakly typed
    constant is) rather than dividing."""
    return torch.maximum(s_old, amax_new * (1.0 / qmax(kv_dtype)))


def quantize_scatter_ref(
    pool: torch.Tensor,    # [P+1, page, KV, hd] quantized bits
    scale: torch.Tensor,   # [P+1, 1, KV, 1] fp32
    gp: torch.Tensor,      # [N] destination page per new row
    offset: torch.Tensor,  # [N] slot within the page
    rows: torch.Tensor,    # [N, KV, hd] new rows (any float dtype)
    kv_dtype: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain quantized scatter (the plain version's and the gather
    path's side of the kernel's program).  Re-encodes the whole pool
    under the updated scales — a no-op wherever a scale did not change —
    then writes the new rows.  Returns new ``(bits, scales)``; the
    inputs are left as they were."""
    rows_f = rows.float()
    P1, _, KV, _ = pool.shape
    gp, offset = gp.long(), offset.long()
    amax = torch.zeros((P1, KV), dtype=torch.float32, device=pool.device)
    amax.scatter_reduce_(0, gp[:, None].expand(-1, KV),
                         rows_f.abs().amax(dim=-1), "amax", include_self=True)
    s_new = new_scale(scale[:, 0, :, 0], amax, kv_dtype)  # [P+1, KV]
    s_eff = torch.clamp_min(s_new, EPS)
    requant = quantize(dequantize(pool, scale), s_eff[:, None, :, None],
                       kv_dtype)
    new_bits = quantize(rows_f, s_eff[gp][:, :, None], kv_dtype)
    as_bytes(requant)[gp, offset] = as_bytes(new_bits)
    return requant, s_new[:, None, :, None]


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """fp8 tensors viewed as uint8 (same bits) for indexing and
    comparison, which PyTorch does not implement for every float8 op;
    other dtypes as they are."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def gather_scales(scale: torch.Tensor, block_tables: torch.Tensor,
                  page_size: int) -> torch.Tensor:
    """[P+1, 1, KV, 1] scales -> [B, n*page, KV, 1] aligned with the
    gathered page view (one scale repeated across a page's slots)."""
    s = scale[:, 0, :, 0][block_tables.clamp(min=0).long()]  # [B, n, KV]
    return s.repeat_interleave(page_size, dim=1)[..., None]


# ---------------------------------------------------------------------------
# Byte accounting (serving metrics)
# ---------------------------------------------------------------------------

def kv_itemsize(kv_dtype: str, model_dtype) -> int:
    return torch.empty((), dtype=pool_torch_dtype(kv_dtype, model_dtype)
                       ).element_size()


def scale_bytes_per_page(kv_dtype: str, kv_heads: int) -> int:
    """fp32 scale bytes one page carries across both scale pools."""
    return 2 * kv_heads * 4 if is_quantized(kv_dtype) else 0


def page_bytes(page_size: int, kv_heads: int, head_dim: int,
               kv_dtype: str, model_dtype="float32") -> int:
    """Total pool bytes one page occupies (K + V data + scales)."""
    data = 2 * page_size * kv_heads * head_dim * kv_itemsize(
        kv_dtype, model_dtype
    )
    return data + scale_bytes_per_page(kv_dtype, kv_heads)
