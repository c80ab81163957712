"""KV page byte formats (the part of ``repro/kernels/kv_quant.py`` this
slice needs: dtype resolution and byte accounting).

``kv_dtype`` picks how the paged KV pools hold their bytes:

* ``fp32`` — the pool inherits the model dtype (float32 for tinylm,
  bfloat16 for Yi-9B): the unquantized pools.
* ``bf16`` — bfloat16 pages, no scales: the scatter rounds rows to bf16
  (round to nearest even), attention upcasts to fp32.
* ``int8`` / ``fp8`` — quantized pages behind per-page-per-head fp32
  scale pools.  The names resolve (so byte accounting can quote them),
  but the port does not serve them yet: ``pool_torch_dtype`` raises.
"""
from __future__ import annotations

import torch

from repro_torch.models.param import torch_dtype

KV_DTYPES = ("fp32", "bf16", "int8", "fp8")

QUANTIZED_TODO = (
    "kv_dtype int8/fp8 is not ported yet (ROADMAP Queue B: paged_attn "
    "int8/fp8 with kv_quant's scatter codec)"
)


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
    if kv_dtype == "bf16":
        return torch.bfloat16
    raise NotImplementedError(QUANTIZED_TODO)


# ---------------------------------------------------------------------------
# Byte accounting (serving metrics)
# ---------------------------------------------------------------------------

def kv_itemsize(kv_dtype: str, model_dtype) -> int:
    resolve_kv_dtype(kv_dtype)
    if is_quantized(kv_dtype):
        return 1
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
