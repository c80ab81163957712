"""Wrapper of the block-table page gather kernel (``csrc/paged_gather.cu``),
which replaces the TPU kernel ``repro/kernels/paged_gather.py::paged_gather``.

``out[b, i] = pool[max(block_tables[b, i], 0)]``: a copy driven by the
block table over a flat grid of the output, one 16-byte vector a thread
when the page size allows.  The kernel clips
negative (unallocated) entries to page 0 itself.  The dtype is opaque
(pages are copied as bytes).

CUDA tensors only; ``ops.paged_gather`` dispatches CPU tensors to
``ref.paged_gather_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend

#: launches of the kernel since the last reset (one per wrapper call)
launches = 0


def paged_gather(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """pool [P, page, E] (any dtype); block_tables [B, n] int32, entries
    in ``[-1, P)`` (negative reads page 0) -> [B, n, page, E]."""
    global launches
    what = "paged_gather"
    backend.same_cuda_device(what, pool, block_tables)
    backend.require(pool.ndim == 3, what, f"pool must be [P,page,E], got {tuple(pool.shape)}")
    backend.require(block_tables.ndim == 2 and block_tables.dtype == torch.int32,
                    what, "block_tables must be [B,n] int32")
    backend.require(pool.is_contiguous() and block_tables.is_contiguous(),
                    what, "pool and block_tables must be contiguous")
    P, page, E = pool.shape
    B, n = block_tables.shape
    out = torch.empty((B, n, page, E), dtype=pool.dtype, device=pool.device)
    if B * n * page * E == 0:
        return out
    page_bytes = page * E * pool.element_size()
    with torch.cuda.device(pool.device):
        err = backend.lib().paged_gather(
            pool.data_ptr(), block_tables.data_ptr(), out.data_ptr(), B * n,
            page_bytes, backend.stream_of(pool),
        )
    backend.check(err, what)
    launches += 1
    return out
