"""Wrapper of the GRIFFIN statistic kernel (``csrc/expert_stat.cu``),
which replaces the TPU kernel ``repro/kernels/expert_stat.py::expert_stat``.

Eq. 6: ``s_sq[b, j] = sum_t z[b,t,j]^2 / ||z[b,t]||^2`` in fp32, with 0
for all-zero rows.  One launch, no scratch and no atomics (the statistic
feeds a top-k, so its sum order must not change from run to run): each
``b`` is a thread block cluster that splits F into column slices and
shares the row norms through distributed shared memory.  ``stat_plan``
sizes it.

Under tensor parallelism a rank holds F/N columns, and the row norm is
the sum over all ranks (the reference's ``psum_if_tp(row)``), so the
statistic is launched in two steps with the same plan:
``expert_stat_row_sq`` (this rank's partial row norms ``[B, S]``), an
all-reduce by the caller, then ``expert_stat_from_norm`` (the column sums
from the summed norms).  Each has its own launch counter.

CUDA tensors only; ``ops.griffin_stat`` / ``ops.griffin_row_sq`` /
``ops.griffin_stat_from_norm`` dispatch CPU tensors to ``kernels/ref.py``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import backend

#: launches since the last reset (one per wrapper call): the single
#: launch, and the two steps of the tensor-parallel variant
launches = 0
row_sq_launches = 0
from_norm_launches = 0

#: CTAs of one cluster (the portable limit) and threads of one CTA, as
#: compiled in ``csrc/expert_stat.cu``
MAX_CLUSTER = 8
MAX_THREADS = 256
#: vectors a CTA takes at least before the slice is cut for another CTA
MIN_VECTORS_PER_CTA = 64


def stat_vec(F: int, itemsize: int, address: int) -> int:
    """Elements per load: the widest power of two whose bytes (at most 16)
    divide both a row of ``F`` elements and the tensor's address."""
    vec = 16 // itemsize
    while vec > 1 and (F % vec or address % (vec * itemsize)):
        vec //= 2
    return vec


def stat_plan(n_vec: int) -> Tuple[int, int]:
    """``(cluster, threads)`` for ``n_vec`` vectors of a row: CTA r of the
    cluster owns vectors ``[r * vpc, (r + 1) * vpc)``, ``vpc =
    ceil(n_vec / cluster)``, and thread i of it vectors ``r * vpc + i +
    k * threads``.  Up to 8 CTAs, each with at least
    ``MIN_VECTORS_PER_CTA`` vectors where the row has them, and one vector
    per thread where ``MAX_THREADS`` threads suffice."""
    cluster = max(1, min(MAX_CLUSTER, -(-n_vec // MIN_VECTORS_PER_CTA)))
    vpc = -(-n_vec // cluster)
    threads = min(MAX_THREADS, 32 * -(-vpc // 32))
    return cluster, threads


def _checked(z: torch.Tensor, what: str) -> torch.Tensor:
    backend.same_cuda_device(what, z)
    backend.require(z.ndim in (2, 3), what, f"z must be [S,F] or [B,S,F], got {tuple(z.shape)}")
    backend.require(z.dtype in (torch.float32, torch.bfloat16), what,
                    f"z dtype must be float32 or bfloat16, got {z.dtype}")
    backend.require(z.is_contiguous(), what, "z must be contiguous")
    return z if z.ndim == 3 else z[None]


def _plan(z3: torch.Tensor) -> Tuple[int, int, int]:
    """(vec, cluster, threads) of a launch over z3 [B, S, F]."""
    vec = stat_vec(z3.shape[2], z3.element_size(), z3.data_ptr())
    return (vec,) + stat_plan(z3.shape[2] // vec)


def expert_stat(z: torch.Tensor) -> torch.Tensor:
    """z [S, F] or [B, S, F] (fp32/bf16, CUDA) -> s_sq [F] or [B, F] fp32."""
    global launches
    what = "expert_stat"
    z3 = _checked(z, what)
    B, S, F = z3.shape
    out = torch.empty((B, F), dtype=torch.float32, device=z.device)
    if B * S * F == 0:
        out.zero_()
        return out if z.ndim == 3 else out[0]
    vec, cluster, threads = _plan(z3)
    with torch.cuda.device(z.device):
        err = backend.lib().expert_stat(
            z3.data_ptr(), out.data_ptr(), B, S, F, vec, cluster, threads,
            int(z.dtype == torch.bfloat16), backend.stream_of(z),
        )
    backend.check(err, what)
    launches += 1
    return out if z.ndim == 3 else out[0]


def expert_stat_row_sq(z: torch.Tensor) -> torch.Tensor:
    """Step 1 of the tensor-parallel statistic: z [S, F] or [B, S, F]
    (this rank's columns) -> its partial squared row norms [S] or [B, S]
    fp32, in the single launch's reduction order."""
    global row_sq_launches
    what = "expert_stat_row_sq"
    z3 = _checked(z, what)
    B, S, F = z3.shape
    if B * S * F == 0:
        out = torch.zeros((B, S), dtype=torch.float32, device=z.device)
        return out if z.ndim == 3 else out[0]
    out = torch.empty((B, S), dtype=torch.float32, device=z.device)
    vec, cluster, threads = _plan(z3)
    with torch.cuda.device(z.device):
        err = backend.lib().expert_stat_row_sq(
            z3.data_ptr(), out.data_ptr(), B, S, F, vec, cluster, threads,
            int(z.dtype == torch.bfloat16), backend.stream_of(z),
        )
    backend.check(err, what)
    row_sq_launches += 1
    return out if z.ndim == 3 else out[0]


def expert_stat_from_norm(z: torch.Tensor, row_sq: torch.Tensor) -> torch.Tensor:
    """Step 2: z [S, F] or [B, S, F] and the all-reduced squared row norms
    [S] or [B, S] (fp32) -> s_sq [F] or [B, F] fp32 (rows with norm <= 0
    contribute 0, as the reference's ``where(row > 0, 1/row, 0)``)."""
    global from_norm_launches
    what = "expert_stat_from_norm"
    z3 = _checked(z, what)
    B, S, F = z3.shape
    backend.same_cuda_device(what, z, row_sq)
    r2 = row_sq if row_sq.ndim == 2 else row_sq[None]
    backend.require(tuple(r2.shape) == (B, S) and r2.dtype == torch.float32
                    and r2.is_contiguous(), what,
                    f"row_sq must be contiguous float32 {(B, S)}, got "
                    f"{r2.dtype} {tuple(r2.shape)}")
    out = torch.empty((B, F), dtype=torch.float32, device=z.device)
    if B * S * F == 0:
        out.zero_()
        return out if z.ndim == 3 else out[0]
    vec, cluster, threads = _plan(z3)
    with torch.cuda.device(z.device):
        err = backend.lib().expert_stat_from_norm(
            z3.data_ptr(), r2.data_ptr(), out.data_ptr(), B, S, F, vec,
            cluster, threads, int(z.dtype == torch.bfloat16),
            backend.stream_of(z),
        )
    backend.check(err, what)
    from_norm_launches += 1
    return out if z.ndim == 3 else out[0]
