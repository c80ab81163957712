"""Wrapper of the GRIFFIN statistic kernel (``csrc/expert_stat.cu``),
which replaces the TPU kernel ``repro/kernels/expert_stat.py::expert_stat``.

Eq. 6: ``s_sq[b, j] = sum_t z[b,t,j]^2 / ||z[b,t]||^2`` in fp32, with 0
for all-zero rows.  Two deterministic passes, no atomics (the statistic
feeds a top-k, so its sum order must not change from run to run): row
inverse norms ``[B, S]``, then column sums over ``S``.

CUDA tensors only; ``ops.griffin_stat`` dispatches CPU tensors to
``ref.expert_stat_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend

#: launches of the kernel since the last reset (one per wrapper call)
launches = 0


def expert_stat(z: torch.Tensor) -> torch.Tensor:
    """z [S, F] or [B, S, F] (fp32/bf16, CUDA) -> s_sq [F] or [B, F] fp32."""
    global launches
    what = "expert_stat"
    backend.same_cuda_device(what, z)
    backend.require(z.ndim in (2, 3), what, f"z must be [S,F] or [B,S,F], got {tuple(z.shape)}")
    backend.require(z.dtype in (torch.float32, torch.bfloat16), what,
                    f"z dtype must be float32 or bfloat16, got {z.dtype}")
    backend.require(z.is_contiguous(), what, "z must be contiguous")
    z3 = z if z.ndim == 3 else z[None]
    B, S, F = z3.shape
    out = torch.empty((B, F), dtype=torch.float32, device=z.device)
    if B * S * F == 0:
        out.zero_()
        return out if z.ndim == 3 else out[0]
    inv = torch.empty((B, S), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        err = backend.lib().expert_stat(
            z3.data_ptr(), inv.data_ptr(), out.data_ptr(), B, S, F,
            int(z.dtype == torch.bfloat16), backend.stream_of(z),
        )
    backend.check(err, what)
    launches += 1
    return out if z.ndim == 3 else out[0]
