"""Host pieces of the GLU FF kernels: the activation codes and argument
checks of ``kernels/griffin_ffn.py`` and ``kernels/glu_ffn.py``, and the
scratch of ``griffin_ffn``'s down projection (``csrc/ffn_common.cuh``),
whose row splits are decided on the C side alone (``ffn_down_splits`` in
``csrc/ffn_common.cu``); the wrapper asks it to size the scratch.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import backend

#: activation name -> the kernels' code (``griffin::glu_act``)
ACTIVATIONS = {"swiglu": 0, "geglu": 1, "reglu": 2}


def check_ffn_inputs(what: str, x, ws, activation: str):
    """Device, dtype, contiguity and activation checks of the FF
    wrappers."""
    backend.same_cuda_device(what, x, *ws)
    backend.require(activation in ACTIVATIONS, what,
                    f"activation must be one of {sorted(ACTIVATIONS)}, got "
                    f"{activation!r}")
    backend.require(x.ndim == 2, what, f"x must be 2-D, got {tuple(x.shape)}")
    backend.require(x.dtype in (torch.float32, torch.bfloat16)
                    and all(w.dtype == x.dtype for w in ws), what,
                    "x and the weights must share a float32 or bfloat16 dtype")
    backend.require(all(w.is_contiguous() for w in ws), what,
                    "the weights must be contiguous (they are read in place)")


def down_scratch(x: torch.Tensor, M: int, N: int, D: int
                 ) -> Tuple[Optional[torch.Tensor], int]:
    """``(part, n_sm)`` for a down projection of ``N`` rows into ``[M, D]``
    on x's card: the fp32 partial sums ``[splits, M, D]`` of its row
    splits (None for one split) and the SM count the C side cuts by."""
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = backend.lib().ffn_down_splits(M, N, D, n_sm)
    part = None
    if splits > 1:
        part = torch.empty((splits, M, D), dtype=torch.float32, device=x.device)
    return part, n_sm
