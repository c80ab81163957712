"""Wrapper of the dense GLU FF kernel (``csrc/glu_ffn.cu``), which
replaces the TPU kernel ``repro/kernels/glu_ffn.py::glu_ffn``.

``y = (act(x Wg) * (x W1)) W2`` in fp32, x [S, D], Wg/W1 [D, F], W2
[F, D], any F (the TPU kernel's ``F % 512`` tile rule does not apply).
``z`` is rounded to x's dtype before the second product, as the TPU
kernel does.  Two passes: one thread per neuron for ``z``, then the down
projection shared with the pruned kernel (``csrc/ffn_common.cuh``).

CUDA tensors only; ``ops.glu_ffn_forward`` dispatches CPU tensors to
``ref.glu_ffn_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ffn_common import ACTIVATIONS, check_ffn_inputs, down_scratch

#: launches of the kernel since the last reset (one per wrapper call)
launches = 0


def glu_ffn(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor,
            w2: torch.Tensor, *, activation: str = "swiglu") -> torch.Tensor:
    """x [S, D]; wg/w1 [D, F]; w2 [F, D] (one dtype, CUDA) -> [S, D] fp32."""
    global launches
    what = "glu_ffn"
    x = x.contiguous()
    check_ffn_inputs(what, x, (wg, w1, w2), activation)
    S, D = x.shape
    F = wg.shape[1]
    backend.require(tuple(wg.shape) == (D, F) and tuple(w1.shape) == (D, F)
                    and tuple(w2.shape) == (F, D), what,
                    f"wg/w1 must be [D, F] and w2 [F, D], D={D}, F={F}")
    y = torch.empty((S, D), dtype=torch.float32, device=x.device)
    if S * D == 0 or F == 0:
        return y.zero_()
    z = torch.empty((S, F), dtype=x.dtype, device=x.device)
    part, n_sm = down_scratch(x, S, F, D)
    with torch.cuda.device(x.device):
        err = backend.lib().glu_ffn(
            x.data_ptr(), wg.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            z.data_ptr(), None if part is None else part.data_ptr(),
            y.data_ptr(), S, D, F, ACTIVATIONS[activation], n_sm,
            int(x.dtype == torch.bfloat16), backend.stream_of(x))
    backend.check(err, what)
    launches += 1
    return y
