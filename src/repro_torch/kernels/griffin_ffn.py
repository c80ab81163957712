"""Wrapper of the pruned decode FF kernel (``csrc/griffin_ffn.cu``), which
replaces the TPU kernel ``repro/kernels/griffin_ffn.py::griffin_ffn``.

``y = (act(x Wg_sel^T) * (x W1_sel^T)) W2_sel`` in fp32 over the selected
blocks of ``block_size`` neuron rows of the ``[F, D]`` weights, read in
place (zero-copy pruning: no compacted copy).  ``z`` is rounded to x's
dtype before the second product, as the TPU kernel does.  Two passes:
one warp per selected neuron for ``z``, then the down projection with its
rows split over CTAs and the splits summed in order (deterministic).

CUDA tensors only; ``ops.griffin_ffn_decode`` dispatches CPU tensors to
``ref.griffin_ffn_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ffn_common import ACTIVATIONS, check_ffn_inputs, down_scratch

#: launches of the kernel since the last reset (one per wrapper call)
launches = 0


def griffin_ffn(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor, block_ids: torch.Tensor, *,
                block_size: int = 128, activation: str = "swiglu"
                ) -> torch.Tensor:
    """x [B, D]; wg/w1/w2 [F, D] neuron rows (one dtype, CUDA);
    block_ids [nb] int sorted -> [B, D] fp32."""
    global launches
    what = "griffin_ffn"
    x = x.contiguous()
    check_ffn_inputs(what, x, (wg, w1, w2), activation)
    B, D = x.shape
    F = wg.shape[0]
    backend.require(all(tuple(w.shape) == (F, D) for w in (wg, w1, w2)), what,
                    f"wg, w1, w2 must all be [F, D] = {(F, D)}")
    backend.require(block_size > 0 and F % block_size == 0, what,
                    f"F={F} not a multiple of block_size={block_size}")
    backend.require(block_ids.ndim == 1, what, "block_ids must be [nb]")
    backend.same_cuda_device(what, x, block_ids)
    ids = block_ids.to(torch.int32).contiguous()
    n_sel = ids.numel() * block_size
    y = torch.empty((B, D), dtype=torch.float32, device=x.device)
    if B * D == 0 or n_sel == 0:
        return y.zero_()
    z = torch.empty((B, n_sel), dtype=x.dtype, device=x.device)
    part, n_sm = down_scratch(x, B, n_sel, D)
    isz = x.element_size()
    vec = int(D * isz % 16 == 0 and all(t.data_ptr() % 16 == 0
                                         for t in (x, wg, w1)))
    with torch.cuda.device(x.device):
        err = backend.lib().griffin_ffn(
            x.data_ptr(), wg.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            ids.data_ptr(), z.data_ptr(),
            None if part is None else part.data_ptr(), y.data_ptr(),
            B, D, n_sel, block_size, ACTIVATIONS[activation], vec, n_sm,
            int(x.dtype == torch.bfloat16), backend.stream_of(x))
    backend.check(err, what)
    launches += 1
    return y
