"""Wrapper of the dense GLU FF kernel (``csrc/glu_ffn.cu``), which
replaces the TPU kernel ``repro/kernels/glu_ffn.py::glu_ffn``.

``y = (act(x Wg) * (x W1)) W2`` in fp32, x [S, D], Wg/W1 [D, F], W2
[F, D], any S, D and F (the TPU kernel's ``F % 512`` tile rule does not
apply).  ``z`` is rounded to x's dtype before the second product, as the
TPU kernel does.  Two launches: the up pass writes ``z``, the down pass
``y`` (tensor-core tiles for bf16, exact FMA for fp32; aligned bf16
weights stream in by TMA); each cuts its K rows into at most 8 ranges
per output column tile that run as one thread block cluster and merge
their partial sums in rank order (``glu_plan`` sizes them).

CUDA tensors only; ``ops.glu_ffn_forward`` dispatches CPU tensors to
``ref.glu_ffn_ref``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ffn_common import (ACTIVATIONS, cdiv,
                                            check_ffn_inputs, k_splits)

#: launches of the kernel since the last reset (one per wrapper call)
launches = 0

#: as compiled in ``csrc/glu_ffn.cu``: columns of an up-pass and a
#: down-pass CTA, bytes of an x (up) and a z (down) row per k tile
UP_COLS, DOWN_COLS = 128, 128
UP_K_BYTES, DOWN_K_BYTES = 64, 128


def row_tile(M: int) -> int:
    """Rows of x (and z) one CTA takes: 32 for a prefill chunk, else 64."""
    return 32 if M <= 32 else 64


def glu_plan(M: int, D: int, F: int, n_sm: int, itemsize: int
             ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``k_splits`` of the up pass (D's rows, over ``UP_COLS``-wide
    column tiles of z) and of the down pass (F's rows, over
    ``DOWN_COLS``-wide column tiles of y)."""
    m_tiles = cdiv(M, row_tile(M))
    up = k_splits(D, UP_K_BYTES // itemsize, cdiv(F, UP_COLS) * m_tiles, n_sm)
    down = k_splits(F, DOWN_K_BYTES // itemsize, cdiv(D, DOWN_COLS) * m_tiles, n_sm)
    return up, down


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
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    (up_splits, up_k), (down_splits, down_k) = glu_plan(S, D, F, n_sm,
                                                        x.element_size())
    with torch.cuda.device(x.device):
        err = backend.lib().glu_ffn(
            x.data_ptr(), wg.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            z.data_ptr(), y.data_ptr(), S, D, F, ACTIVATIONS[activation],
            up_splits, up_k, down_splits, down_k,
            int(x.dtype == torch.bfloat16), backend.stream_of(x))
    backend.check(err, what)
    launches += 1
    return y
