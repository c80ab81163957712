"""Wrapper of the pruned decode FF kernel (``csrc/griffin_ffn.cu``), which
replaces the TPU kernel ``repro/kernels/griffin_ffn.py::griffin_ffn``.

``y = (act(x Wg_sel^T) * (x W1_sel^T)) W2_sel`` in fp32 over the selected
blocks of ``block_size`` neuron rows of the ``[F, D]`` weights, read in
place (zero-copy pruning: no compacted copy).  ``z`` is rounded to x's
dtype before the second product, as the TPU kernel does.  Two launches of
the tiled loop ``glu_ffn`` also runs (``csrc/ffn_common.cuh``): the up
pass writes ``z`` from ``[n][k]`` tiles of the selected Wg/W1 rows, the
down pass ``y`` from the selected W2 rows (tensor-core tiles for bf16,
exact FMA for fp32; bf16 weights stream in by TMA when ``block_size`` is
a multiple of 64); each cuts its K rows into at most 8 ranges per output
tile that run as one thread block cluster and merge in rank order
(``griffin_plan`` sizes them), so the bits are the same from run to run.

``block_ids`` are taken in the order given, as the plain version takes
them: sorted or not, the result is the same function.  They are not
range-checked (that would cost a device-to-host copy); each must lie in
``[0, F / block_size)``.

CUDA tensors only; ``ops.griffin_ffn_decode`` dispatches CPU tensors to
``ref.griffin_ffn_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ffn_common import (ACTIVATIONS, cdiv,
                                            check_ffn_inputs, k_splits)

#: launches of the kernel since the last reset (one per wrapper call)
launches = 0

#: as compiled in ``csrc/griffin_ffn.cu``: neurons of an up-pass CTA,
#: columns of a down-pass CTA, bytes of an x (up) and a z (down) row per
#: k tile
UP_COLS, DOWN_COLS = 64, 128
UP_K_BYTES, DOWN_K_BYTES = 128, 128


def row_tile(M: int) -> int:
    """Rows of x (and z) one CTA takes: 16 for a decode step, else 64."""
    return 16 if M <= 16 else 64


def ctas_per_sm(M: int) -> int:
    """CTAs of a pass that share an SM: 3 at a 16-row tile, 2 at 64 rows
    (``resident_ctas`` gives what the card holds)."""
    return 3 if row_tile(M) == 16 else 2


def resident_ctas(M: int, dtype: torch.dtype, tma: bool) -> Tuple[int, int]:
    """CTAs of the up and the down pass that one SM of the current card
    holds at once for ``M`` rows of x, by registers and shared memory
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); ``tma``: bf16
    weights by TMA.  Builds the kernels."""
    up, down = ctypes.c_int(0), ctypes.c_int(0)
    err = backend.lib().griffin_ffn_resident_ctas(
        M, int(dtype == torch.bfloat16), int(tma), ctypes.byref(up),
        ctypes.byref(down))
    backend.check(err, "griffin_ffn_resident_ctas")
    return up.value, down.value


def griffin_plan(M: int, D: int, n_sel: int, n_sm: int, itemsize: int
                 ) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """``k_splits`` of the up pass (D's rows, over ``UP_COLS``-neuron
    tiles of z's ``n_sel`` columns) and of the down pass (the ``n_sel``
    selected rows, over ``DOWN_COLS``-wide column tiles of y), so that
    every CTA of a pass is resident at once."""
    m_tiles = cdiv(M, row_tile(M))
    cps = ctas_per_sm(M)
    up = k_splits(D, UP_K_BYTES // itemsize, cdiv(n_sel, UP_COLS) * m_tiles,
                  n_sm, cps)
    down = k_splits(n_sel, DOWN_K_BYTES // itemsize,
                    cdiv(D, DOWN_COLS) * m_tiles, n_sm, cps)
    return up, down


def griffin_ffn(x: torch.Tensor, wg: torch.Tensor, w1: torch.Tensor,
                w2: torch.Tensor, block_ids: torch.Tensor, *,
                block_size: int = 128, activation: str = "swiglu"
                ) -> torch.Tensor:
    """x [B, D]; wg/w1/w2 [F, D] neuron rows (one dtype, CUDA);
    block_ids [nb] int -> [B, D] fp32."""
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
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    (up_splits, up_k), (down_splits, down_k) = griffin_plan(
        B, D, n_sel, n_sm, x.element_size())
    with torch.cuda.device(x.device):
        err = backend.lib().griffin_ffn(
            x.data_ptr(), wg.data_ptr(), w1.data_ptr(), w2.data_ptr(),
            ids.data_ptr(), z.data_ptr(), y.data_ptr(), B, D, F, n_sel,
            block_size, ACTIVATIONS[activation], up_splits, up_k, down_splits,
            down_k, int(x.dtype == torch.bfloat16), backend.stream_of(x))
    backend.check(err, what)
    launches += 1
    return y
