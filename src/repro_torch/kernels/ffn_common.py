"""Host pieces of the GLU FF kernels (``kernels/griffin_ffn.py``,
``kernels/glu_ffn.py``): the activation codes, the argument checks, and
how a pass cuts its K rows into ranges that run as one thread block
cluster (``csrc/ffn_common.cuh``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import backend

#: activation name -> the kernels' code (``griffin::glu_act``)
ACTIVATIONS = {"swiglu": 0, "geglu": 1, "reglu": 2}

#: the most row ranges of one column tile (one thread block cluster), and
#: the CTAs per SM the ranges aim at by default
MAX_SPLITS = 8
CTAS_PER_SM = 3


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def k_splits(K: int, bk: int, tiles: int, n_sm: int,
             ctas_per_sm: int = CTAS_PER_SM) -> Tuple[int, int]:
    """``(splits, rows_per_split)``: a pass's K rows cut into ``splits``
    ranges of ``rows_per_split`` rows (a whole number of ``bk``-row k
    tiles; the last range may be shorter, none is empty), as many as fit
    beside the ``tiles`` output tiles at ``ctas_per_sm`` CTAs per SM in
    one wave, at most ``MAX_SPLITS``."""
    splits = max(1, min(MAX_SPLITS, cdiv(K, bk), ctas_per_sm * n_sm // tiles))
    rps = bk * cdiv(cdiv(K, splits), bk)
    return cdiv(K, rps), rps


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
