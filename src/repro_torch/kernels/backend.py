"""Device gate and kernel library binding.

* ``resolve_device`` — entry points default to the card and refuse to
  run on the CPU unless asked: a caller that wants the CPU passes
  ``device="cpu"`` (the tests do).
* ``is_cuda`` — the one dispatch rule of every kernel wrapper: a CUDA
  tensor goes to the hand-written kernel, a CPU tensor to its plain
  version (``kernels/ref.py``), as does a ``meta`` tensor (the
  dry-run's explicit request for shapes), anything else raises.  There is no
  fallback from the kernel to the plain version.
* ``plain`` — the context a wrapper runs its plain version in, so that
  ``analysis.collectives.count_ops`` can name the kernels it counted
  through their plain versions and charge their ops to them.
* ``lib`` — the ``ctypes`` handle of ``build/libgriffin_kernels.so``,
  built on first use (``kernels/build.py``).  Every C entry point
  returns ``cudaGetLastError()`` and ``check`` raises on non-zero.
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import List, Optional

import torch

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LL = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)

#: C signatures of the entry points in ``csrc/*.cu``
_SIGNATURES = {
    # z, out, B, S, F, vec, cluster, threads, z_is_bf16, stream
    "expert_stat": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # z, row_sq, B, S, F, vec, cluster, threads, z_is_bf16, stream
    "expert_stat_row_sq": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # z, row_sq, out, B, S, F, vec, cluster, threads, z_is_bf16, stream
    "expert_stat_from_norm": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # pool, bt, out, rows, page_bytes, stream
    "paged_gather": [_P, _P, _P, _I, _LL, _P],
    # q, k_new, v_new, pool_k, pool_v, bt, pos, wm, ctx, B, S, H, KV, hd,
    # page, W, window, scale, pages_per_split, splits, rows_per_cta,
    # in_is_bf16, pool_is_bf16, stream
    "paged_attn": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    # q, k_new, v_new, pool_k, pool_v, scale_k, scale_v, bt, pos, wm, ctx,
    # B, S, H, KV, hd, page, W, window, scale, pages_per_split, splits,
    # rows_per_cta, in_is_bf16, pool_is_fp8, inv_qmax, eps, stream
    "paged_attn_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                         _I, _F, _F, _P],
    # x, wg, w1, w2, block_ids, z, y, M, D, F, n_sel, block_size, act,
    # up_splits, up_k, down_splits, down_k, is_bf16, stream
    "griffin_ffn": [_P, _P, _P, _P, _P, _P, _P,
                    _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # M, is_bf16, tma, up (out), down (out)
    "griffin_ffn_resident_ctas": [_I, _I, _I, _IP, _IP],
    # x, wg, w1, w2, z, y, M, D, F, act, up_splits, up_k, down_splits,
    # down_k, is_bf16, stream
    "glu_ffn": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                _P],
}

_LIB: Optional[ctypes.CDLL] = None

#: the wrappers whose plain versions are running, innermost last
PLAIN: List[str] = []


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``.  Raises when CUDA is asked for (explicitly or
    by default) and no CUDA device is present — nothing silently moves
    to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device present: the port runs on the card by "
            "default; pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def is_cuda(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU tensor and for a ``meta``
    one (the dry-run steps shapes through the plain versions, which do
    no arithmetic there); raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"{what}: tensor on unsupported device {t.device}")


@contextlib.contextmanager
def plain(what: str):
    """The body of wrapper ``what``'s plain version (a CPU or ``meta``
    tensor): named in ``PLAIN`` while it runs."""
    PLAIN.append(what)
    try:
        yield
    finally:
        PLAIN.pop()


def lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from repro_torch.kernels.build import build

        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = handle
    return _LIB


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {err})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def same_cuda_device(what: str, *ts: torch.Tensor) -> torch.device:
    dev = ts[0].device
    for t in ts:
        require(t.device == dev and t.device.type == "cuda", what,
                f"all tensors must be on one CUDA device, got {t.device}")
    return dev
