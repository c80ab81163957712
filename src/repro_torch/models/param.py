"""Parameter-spec system (port of ``repro/models/param.py``).

Every layer declares its parameters as a tree of :class:`ParamSpec` —
(shape, logical axes, init).  ``init_params`` materializes a spec tree
on a device from a seed.  Trees are nested dicts and lists (the port
keeps one entry per layer instead of the reference's scan-stacked
leaves, so ``stack_specs`` is only used for spec bookkeeping).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "int8": torch.int8,
    "int32": torch.int32,
    "float8_e4m3fn": torch.float8_e4m3fn,
}


def torch_dtype(name) -> torch.dtype:
    """Model dtype string (``cfg.dtype``) -> ``torch.dtype``."""
    if isinstance(name, torch.dtype):
        return name
    return _DTYPES[str(name)]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones | embed | small
    scale: Optional[float] = None  # override init std
    dtype: Optional[str] = None  # override model dtype

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[ParamSpec], Any], tree: Any) -> Any:
    """Map ``fn`` over every ParamSpec leaf of a nested dict/list tree."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_specs(fn, v) for v in tree]
    raise TypeError(f"unexpected node in spec tree: {type(tree)}")


def stack_specs(tree: Any, n: int) -> Any:
    """Add a leading scan ("layers") axis of size ``n`` to every spec."""
    def _stack(s: ParamSpec) -> ParamSpec:
        return ParamSpec(
            shape=(n,) + s.shape,
            axes=("layers",) + s.axes,
            init=s.init,
            scale=s.scale,
            dtype=s.dtype,
        )
    return tree_map_specs(_stack, tree)


def _init_std(spec: ParamSpec) -> float:
    """Fan-in scaled std, the reference's rule (a leading ``layers`` axis
    is excluded from fan-in)."""
    shape = spec.shape
    fan_shape = shape[1:] if spec.axes and spec.axes[0] == "layers" else shape
    fan_in = fan_shape[0] if len(fan_shape) >= 2 else max(np.prod(fan_shape), 1)
    if len(fan_shape) >= 3:  # e.g. [heads, head_dim, embed] out-proj
        fan_in = int(np.prod(fan_shape[:-1]))
    std = spec.scale if spec.scale is not None else float(fan_in) ** -0.5
    if spec.init == "small":
        std = 1e-2 * std
    return std


#: leaves of at least this many elements are drawn in slices along their
#: leading axis, each from a generator of its own, so that a rank draws
#: only the slices its block touches
SLICED_NUMEL = 1 << 29
#: elements of one slice (whole leading indices; at least one)
SLICE_NUMEL = 1 << 24


def _leaf_std(spec: ParamSpec) -> float:
    return (spec.scale or 1.0) if spec.init == "embed" else _init_std(spec)


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    dt = torch_dtype(spec.dtype) if spec.dtype else dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    x = torch.empty(spec.shape, dtype=torch.float32, device=device)
    x.normal_(0.0, _leaf_std(spec), generator=gen)
    return x.to(dt)


def _leaf_seed(seed: int, path: Tuple[str, ...]) -> int:
    h = seed % (2**31 - 1)
    for p in path:
        h = (h * 1_000_003 + _path_hash(p)) % (2**61 - 1)
    return h


def slice_rows(spec: ParamSpec) -> int:
    """Leading indices per slice of a sliced leaf, 0 for a leaf drawn
    whole."""
    n = int(np.prod(spec.shape)) if spec.shape else 1
    if n < SLICED_NUMEL or spec.init in ("zeros", "ones"):
        return 0
    row = n // spec.shape[0]
    return max(1, SLICE_NUMEL // row)


def _init_sliced(spec: ParamSpec, h: int, gen: torch.Generator,
                 dtype: torch.dtype, device: torch.device,
                 block: Optional[Tuple[slice, ...]]) -> torch.Tensor:
    """A sliced leaf (``slice_rows``), or ``block`` of it: slice ``i``
    (leading indices ``[i*rows, (i+1)*rows)``) is drawn in fp32 from a
    generator seeded from ``(h, i)`` and cast; only the slices the block
    touches are drawn, one at a time."""
    dt = torch_dtype(spec.dtype) if spec.dtype else dtype
    rows = slice_rows(spec)
    n0 = spec.shape[0]
    block = block or tuple(slice(None) for _ in spec.shape)
    block = tuple(slice(*b.indices(n)) for b, n in zip(block, spec.shape))
    lo, hi = block[0].start, block[0].stop
    out = torch.empty(tuple(b.stop - b.start for b in block), dtype=dt,
                      device=device)
    std = _leaf_std(spec)
    for i in range(lo // rows, -(-hi // rows)):
        a, b = i * rows, min(n0, (i + 1) * rows)
        gen.manual_seed((h * 1_000_003 + i + 1) % (2**61 - 1))
        x = torch.empty((b - a,) + tuple(spec.shape[1:]), dtype=torch.float32,
                        device=device)
        x.normal_(0.0, std, generator=gen)
        s0, s1 = max(a, lo), min(b, hi)
        part = x[(slice(s0 - a, s1 - a),) + block[1:]]
        out[s0 - lo: s1 - lo] = part.to(dt)
        del x, part
    return out


def init_params(spec_tree: Any, seed: int, dtype, device,
                blocks: Optional[Callable[[ParamSpec],
                                          Optional[Tuple[slice, ...]]]] = None
                ) -> Any:
    """Materialize parameters on ``device``.  Each leaf draws from a
    ``torch.Generator`` on that device seeded from ``(seed, path)``, so a
    leaf's values do not depend on the order the tree is walked in; a
    leaf of ``SLICED_NUMEL`` elements or more is drawn slice by slice
    along its leading axis, each slice seeded from ``(seed, path,
    index)``.  The distributions are the reference's; the values are not
    (use ``repro_torch.bridge`` to carry reference weights across).
    ``blocks(spec)``, if given, names this rank's block of each leaf (a
    tuple of slices, or None for the whole): the rank gets the same
    block of the one-device draw, and draws only the slices of a sliced
    leaf its block touches (a leaf drawn whole is drawn, then cut)."""
    dt = torch_dtype(dtype)
    device = torch.device(device)
    gen = torch.Generator(device=device)

    def walk(tree: Any, path: Tuple[str, ...]) -> Any:
        if is_spec(tree):
            h = _leaf_seed(seed, path)
            block = None if blocks is None else blocks(tree)
            if slice_rows(tree):
                return _init_sliced(tree, h, gen, dt, device, block)
            gen.manual_seed(h)
            leaf = _init_leaf(tree, gen, dt, device)
            if block is None or all(b == slice(None) for b in block):
                return leaf
            return leaf[block].clone()
        if isinstance(tree, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        return {k: walk(v, path + (k,)) for k, v in tree.items()}

    return walk(spec_tree, ())


def abstract_params(spec_tree: Any, dtype) -> Any:
    """The tree as ``meta`` tensors: shapes and dtypes, no allocation
    (the reference's ``ShapeDtypeStruct`` tree)."""
    dt = torch_dtype(dtype)
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=torch_dtype(s.dtype) if s.dtype else dt,
                              device="meta"),
        spec_tree)


def logical_axes(spec_tree: Any) -> Any:
    """Tree of logical-axis tuples, mirroring the spec tree."""
    return tree_map_specs(lambda s: s.axes, spec_tree)


def param_count(spec_tree: Any) -> int:
    """Number of parameters of a spec tree."""
    total = 0

    def add(s: ParamSpec):
        nonlocal total
        total += int(np.prod(s.shape))

    tree_map_specs(add, spec_tree)
    return total


def _path_hash(s: str) -> int:
    h = 0
    for ch in s:
        h = (h * 131 + ord(ch)) % (2**31 - 1)
    return h
