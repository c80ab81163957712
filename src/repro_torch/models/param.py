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


def _init_leaf(spec: ParamSpec, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    dt = torch_dtype(spec.dtype) if spec.dtype else dtype
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dt, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dt, device=device)
    std = (spec.scale or 1.0) if spec.init == "embed" else _init_std(spec)
    x = torch.empty(spec.shape, dtype=torch.float32, device=device)
    x.normal_(0.0, std, generator=gen)
    return x.to(dt)


def init_params(spec_tree: Any, seed: int, dtype, device,
                select: Optional[Callable[[ParamSpec, torch.Tensor],
                                          torch.Tensor]] = None) -> Any:
    """Materialize parameters on ``device``.  Each leaf draws from a
    ``torch.Generator`` on that device seeded from ``(seed, path)``, so a
    leaf's values do not depend on the order the tree is walked in.  The
    distributions are the reference's; the values are not (use
    ``repro_torch.bridge`` to carry reference weights across).
    ``select(spec, leaf)``, if given, replaces each leaf right after its
    draw (a tensor-parallel rank keeps its block of it)."""
    dt = torch_dtype(dtype)
    device = torch.device(device)
    gen = torch.Generator(device=device)

    def walk(tree: Any, path: Tuple[str, ...]) -> Any:
        if is_spec(tree):
            h = seed % (2**31 - 1)
            for p in path:
                h = (h * 1_000_003 + _path_hash(p)) % (2**61 - 1)
            gen.manual_seed(h)
            leaf = _init_leaf(tree, gen, dt, device)
            return leaf if select is None else select(tree, leaf)
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
