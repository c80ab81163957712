"""Carry reference parameter trees across to the port.

The reference (``repro.models.decoder``) stacks the layers of a scan
segment on a leading axis (``seg{i}/pos{j}`` leaves, ``[n, ...]``) and
keeps the rest unrolled (``seg{i}/layer{j}``); the port keeps one entry
per layer.  The DeepSeek MTP block (``mtp``, unstacked) is carried as it
is.  These helpers take trees whose leaves are already numpy
arrays (``jax.tree.map(np.asarray, tree)`` on the reference side) and
return torch tensors on a device, bit for bit — no weights are
downloaded or re-drawn (leaves that are torch tensors already, such as
the bf16 leaves of a restored checkpoint, are moved as they are).
``params_to_jax`` goes the other way, so the port can write checkpoints
in the reference's layout.  ``device=None`` means the card, as for every
entry point of the port; the tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels import backend
from repro_torch.models import decoder


def _to_torch(tree: Any, device) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):  # e.g. a restored bf16 checkpoint leaf
        return tree.to(device)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":  # ml_dtypes bfloat16: carry the bits
        bits = torch.from_numpy(arr.view(np.int16).copy())
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr)).to(device)


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def per_layer(tree: Dict[str, Dict[str, Any]], cfg) -> Dict[int, Any]:
    """Map a reference segment tree (``{"seg{i}": {"pos{j}"|"layer{j}":
    leaf}}``) onto ``{li: leaf}``, un-stacking scan leaves.  Layers the
    tree does not hold are skipped."""
    out: Dict[int, Any] = {}
    for li, (path, inst, _) in enumerate(decoder.layer_paths(cfg)):
        seg, name = path.split("/")
        if name not in tree.get(seg, {}):
            continue
        leaf = tree[seg][name]
        out[li] = _index(leaf, inst) if name.startswith("pos") else leaf
    return out


def params_from_jax(tree: Dict, cfg, device=None) -> Dict:
    """Reference ``decoder.init_params`` tree (numpy leaves) -> the
    port's parameters on ``device``."""
    device = backend.resolve_device(device)
    layers = per_layer({k: v for k, v in tree.items() if k.startswith("seg")},
                       cfg)
    out: Dict[str, Any] = {
        "embed": _to_torch(tree["embed"], device),
        "layers": [_to_torch(layers[li], device) for li in range(cfg.num_layers)],
        "final_norm": _to_torch(tree["final_norm"], device),
    }
    for k in ("head", "mtp"):
        if k in tree:
            out[k] = _to_torch(tree[k], device)
    return out


def tree_from_jax(tree: Dict, cfg, device=None) -> Dict[int, Any]:
    """Any reference per-layer tree (statistics, decode caches, compacted
    FF) with numpy leaves -> ``{li: leaf}`` of torch tensors on
    ``device``; scan-stacked ``[n, ...]`` leaves are split per layer."""
    device = backend.resolve_device(device)
    return {li: _to_torch(leaf, device)
            for li, leaf in per_layer(tree, cfg).items()}


def params_to_jax(params: Dict, cfg) -> Dict:
    """The port's parameters -> the reference's layout (scan leaves
    stacked on a leading axis), as CPU tensors: the inverse of
    ``params_from_jax``, for writing checkpoints either package reads."""
    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        return tree.detach().cpu()

    def stack(leaves):
        if isinstance(leaves[0], dict):
            return {k: stack([lf[k] for lf in leaves]) for k in leaves[0]}
        return torch.stack(leaves)

    out: Dict[str, Any] = {"embed": cpu(params["embed"]),
                           "final_norm": cpu(params["final_norm"])}
    for k in ("head", "mtp"):
        if k in params:
            out[k] = cpu(params[k])
    groups: Dict[tuple, list] = {}
    for li, (path, _, _) in enumerate(decoder.layer_paths(cfg)):
        groups.setdefault(tuple(path.split("/")), []).append(
            cpu(params["layers"][li]))
    for (seg, name), leaves in groups.items():
        out.setdefault(seg, {})[name] = stack(leaves) \
            if name.startswith("pos") else leaves[0]
    return out
