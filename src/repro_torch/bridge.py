"""Carry reference parameter trees across to the port.

The reference (``repro.models.decoder``) stacks the layers of a scan
segment on a leading axis (``seg{i}/pos{j}`` leaves, ``[n, ...]``) and
keeps the rest unrolled (``seg{i}/layer{j}``); the port keeps one entry
per layer.  The head, the DeepSeek MTP block (``mtp``, unstacked) and
the stub frontend's projection (``frontend``) are carried as they are.
These helpers take trees whose leaves are already numpy arrays
(``jax.tree.map(np.asarray, tree)`` on the reference side) and return
torch tensors on a device, bit for bit — no weights are downloaded or
re-drawn (leaves that are torch tensors already, such as the bf16
leaves of a restored checkpoint, are moved as they are).
``params_to_jax`` goes the other way, so the port can write checkpoints
in the reference's layout; ``train_state_from_jax`` / ``train_state_to_jax``
carry whole train states (parameters, optimizer state, step) both ways.  ``device=None`` means the card, as for every
entry point of the port; the tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.kernels import backend
from repro_torch.models import decoder


def _to_torch(tree: Any, device, tp=None, specs: Any = None) -> Any:
    """numpy (or torch) leaves -> torch tensors on ``device``; with ``tp``
    (a ``distributed.tp.PagedTP`` or ``TrainTP``) and the subtree's
    ``specs``, each leaf is cut to the rank's block before it is
    converted."""
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, tp, None if specs is None else specs[k])
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):  # e.g. a restored bf16 checkpoint leaf
        return (tree if tp is None else tp.block(tree, specs)).to(device)
    arr = np.asarray(tree)
    if tp is not None:
        arr = arr[tp.slices(specs, arr.shape)]
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


def params_from_jax(tree: Dict, cfg, device=None, tp=None) -> Dict:
    """Reference ``decoder.init_params`` tree (numpy leaves) -> the
    port's parameters on ``device``.  With ``tp`` (a rank's
    ``distributed.tp.PagedTP`` or ``TrainTP``) -> that rank's blocks
    only, cut leaf by leaf on the host: no rank materializes the whole
    model on its device (Yi-9B whole is 17.7 GB in bf16)."""
    device = backend.resolve_device(device)
    specs = tp.param_specs if tp is not None else {}
    layers = per_layer({k: v for k, v in tree.items() if k.startswith("seg")},
                       cfg)
    out: Dict[str, Any] = {
        "embed": _to_torch(tree["embed"], device, tp, specs.get("embed")),
        "layers": [_to_torch(layers[li], device, tp,
                             specs["layers"][li] if tp is not None else None)
                   for li in range(cfg.num_layers)],
        "final_norm": _to_torch(tree["final_norm"], device, tp,
                                specs.get("final_norm")),
    }
    for k in ("head", "frontend", "mtp"):
        if k in tree:
            out[k] = _to_torch(tree[k], device, tp, specs.get(k))
    return out


def tree_from_jax(tree: Dict, cfg, device=None) -> Dict[int, Any]:
    """Any reference per-layer tree (statistics, decode caches, compacted
    FF) with numpy leaves -> ``{li: leaf}`` of torch tensors on
    ``device``; scan-stacked ``[n, ...]`` leaves are split per layer."""
    device = backend.resolve_device(device)
    return {li: _to_torch(leaf, device)
            for li, leaf in per_layer(tree, cfg).items()}


def ref_view(params: Dict, cfg) -> Dict:
    """The port's per-layer tree (parameters, gradients, meta tensors) in
    the reference's layout without a copy: a scan-stacked leaf is the
    list of its layers' tensors, in layer order (the optimizers take such
    lists as stacked leaves)."""
    def zip_layers(leaves):
        if isinstance(leaves[0], dict):
            return {k: zip_layers([lf[k] for lf in leaves]) for k in leaves[0]}
        return list(leaves)

    out: Dict[str, Any] = {k: params[k] for k in
                           ("embed", "final_norm", "head", "frontend", "mtp")
                           if k in params}
    groups: Dict[tuple, list] = {}
    for li, (path, _, _) in enumerate(decoder.layer_paths(cfg)):
        groups.setdefault(tuple(path.split("/")), []).append(
            params["layers"][li])
    for (seg, name), layers in groups.items():
        out.setdefault(seg, {})[name] = zip_layers(layers) \
            if name.startswith("pos") else layers[0]
    return out


def _host(tree: Any) -> Any:
    """Tensors -> detached CPU tensors; a list (stacked leaf) is stacked;
    meta tensors stay on the meta device."""
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return torch.stack([_host(t) for t in tree])
    return tree.detach() if tree.is_meta else tree.detach().cpu()


def params_to_jax(params: Dict, cfg) -> Dict:
    """The port's parameters -> the reference's layout (scan leaves
    stacked on a leading axis), as CPU tensors: the inverse of
    ``params_from_jax``, for writing checkpoints either package reads."""
    return _host(ref_view(params, cfg))


def train_state_from_jax(state: Dict, cfg, device=None, tp=None) -> Dict:
    """A reference train state (``{params, opt, step}``, numpy leaves, as
    ``repro.checkpoint`` restores it) -> the port's on ``device``.  The
    port keeps the optimizer state in the reference's layout
    (``training/optimizer.py``), so ``opt`` and ``step`` cross leaf for
    leaf; the parameters are split per layer.  With ``tp`` (a training
    rank's ``distributed.tp.TrainTP``) -> that rank's blocks of every
    leaf."""
    device = backend.resolve_device(device)
    return {"params": params_from_jax(state["params"], cfg, device, tp),
            "opt": _to_torch(state["opt"], device, tp,
                             None if tp is None else tp.opt_specs(state["opt"])),
            "step": _to_torch(state["step"], device)}


def train_state_to_jax(state: Dict, cfg) -> Dict:
    """The port's train state -> the reference's layout as CPU tensors
    (what ``CheckpointManager`` writes and ``repro.checkpoint`` reads)."""
    return {"params": params_to_jax(state["params"], cfg),
            "opt": _host(state["opt"]), "step": _host(state["step"])}
