"""Atomic checkpointing in the reference's format, without JAX (port of
``repro/checkpoint/checkpointer.py``).

Layout per step:
    <dir>/step_000123/
        manifest.json       tree structure, shapes, dtypes
        arrays.npz          flattened leaves keyed by escaped path
Writes go to ``step_X.tmp`` then atomically rename — a crash mid-write
never corrupts the latest checkpoint.  ``save_async`` copies the tree to
the host synchronously and serializes it in a background thread.

Leaves are torch tensors or numpy arrays.  bf16 has no numpy dtype: a
bf16 leaf is stored as its raw ``uint16`` bits with the dtype tag
``bfloat16`` (as the reference stores it), and ``restore`` turns it back
into a ``torch.bfloat16`` tensor by a bit view; every other leaf comes
back as a numpy array.  Either package reads the other's checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Any, path=()) -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, path + (str(k),)))
    else:
        out["/".join(path)] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def _to_host(v: Any) -> Tuple[np.ndarray, str]:
    """A leaf -> (numpy array to store, dtype tag)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.dtype).split(".")[-1]
    arr = np.asarray(v)
    return arr, str(arr.dtype)


def save(ckpt_dir: str, step: int, tree: Any) -> str:
    """Synchronous atomic save. Returns the final directory path."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = {}
    manifest = {"step": step, "leaves": {}}
    for key, v in _flatten(tree).items():
        arr, tag = _to_host(v)
        arrays[key.replace("/", "__")] = arr
        manifest["leaves"][key] = {"dtype": tag, "shape": list(arr.shape)}
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return str(final)


def save_async(ckpt_dir: str, step: int, tree: Any) -> threading.Thread:
    """Copy to the host synchronously (cheap), serialize in background."""
    host = _unflatten({k: v.detach().to("cpu", copy=True)
                       if isinstance(v, torch.Tensor) else np.array(v)
                       for k, v in _flatten(tree).items()})
    t = threading.Thread(target=save, args=(ckpt_dir, step, host), daemon=True)
    t.start()
    return t


def available_steps(ckpt_dir: str):
    p = Path(ckpt_dir)
    if not p.exists():
        return []
    steps = []
    for d in p.iterdir():
        if d.is_dir() and d.name.startswith("step_") and not d.name.endswith(".tmp"):
            try:
                steps.append(int(d.name[5:]))
            except ValueError:
                continue
    return sorted(steps)


def restore(ckpt_dir: str, step: Optional[int] = None) -> Tuple[Any, int]:
    """Load a checkpoint (the latest step unless ``step`` is given):
    numpy leaves, bf16 leaves as ``torch.bfloat16`` tensors."""
    steps = available_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    step = steps[-1] if step is None else step
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = {}
    with np.load(d / "arrays.npz") as npz:
        for key, meta in manifest["leaves"].items():
            arr = npz[key.replace("/", "__")]
            if meta["dtype"] == "bfloat16" and arr.dtype == np.uint16:
                arr = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            flat[key] = arr
    return _unflatten(flat), step
