"""Offline per-layer sparsity profiles from flocking statistics (port of
``repro/analysis/profile.py``).

Flocking strength is not uniform across depth: layers whose tokens
agree on a small expert set (high ``flocking_score``) concentrate their
mass in the selected experts and tolerate aggressive pruning, while
weakly-flocking layers degrade first.  This module turns that per-layer
statistic into a ``griffin.SparsityProfile`` — per-layer keep-weights
the serving tier multiplies — by a small offline pass over held-out
sequences:

    profile = derive_profile(cfg, params, seqs)
    profile.save("profile.json")
    # serve:  python -m repro_torch.launch.serve --tier 0.5 \\
    #             --sparsity-profile profile.json

Weights are ``1 - flocking_score`` (strong flocking -> keep fewer),
normalized to mean 1 so a tier's *average* budget across layers is
unchanged, then clipped to ``[0.5, 1.5]``.  The profile keys layers by
the reference's paths (``"seg{i}/{name}"``, one weight per scan
instance), so either package loads the other's profiles.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.flocking import flocking_score
from repro_torch.core.griffin import SparsityProfile
from repro_torch.models import decoder

__all__ = ["derive_profile", "layer_flocking_scores"]


def layer_flocking_scores(cfg, params, seqs, *,
                          top_frac: float = 0.05) -> Dict[str, Tuple[float, ...]]:
    """Mean flocking score per FF instance: ``{"seg{i}/{name}": (f,)*n}``.

    ``seqs`` is ``[N, S]`` token ids; scores average over the N
    sequences (each sequence scored independently — the statistic is
    per-sequence by construction, eq. 6)."""
    seqs = torch.as_tensor(seqs, device=params["embed"]["table"].device)
    paths = decoder.layer_paths(cfg)
    scores: Dict[str, List[List[float]]] = {}
    for b in range(seqs.shape[0]):
        _, aux = decoder.forward(params, cfg, seqs[b:b + 1],
                                 collect_stats=True, want_z=True,
                                 logits_mode="last")
        for li, st in decoder.prune_stats_tree(aux.stats, cfg).items():
            path, inst, n = paths[li]
            per_inst = scores.setdefault(path, [[] for _ in range(n)])
            per_inst[inst].append(flocking_score(st["z"][0], top_frac))
    return {p: tuple(float(np.mean(s)) for s in per_inst)
            for p, per_inst in scores.items()}


def derive_profile(cfg, params, seqs, *, top_frac: float = 0.05,
                   clip: Tuple[float, float] = (0.5, 1.5),
                   note: str = "") -> SparsityProfile:
    """Flocking pass -> per-layer keep-weight profile.

    Weights are ``1 - flocking_score``, normalized to mean 1 and clipped
    to ``clip`` — a profile-less run is the ``weights == 1`` case."""
    scores = layer_flocking_scores(cfg, params, seqs, top_frac=top_frac)
    raw = {p: tuple(1.0 - f for f in fs) for p, fs in scores.items()}
    flat = [w for ws in raw.values() for w in ws]
    mean = float(np.mean(flat)) if flat else 1.0
    if mean <= 0:  # degenerate (every layer fully flocked) — fall back flat
        mean = 1.0
    lo, hi = clip
    weights = tuple(sorted(
        (p, tuple(float(np.clip(w / mean, lo, hi)) for w in ws))
        for p, ws in raw.items()
    ))
    return SparsityProfile(
        weights=weights,
        arch=getattr(cfg, "name", ""),
        note=note or (f"flocking-derived, {seqs.shape[0]} seqs x "
                      f"{seqs.shape[1]} tokens, top_frac={top_frac}, "
                      f"clip=[{lo}, {hi}]"),
    )
