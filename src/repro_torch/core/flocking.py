"""Flocking analysis (section 4.1, Figures 1-2, Appendices C/E; port of
``repro/core/flocking.py``).

Tools to observe the paper's core phenomenon: relative FF activation
magnitudes shared across tokens *within* a sequence (vertical streaks)
but not *between* sequences (low inter-sample Jaccard similarity).
Top-k sets break ties toward the lower index, as ``jax.lax.top_k`` does
(``selector.top_k_indices``).
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from repro_torch.core.selector import top_k_indices


def relative_activations(z: torch.Tensor) -> torch.Tensor:
    """Z-bar: rows (tokens) normalized to unit L2. z: [S,F] or [B,S,F]."""
    zf = z.float()
    n = zf.square().sum(dim=-1, keepdim=True).sqrt()
    return zf / torch.clamp(n, min=1e-20)


def heatmap_data(z: torch.Tensor, tokens: int = 512, feats: int = 512) -> np.ndarray:
    """|Z-bar| crop for Figure-1 style heat maps. z: [S,F]."""
    zb = relative_activations(z)
    return zb[:tokens, :feats].abs().cpu().numpy()


def flocking_score(z: torch.Tensor, top_frac: float = 0.05) -> float:
    """Scalar summary of flocking strength in one sequence.

    Mean pairwise Jaccard similarity between per-token top-``top_frac``
    neuron sets — high = tokens agree on which neurons matter (flocking).
    Computed via a set-membership product (no pairwise loops)."""
    zb = relative_activations(z).abs()  # [S,F]
    S, F = zb.shape
    k = max(1, int(F * top_frac))
    mem = torch.zeros((S, F), dtype=torch.float32, device=zb.device)
    mem.scatter_(1, top_k_indices(zb, k), 1.0)
    inter = mem @ mem.T  # [S,S] intersections
    jac = inter / (2 * k - inter)
    return float((jac.sum() - S) / (S * (S - 1)))


def sequence_statistic(z: torch.Tensor) -> torch.Tensor:
    """Eq. 6 statistic s for one sequence. z: [S,F] -> [F]."""
    return relative_activations(z).square().sum(dim=0).sqrt()


def jaccard_topk(s_a: torch.Tensor, s_b: torch.Tensor, k: int) -> float:
    """Jaccard similarity of two sequences' top-k expert sets (Figure 2)."""
    ia = set(top_k_indices(s_a, k).tolist())
    ib = set(top_k_indices(s_b, k).tolist())
    return len(ia & ib) / len(ia | ib)


def pairwise_jaccard(stats: List[torch.Tensor], k: int) -> np.ndarray:
    """Pairwise Jaccard across samples at top-k (Figure 2 aggregate)."""
    n = len(stats)
    return np.asarray([jaccard_topk(stats[i], stats[j], k)
                       for i in range(n) for j in range(i + 1, n)])
