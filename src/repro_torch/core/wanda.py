"""Adaptive Wanda baseline (section 5.1; port of ``repro/core/wanda.py``).

Uses the full model for the prompt, then prunes FF *weights* (not
neurons) for generation using the prompt activations: the Wanda metric
|W| * ||x||_2 per weight, thresholded per output column to the target
sparsity.  Unstructured — it preserves quality like GRIFFIN but cannot
shrink the matmul shapes, the contrast the paper draws (Table 2).
"""
from __future__ import annotations

from typing import Dict

import torch


def wanda_mask(w: torch.Tensor, x_norm: torch.Tensor, sparsity: float) -> torch.Tensor:
    """w: [D_in, D_out]; x_norm: [D_in] prompt-activation L2 norms.
    Keeps the top (1-sparsity) weights per OUTPUT column by |w|*x_norm
    (every weight tied with the k-th largest is kept)."""
    metric = w.float().abs() * x_norm[:, None].float()
    k = max(1, int(round(w.shape[0] * (1.0 - sparsity))))
    kth = torch.sort(metric, dim=0, descending=True).values[k - 1]
    return metric >= kth[None, :]


def prune_ffn_wanda(ffn_params: Dict, x_norm: torch.Tensor,
                    z_norm: torch.Tensor, sparsity: float) -> Dict:
    """Apply Wanda masks to every FF matrix.

    x_norm: [D] L2 norms of prompt inputs to FF1;
    z_norm: [F] L2 norms of prompt activations (inputs to FF2)."""
    out = dict(ffn_params)
    for name, norm in (("w1", x_norm), ("wg", x_norm), ("w2", z_norm)):
        if name in ffn_params:
            w = ffn_params[name]
            out[name] = w * wanda_mask(w, norm, sparsity).to(w.dtype)
    return out


def activation_norms(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over all token positions. x: [B,S,D] -> [D] fp32."""
    xf = x.float().reshape(-1, x.shape[-1])
    return xf.square().sum(dim=0).sqrt()
