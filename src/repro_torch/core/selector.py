"""Expert-neuron selection (port of ``repro/core/selector.py``).

``select_topk`` is the paper's default; ``select_sampling`` /
``select_topk_sampling`` are the Appendix B ablations (weighted
sampling without replacement by Gumbel top-k); ``select_blocks`` the
block-aligned mode, ``select_topk_per_shard`` the balanced TP variant;
``magnitude_statistic`` the static baseline of section 5.1.

All selectors return **sorted** int64 indices (``select_block_ids``:
int32 block ids, the kernel's input).  Ties break toward the
lower index, as ``jax.lax.top_k`` does: the top-k is a *stable*
descending sort, never a bare ``torch.topk`` (whose tie order on CUDA is
unspecified).

The sampling selectors draw their Gumbel noise from an explicit
``torch.Generator``; torch cannot reproduce ``jax.random`` streams, so
the Gumbel top-k itself is kept apart (``gumbel_top_k``,
``topk_gumbel_top_k``) and takes the noise as a tensor.
"""
from __future__ import annotations

from typing import Optional

import torch


def top_k_indices(s: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, in
    descending order, lower index first among equals."""
    return torch.sort(s, dim=-1, descending=True, stable=True).indices[..., :k]


def select_topk(s: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k neurons by statistic. s: [F] -> idx [k] sorted."""
    return torch.sort(top_k_indices(s, k)).values


def select_topk_per_shard(s: torch.Tensor, k: int, shards: int) -> torch.Tensor:
    """Balanced top-(k/shards) within each contiguous F/shards shard."""
    F = s.shape[-1]
    fs, ks = F // shards, k // shards
    idx = top_k_indices(s.reshape(shards, fs), ks)  # [shards, ks]
    idx = idx + (torch.arange(shards, device=s.device) * fs)[:, None]
    return torch.sort(idx.reshape(-1)).values


def select_blocks(s: torch.Tensor, k: int, block: int) -> torch.Tensor:
    """Block-aligned selection: sum-pool s^2 over contiguous blocks of
    ``block`` neurons, keep the top-(k//block) blocks' neurons."""
    assert s.shape[-1] % block == 0, (s.shape[-1], block)
    bidx = select_block_ids(s, k, block).long()
    idx = bidx[:, None] * block + torch.arange(block, device=s.device)[None, :]
    return idx.reshape(-1)


def select_block_ids(s: torch.Tensor, k: int, block: int) -> torch.Tensor:
    """Block ids only, sorted, int32: the ``block_ids`` input of the
    pruned decode FF kernel (``ops.griffin_ffn_decode``)."""
    F = s.shape[-1]
    nb = F // block
    kb = max(1, k // block)
    pooled = s.reshape(nb, block).square().sum(dim=-1)
    return torch.sort(top_k_indices(pooled, kb)).values.to(torch.int32)


def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, fp32, ``u`` uniform in
    ``[tiny, 1)`` drawn from ``generator`` (on ``device``)."""
    if generator is None:
        raise ValueError("sampling selection needs a torch.Generator")
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _log_weights(s: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(s.float(), min=1e-20))


def gumbel_top_k(s: torch.Tensor, k: int, g: torch.Tensor) -> torch.Tensor:
    """Weighted sampling of ``k`` neurons without replacement, weights
    ``s``, given the Gumbel noise ``g`` (same shape as ``s``)."""
    return torch.sort(top_k_indices(_log_weights(s) + g, k)).values


def topk_gumbel_top_k(s: torch.Tensor, k: int, g: torch.Tensor) -> torch.Tensor:
    """The top ``k // 2`` neurons, then ``k - k // 2`` more sampled from
    the rest by weight ``s``, given the Gumbel noise ``g``."""
    k1 = k // 2
    top = top_k_indices(s, k1)
    logw = _log_weights(s)
    logw[top] = -torch.inf
    rest = top_k_indices(logw + g, k - k1)
    return torch.sort(torch.cat([top, rest])).values


def select_sampling(s: torch.Tensor, k: int,
                    generator: Optional[torch.Generator]) -> torch.Tensor:
    """Appendix B: weighted sampling without replacement (Gumbel top-k)."""
    return gumbel_top_k(s, k, gumbel_noise(s.shape, generator, s.device))


def select_topk_sampling(s: torch.Tensor, k: int,
                         generator: Optional[torch.Generator]) -> torch.Tensor:
    """Appendix B: top-k/2 deterministic + weighted sampling for the rest."""
    return topk_gumbel_top_k(s, k, gumbel_noise(s.shape, generator, s.device))


def selected_width(mode: str, k: int, d_ff: int, block: int = 128) -> int:
    """The index count a selector returns for a requested ``k``
    (``select_blocks`` rounds to whole blocks)."""
    if mode == "blocks":
        return max(1, k // block) * block
    return k


# ---------------------------------------------------------------------------
# Static baselines (section 5 comparisons)
# ---------------------------------------------------------------------------

def magnitude_statistic(ffn_params: dict) -> torch.Tensor:
    """Static neuron-magnitude pruning metric (section 5.1 baseline):
    neuron-wise L2 norms of W1, times those of W_g for GLU variants."""
    def norms(w):
        return w.float().square().sum(dim=0).sqrt()

    s = norms(ffn_params["w1"])
    if "wg" in ffn_params:
        s = s * norms(ffn_params["wg"])
    return s
