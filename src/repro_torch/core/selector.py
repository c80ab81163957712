"""Expert-neuron selection (port of ``repro/core/selector.py``: the
deterministic selectors; the sampling ablations wait for a later slice).

All selectors return **sorted** int64 indices (``select_block_ids``:
int32 block ids, the kernel's input).  Ties break toward the
lower index, as ``jax.lax.top_k`` does: the top-k is a *stable*
descending sort, never a bare ``torch.topk`` (whose tie order on CUDA is
unspecified).
"""
from __future__ import annotations

import torch

SAMPLING_TODO = (
    "sampling selectors are not ported yet (ROADMAP Queue A: off-path "
    "modules)"
)


def _top_k_idx(s: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries along the last axis, in
    descending order, lower index first among equals."""
    return torch.sort(s, dim=-1, descending=True, stable=True).indices[..., :k]


def select_topk(s: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k neurons by statistic. s: [F] -> idx [k] sorted."""
    return torch.sort(_top_k_idx(s, k)).values


def select_topk_per_shard(s: torch.Tensor, k: int, shards: int) -> torch.Tensor:
    """Balanced top-(k/shards) within each contiguous F/shards shard."""
    F = s.shape[-1]
    fs, ks = F // shards, k // shards
    idx = _top_k_idx(s.reshape(shards, fs), ks)  # [shards, ks]
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
    return torch.sort(_top_k_idx(pooled, kb)).values.to(torch.int32)


def selected_width(mode: str, k: int, d_ff: int, block: int = 128) -> int:
    """The index count a selector returns for a requested ``k``
    (``select_blocks`` rounds to whole blocks)."""
    if mode == "blocks":
        return max(1, k // block) * block
    return k
