"""Token sampling: greedy / temperature / top-k / top-p (nucleus), plus
the speculative-decoding acceptance rules (port of
``repro/serving/sampling.py``).

Two verify rules for self-speculative decoding (serving/server.py):

* ``greedy_verify`` — deterministic acceptance: a draft token is kept
  iff it equals the dense model's argmax at that position.  Output is
  token-identical to vanilla greedy decoding of the dense model.
* ``speculative_verify`` — the standard speculative-sampling rule
  (Leviathan et al. 2023; Chen et al. 2023): accept draft token ``d``
  with probability ``min(1, p(d)/q(d))``, on rejection resample from
  the leftover distribution ``norm(max(p - q, 0))``.  The committed
  token stream is distributed exactly as sampling from the dense model
  ``p`` alone, for any draft ``q``.

Both run on the host in numpy over a ``[k+1, V]`` slice of verify
logits, as in the reference, so given the same ``np.random.Generator``
they give the reference's results draw for draw.

``sample`` draws from an explicit ``torch.Generator``.  torch cannot
reproduce ``jax.random`` streams, so its greedy path (and ``top_k=1``)
is exact and its draws match the reference's only in distribution.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.0  # 0 => greedy
    top_k: int = 0
    top_p: float = 1.0


def sample(logits: torch.Tensor, generator: Optional[torch.Generator],
           sc: SamplingConfig) -> torch.Tensor:
    """logits: [B, V] fp32 -> tokens [B] int32.  ``generator`` lives on
    ``logits``' device (unused when greedy)."""
    if sc.temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits / sc.temperature
    if sc.top_k:
        kth = torch.sort(logits, dim=-1).values[:, -sc.top_k][:, None]
        logits = torch.where(logits >= kth, logits, -torch.inf)
    if sc.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.sum(cum < sc.top_p, dim=-1)  # first index past p
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = torch.where(logits >= cutoff, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


# ---------------------------------------------------------------------------
# Speculative-decoding acceptance rules
# ---------------------------------------------------------------------------

def greedy_verify(
    target_logits: np.ndarray, draft_tokens: Sequence[int]
) -> Tuple[List[int], int]:
    """Greedy acceptance walk over one verify step's logits.

    ``target_logits``: [k+1, V] dense-model logits; row ``i`` scores the
    position right after verify input ``i`` (input 0 is the last
    committed token, inputs 1..k are the draft).  ``draft_tokens``: the
    ``k`` drafted tokens.

    Returns ``(committed, n_accepted)``: accepted draft tokens followed
    by one correction (first dense argmax that disagrees) or, if all
    drafts survive, the bonus token from the final row.  Always commits
    at least one token, and the committed stream equals vanilla greedy
    decoding of the dense model.
    """
    k = len(draft_tokens)
    assert target_logits.shape[0] == k + 1, target_logits.shape
    committed: List[int] = []
    for i, d in enumerate(draft_tokens):
        t = int(np.argmax(target_logits[i]))
        committed.append(t)
        if t != int(d):
            return committed, i
    committed.append(int(np.argmax(target_logits[k])))
    return committed, k


def _probs(logits: np.ndarray, temperature: float) -> np.ndarray:
    x = logits.astype(np.float64) / max(temperature, 1e-8)
    x = x - np.max(x, axis=-1, keepdims=True)
    e = np.exp(x)
    return e / np.sum(e, axis=-1, keepdims=True)


def speculative_verify(
    target_logits: np.ndarray,
    draft_logits: np.ndarray,
    draft_tokens: Sequence[int],
    rng: np.random.Generator,
    temperature: float = 1.0,
) -> Tuple[List[int], int]:
    """Standard speculative sampling (lossless w.r.t. the dense model).

    ``target_logits``: [k+1, V] dense verify logits; ``draft_logits``:
    [k, V] draft logits that produced ``draft_tokens``.  Draft token
    ``d_i`` is accepted with probability ``min(1, p_i(d_i)/q_i(d_i))``;
    on rejection the replacement is drawn from ``norm(max(p_i - q_i,
    0))``, and if every draft is accepted a bonus token is drawn from
    the final dense row.  Returns ``(committed, n_accepted)``.
    """
    k = len(draft_tokens)
    assert target_logits.shape[0] == k + 1, target_logits.shape
    assert draft_logits.shape[0] == k, draft_logits.shape
    p = _probs(target_logits, temperature)
    q = _probs(draft_logits, temperature)
    committed: List[int] = []
    for i, d in enumerate(draft_tokens):
        d = int(d)
        if rng.random() < min(1.0, p[i, d] / max(q[i, d], 1e-20)):
            committed.append(d)
            continue
        leftover = np.maximum(p[i] - q[i], 0.0)
        total = leftover.sum()
        if total <= 0.0:  # p == q: any rejection is measure-zero; resample p
            leftover, total = p[i], 1.0
        committed.append(int(rng.choice(len(leftover), p=leftover / total)))
        return committed, i
    committed.append(int(rng.choice(p.shape[-1], p=p[k])))
    return committed, k
