"""Paper evaluation protocols (sections 5.1, 5.3; port of
``repro/core/evaluate.py``).

* ``generation_ppl`` — Figure 5's protocol: a length-S sequence is split
  into prompt (first P, full FF blocks, builds the KV cache) and
  generation (last G, teacher-forced through the *pruned* decode path);
  reports perplexity over the generation partition only.
* ``classification_sim`` — Table 1's protocol: all tokens but the last
  are the prompt; the model takes one generation step; reports NLL of
  the gold last token + top-1 agreement with the full model.
* Methods: full | griffin | griffin_batched (eq. 7 across the batch) |
  magnitude (static neuron pruning) | wanda (Adaptive Wanda, unstructured)
  | sampling / topk_sampling (Appendix B) | blocks (block-aligned).

The sampling methods draw from an explicit ``torch.Generator`` (on the
parameters' device) where the reference takes a ``PRNGKey``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import griffin as griffin_lib
from repro_torch.core import selector as selector_lib
from repro_torch.core import wanda as wanda_lib
from repro_torch.models import decoder

METHODS = ("full", "griffin", "griffin_batched", "magnitude", "wanda",
           "sampling", "topk_sampling", "blocks")


def build_pruned(
    method: str,
    params: Dict,
    cfg,
    stats: Optional[Dict],
    sparsity: float,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Optional[Dict], Optional[Dict]]:
    """Returns (pruned_ffn_tree, replacement_params).

    At most one is non-None: structured methods compact weights (pruned
    tree ``{li: ffn}`` fed to the decode path); wanda masks them in
    place (replacement full-shape params); full returns neither."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; valid: {METHODS}")
    if method == "full":
        return None, None
    ffn_tree = decoder.extract_ffn_tree(params, cfg)

    if method == "wanda":
        st = decoder.prune_stats_tree(stats, cfg)
        masked = {li: wanda_lib.prune_ffn_wanda(
            p, torch.sqrt(st[li]["x_sq"]), torch.sqrt(st[li]["z_sq"]), sparsity)
            for li, p in ffn_tree.items()}
        return None, replace_ffn_tree(params, cfg, masked)

    if method == "magnitude":
        def sel_one(p):
            s = selector_lib.magnitude_statistic(p)
            k = max(1, int(round(s.shape[-1] * (1.0 - sparsity))))
            return selector_lib.select_topk(s, k)

        idx_tree = {li: sel_one(p) for li, p in ffn_tree.items()}
        return griffin_lib.compact_tree(ffn_tree, idx_tree), None

    # GRIFFIN variants
    mode = {"griffin": "topk", "griffin_batched": "topk",
            "sampling": "sampling", "topk_sampling": "topk_sampling",
            "blocks": "blocks"}[method]
    gcfg = griffin_lib.GriffinConfig(sparsity=sparsity, mode=mode,
                                     per_shard_topk=False)
    st = decoder.prune_stats_tree(stats, cfg)
    sel = griffin_lib.select_tree(st, gcfg, generator=generator)
    return griffin_lib.compact_tree(ffn_tree, sel), None


def replace_ffn_tree(params: Dict, cfg, new_ffn: Dict[int, Dict]) -> Dict:
    """A copy of ``params`` (sharing every untouched tensor) whose
    prunable FF blocks (dense FF / MoE shared experts) are replaced by
    ``new_ffn[li]``."""
    descs = decoder.layer_descs(cfg)

    def one(li, lp):
        if li not in new_ffn:
            return lp
        if descs[li].ffn == "moe":
            return dict(lp, ffn=dict(lp["ffn"], shared=new_ffn[li]))
        return dict(lp, ffn=new_ffn[li])

    out = dict(params)
    out["layers"] = [one(li, lp) for li, lp in enumerate(params["layers"])]
    return out


def _device(params: Dict) -> torch.device:
    return params["embed"]["table"].device


def prompt_stats(params, cfg, prompt):
    """Full-model prompt pass: last logits, cache material, stats."""
    logits, aux = decoder.forward(
        params, cfg, prompt, collect_stats=True, want_kv=True,
        logits_mode="last", q_chunk=256,
    )
    return logits[:, 0], aux


def generation_ppl(
    params: Dict,
    cfg,
    tokens,  # [B, S]
    prompt_len: int,
    method: str,
    sparsity: float = 0.5,
    generator: Optional[torch.Generator] = None,
) -> float:
    """Teacher-forced PPL of tokens[P:] with the prompt encoded by the
    FULL model (its KV cache) and generation through the pruned path.
    The per-step NLL sums stay on the device until the end (one host
    sync per call)."""
    tokens = torch.as_tensor(tokens, device=_device(params))
    B, S = tokens.shape
    P = prompt_len
    _, aux = prompt_stats(params, cfg, tokens[:, :P])
    pruned, repl = build_pruned(method, params, cfg, aux.stats, sparsity,
                                generator)
    run_params = repl if repl is not None else params

    cache = decoder.init_cache(cfg, B, S, tokens.device)
    cache = decoder.fill_cache_from_prefill(cfg, cache, aux.kv)
    del aux
    nll = []
    for t in range(P - 1, S - 1):
        logits, cache = decoder.decode_step(
            run_params, cfg, cache, tokens[:, t : t + 1], t, pruned)
        logp = torch.log_softmax(logits[:, 0].float(), dim=-1)
        gold = tokens[:, t + 1].long()
        nll.append(-logp.gather(1, gold[:, None]).sum())
    count = B * len(nll)
    nll_sum = float(torch.stack(nll).double().sum()) if nll else 0.0
    return float(np.exp(nll_sum / max(count, 1)))


def classification_sim(
    params: Dict,
    cfg,
    tokens,  # [B, S]: first S-1 = prompt, last = the "class"
    method: str,
    sparsity: float = 0.5,
    generator: Optional[torch.Generator] = None,
) -> Dict[str, float]:
    """Table-1 protocol: one generation step after an (S-1)-token prompt.

    The pruned and the full step both start from the prompt's cache.  The
    port's ``decode_step`` writes the cache in place, so the full step
    sees the slot ``S-2`` the pruned step wrote — and rewrites it before
    reading it, so both steps see what the reference's functional caches
    give them."""
    tokens = torch.as_tensor(tokens, device=_device(params))
    B, S = tokens.shape
    prompt = tokens[:, : S - 1]
    _, aux = prompt_stats(params, cfg, prompt)
    pruned, repl = build_pruned(method, params, cfg, aux.stats, sparsity,
                                generator)
    run_params = repl if repl is not None else params

    cache = decoder.init_cache(cfg, B, S, tokens.device)
    cache = decoder.fill_cache_from_prefill(cfg, cache, aux.kv)
    last = tokens[:, S - 2 : S - 1]
    logits, cache = decoder.decode_step(run_params, cfg, cache, last, S - 2,
                                        pruned)
    logits_full, _ = decoder.decode_step(params, cfg, cache, last, S - 2, None)
    logp = torch.log_softmax(logits[:, 0].float(), dim=-1)
    gold = tokens[:, -1].long()
    pred = torch.argmax(logits[:, 0], dim=-1)
    return {
        "nll": float(-logp.gather(1, gold[:, None]).mean()),
        "agree_full": float((pred == torch.argmax(logits_full[:, 0], dim=-1))
                            .float().mean()),
        "acc": float((pred == gold).float().mean()),
    }
