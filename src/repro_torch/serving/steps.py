"""Serving step functions: prefill (with GRIFFIN selection + compaction)
and decode on a contiguous cache (port of ``repro/serving/steps.py``).
PyTorch runs eagerly, so these are plain closures (the reference's are
jitted)."""
from __future__ import annotations

from typing import Callable, Dict, Optional

from repro_torch.core import griffin as griffin_lib
from repro_torch.models import decoder


def build_prefill_step(cfg, gcfg: Optional[griffin_lib.GriffinConfig],
                       q_chunk: int = 1024) -> Callable:
    """prefill_step(params, tokens, prefix_emb=None)
    -> {last_logits [B, V], kv, pruned}.

    Runs the full model over the prompt (paper: full FF blocks in the
    prompt phase), collects the flocking statistic per FF layer (the
    ``expert_stat`` kernel on the card), selects expert neurons and
    compacts their weights for the generation phase."""
    use_griffin = gcfg is not None and cfg.griffin and cfg.has_ffn

    def prefill_step(params: Dict, tokens=None, prefix_emb=None) -> Dict:
        logits, aux = decoder.forward(
            params, cfg, tokens, prefix_emb, collect_stats=use_griffin,
            want_kv=True, q_chunk=q_chunk, logits_mode="last",
        )
        out = {"last_logits": logits[:, 0], "kv": aux.kv, "pruned": {}}
        if use_griffin:
            stats = decoder.prune_stats_tree(aux.stats, cfg)
            ffn_tree = decoder.extract_ffn_tree(params, cfg)
            out["pruned"], _ = griffin_lib.select_and_compact(
                stats, ffn_tree, gcfg)
        return out

    return prefill_step


def build_decode_step(cfg, use_pruned: bool) -> Callable:
    """decode_step(params, cache, pruned, token, pos) -> (logits, cache);
    the cache is updated in place."""

    def decode_step(params, cache, pruned, token, pos):
        return decoder.decode_step(params, cfg, cache, token, pos,
                                   pruned if use_pruned else None)

    return decode_step
