"""Serving step functions: prefill (with GRIFFIN selection + compaction)
and decode on a contiguous cache (port of ``repro/serving/steps.py``).
PyTorch runs eagerly, so these are plain closures (the reference's are
jitted).

Inside ``sharding.axis_rules(mesh, rules)`` (a serving cell of
``launch.cells``) each step is one rank's shard of the mesh: the
parameters, cache and compacted FF are this rank's blocks under
``rules``, and the collectives the reference leaves to GSPMD are
written out (``decoder.forward`` / ``decode_step``,
``griffin.select_and_compact_mesh``).  At one rank the steps are the
single-device ones."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

from repro_torch.core import griffin as griffin_lib
from repro_torch.distributed import sharding as shlib
from repro_torch.models import decoder


def _on_mesh() -> bool:
    mesh, _ = shlib.active_rules()
    return mesh is not None and mesh.size > 1


def build_prefill_step(cfg, gcfg: Optional[griffin_lib.GriffinConfig],
                       q_chunk: int = 1024, *,
                       global_batch: Optional[int] = None) -> Callable:
    """prefill_step(params, tokens, prefix_emb=None)
    -> {last_logits [B, V], kv, pruned, experts, scores}.

    Runs the full model over the prompt (paper: full FF blocks in the
    prompt phase), collects the flocking statistic per FF layer (the
    ``expert_stat`` kernel on the card), selects expert neurons and
    compacts their weights for the generation phase; ``experts`` holds
    each layer's selection ``{li: idx}`` and ``scores`` the eq. 7
    statistic it was made from ``{li: s-bar [F]}`` (on a mesh: this
    rank's share of both, the indices global).  On a serving mesh (``global_batch``: the cell's
    batch, which the cache material's blocks are resolved for) the
    logits are this rank's block of rows and vocabulary and ``kv`` its
    blocks of the cache material (``decoder.kv_blocks``)."""
    use_griffin = gcfg is not None and cfg.griffin and cfg.has_ffn

    def prefill_step(params: Dict, tokens=None, prefix_emb=None) -> Dict:
        logits, aux = decoder.forward(
            params, cfg, tokens, prefix_emb, collect_stats=use_griffin,
            want_kv=True, q_chunk=q_chunk, logits_mode="last",
        )
        out = {"last_logits": logits[:, 0], "kv": aux.kv, "pruned": {},
               "experts": {}, "scores": {}}
        mesh = _on_mesh()
        if mesh:
            if global_batch is None:
                raise ValueError("a mesh prefill needs global_batch")
            S = sum(t.shape[1] for t in (prefix_emb, tokens) if t is not None)
            m, rules = shlib.active_rules()
            out["kv"] = decoder.kv_blocks(cfg, aux.kv, decoder.serve_specs(
                cfg, decoder.kv_specs(cfg, global_batch, S), m, rules))
        if use_griffin:
            stats = decoder.prune_stats_tree(aux.stats, cfg)
            ffn_tree = decoder.extract_ffn_tree(params, cfg)
            if mesh:
                out["pruned"], out["experts"], out["scores"] = \
                    griffin_lib.select_and_compact_mesh(stats, ffn_tree, gcfg, cfg)
            else:
                out["pruned"], _ = griffin_lib.select_and_compact(
                    stats, ffn_tree, gcfg,
                    on_select=lambda li, idx: out["experts"].__setitem__(li, idx))
                out["scores"] = {li: griffin_lib.aggregate_stats(st["s_sq"])
                                 for li, st in stats.items()}
        return out

    return prefill_step


def build_decode_step(cfg, use_pruned: bool, *,
                      cache_specs: Optional[List[Dict]] = None) -> Callable:
    """decode_step(params, cache, pruned, token, pos) -> (logits, cache);
    the cache is updated in place.  On a serving mesh ``cache_specs`` are
    the cache's resolved specs (``decoder.serve_specs``)."""

    def decode_step(params, cache, pruned, token, pos):
        return decoder.decode_step(params, cfg, cache, token, pos,
                                   pruned if use_pruned else None,
                                   cache_specs=cache_specs)

    return decode_step
