"""GRIFFIN — Gating by Repetition In Feedforward Intermediate Neurons
(port of ``repro/core/griffin.py``).

1. **Prompt phase**: the model runs its full FF blocks and emits, per FF
   layer, ``s_sq[b, j] = sum_t z[b,t,j]^2 / ||z[b,t]||^2`` (eq. 6
   squared; ``ffn.griffin_stat_sq``).
2. **Selection**: ``select_experts`` reduces ``s_sq`` to one sorted
   expert index set per layer (eq. 7 batch aggregation).
3. **Generation phase**: ``compact`` gathers the expert neurons' weights
   so decode runs ``[D, k]`` / ``[k, D]`` products.

Tree layout: the port keeps one entry per layer, so every GRIFFIN tree
(statistics, FF params, compacted FF, widths) is a dict keyed by the
layer index ``li`` of each layer with a dense FF block.  Sparsity
profiles keep the reference's file format (``"seg{i}/{name}"`` paths
with one weight per scan instance); ``decoder.layer_paths`` maps them
onto layers.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import selector as selector_lib

DEFAULT_PER_SHARD_TOPK = True

# The serving tiers: the fraction of FF experts a request KEEPS.  1.0 is
# the dense path (no compaction at all).
TIERS = (0.25, 0.5, 0.75, 1.0)


def resolve_tier(tier) -> Optional[float]:
    """Validate a request tier. None means "no tier" (legacy global
    ``gcfg.k_of`` selection); otherwise the value must be one of TIERS."""
    if tier is None:
        return None
    try:
        t = float(tier)
    except (TypeError, ValueError):
        raise ValueError(f"tier must be a number in {TIERS}, got {tier!r}")
    for cand in TIERS:
        if abs(t - cand) < 1e-9:
            return cand
    raise ValueError(f"unknown sparsity tier {tier!r}; valid tiers: {TIERS}")


def tier_k(d_ff: int, tier: float, weight: float = 1.0,
           tp_shards: int = 1) -> int:
    """Expert count for one layer at a tier: ``round(d_ff * tier * w)``,
    clamped to [1, d_ff] and rounded up to a ``tp_shards`` multiple."""
    k = int(round(d_ff * float(tier) * float(weight)))
    k = max(1, min(d_ff, k))
    if tp_shards > 1:
        k = min(d_ff, -(-k // tp_shards) * tp_shards)
    return k


@dataclass(frozen=True)
class GriffinConfig:
    sparsity: float = 0.5          # fraction of FF neurons REMOVED
    mode: str = "topk"             # topk | sampling | topk_sampling | blocks
    block_size: int = 128          # for mode="blocks"
    per_shard_topk: bool = DEFAULT_PER_SHARD_TOPK  # balanced TP selection
    tp_shards: int = 1             # logical shard count for balanced top-k
    seed: int = 0                  # for sampling modes

    def k_of(self, d_ff: int) -> int:
        """Expert count for an FF width of ``d_ff`` (rounded up to a
        ``tp_shards`` multiple when sharded)."""
        k = int(round(d_ff * (1.0 - self.sparsity)))
        k = max(1, min(d_ff, k))
        if self.tp_shards > 1:
            k = min(d_ff, -(-k // self.tp_shards) * self.tp_shards)
        return k

    def replace(self, **kw) -> "GriffinConfig":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class SparsityProfile:
    """Per-layer expert-budget weights.

    ``weights`` maps FF-layer paths of the reference layout
    (``"seg{i}/{name}"``) to per-instance multipliers: a scan-stacked
    layer with ``n`` instances carries ``n`` weights, an unrolled layer
    one.  A layer at tier ``t`` keeps ``tier_k(F, t, w)`` experts; a
    missing path defaults to weight 1.0 (the uniform profile)."""
    weights: Tuple[Tuple[str, Tuple[float, ...]], ...] = ()
    arch: str = ""
    note: str = ""

    def __post_init__(self):
        for path, ws in self.weights:
            for w in ws:
                if not (w > 0.0):
                    raise ValueError(
                        f"profile weight for {path!r} must be > 0, got {w}")

    def weight_map(self) -> Dict[str, Tuple[float, ...]]:
        return dict(self.weights)

    def weights_for(self, path: str, n: int) -> Tuple[float, ...]:
        ws = self.weight_map().get(path)
        if ws is None:
            return (1.0,) * n
        if len(ws) != n:
            raise ValueError(
                f"profile for {path!r} carries {len(ws)} weights but the "
                f"layer has {n} instances"
            )
        return tuple(float(w) for w in ws)

    @classmethod
    def uniform(cls, arch: str = "") -> "SparsityProfile":
        return cls(weights=(), arch=arch, note="uniform")

    def to_json(self) -> str:
        return json.dumps(
            {
                "arch": self.arch,
                "note": self.note,
                "weights": {p: list(ws) for p, ws in self.weights},
            },
            indent=2, sort_keys=True,
        )

    @classmethod
    def from_json(cls, text: str) -> "SparsityProfile":
        d = json.loads(text)
        return cls(
            weights=tuple(sorted(
                (str(p), tuple(float(w) for w in ws))
                for p, ws in d.get("weights", {}).items()
            )),
            arch=str(d.get("arch", "")),
            note=str(d.get("note", "")),
        )

    def save(self, path) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path) -> "SparsityProfile":
        with open(path) as f:
            return cls.from_json(f.read())


def aggregate_stats(s_sq: torch.Tensor,
                    seq_lens: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. 7: s-bar = sum_i s_i / sqrt(S_i) over the batch axis.
    s_sq: [B, F] per-sample *squared* statistics; returns [F]."""
    s = torch.sqrt(torch.clamp(s_sq.float(), min=0.0))
    if seq_lens is not None:
        s = s / torch.sqrt(seq_lens.float())[:, None]
    return s.sum(dim=0)


def select_experts(
    s_sq: torch.Tensor,
    gcfg: GriffinConfig,
    d_ff: Optional[int] = None,
    seq_lens: Optional[torch.Tensor] = None,
    k: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Reduce statistics to a sorted expert index set.

    s_sq: [B, F] (batch aggregated via eq. 7) or [F].  ``k`` overrides
    the global ``gcfg.k_of(F)`` budget.  The sampling modes draw from
    ``generator`` (on the statistics' device; the reference takes a
    ``PRNGKey``).  Returns idx [k] int64, sorted."""
    s = (
        aggregate_stats(s_sq, seq_lens)
        if s_sq.ndim == 2
        else torch.sqrt(torch.clamp(s_sq.float(), min=0.0))
    )
    return select_from_scores(s, gcfg, d_ff, k, generator)


def select_from_scores(s: torch.Tensor, gcfg: GriffinConfig,
                       d_ff: Optional[int] = None, k: Optional[int] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """``select_experts`` on the aggregated statistic s-bar [F]."""
    F = d_ff or s.shape[-1]
    k = gcfg.k_of(F) if k is None else int(k)
    if gcfg.mode == "blocks":
        return selector_lib.select_blocks(s, k, gcfg.block_size)
    if gcfg.mode == "sampling":
        return selector_lib.select_sampling(s, k, generator)
    if gcfg.mode == "topk_sampling":
        return selector_lib.select_topk_sampling(s, k, generator)
    if gcfg.per_shard_topk and gcfg.tp_shards > 1 and F % gcfg.tp_shards == 0 \
            and k % gcfg.tp_shards == 0:
        return selector_lib.select_topk_per_shard(s, k, gcfg.tp_shards)
    return selector_lib.select_topk(s, k)


def compact(ffn_params: Dict, idx: torch.Tensor, shards: int = 1) -> Dict:
    """Paper reparameterization: gather the expert neurons' weights."""
    from repro_torch.models.layers.ffn import compact_ffn_params

    return compact_ffn_params(ffn_params, idx, shards=shards)


# ---------------------------------------------------------------------------
# Whole-model helpers over per-layer trees ({li: leaf})
# ---------------------------------------------------------------------------

def _s_sq(leaf) -> torch.Tensor:
    return leaf["s_sq"] if isinstance(leaf, dict) else leaf


def select_tree(stats_tree: Dict[int, Any], gcfg: GriffinConfig,
                seq_lens: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Dict[int, torch.Tensor]:
    """Per-layer selection at the global budget: ``{li: idx [k]}``.  The
    sampling modes draw each layer's noise from ``generator`` in turn
    (the reference reuses one key for every layer)."""
    return {li: select_experts(_s_sq(leaf), gcfg, seq_lens=seq_lens,
                               generator=generator)
            for li, leaf in stats_tree.items()}


def compact_tree(ffn_params_tree: Dict[int, Dict],
                 idx_tree: Dict[int, torch.Tensor], shards: int = 1) -> Dict:
    """Compact every FF block of a per-layer params tree."""
    return {li: compact(ffn_params_tree[li], idx, shards=shards)
            for li, idx in idx_tree.items()}


def ffn_widths(cfg) -> Dict[int, int]:
    """``{li: d_ff}`` for every GRIFFIN-prunable FF block: a dense FF, or
    the MoE shared experts at ``moe_d_ff * num_shared_experts`` (mirrors
    ``decoder.extract_ffn_tree``)."""
    from repro_torch.models import decoder

    out: Dict[int, int] = {}
    for li, d in enumerate(decoder.layer_descs(cfg)):
        if d.ffn == "dense":
            out[li] = cfg.d_ff
        elif d.ffn == "moe" and cfg.num_shared_experts:
            out[li] = cfg.moe_d_ff * cfg.num_shared_experts
    return out


def plan_k_tree(
    cfg,
    gcfg: GriffinConfig,
    tier: Optional[float] = None,
    profile: Optional[SparsityProfile] = None,
) -> Dict[int, int]:
    """Per-layer expert budgets ``{li: k}``.  ``tier is None`` is the
    legacy path (every layer ``gcfg.k_of(F)``); with a tier, each layer
    keeps ``tier_k(F, tier, profile_weight, tp_shards)`` experts, the
    weight read from the profile at the layer's reference path."""
    from repro_torch.models import decoder

    paths = decoder.layer_paths(cfg)
    prof = profile or SparsityProfile.uniform()
    out: Dict[int, int] = {}
    for li, F in ffn_widths(cfg).items():
        if tier is None:
            k = gcfg.k_of(F)
        else:
            path, inst, n = paths[li]
            w = prof.weights_for(path, n)[inst]
            k = tier_k(F, tier, w, gcfg.tp_shards)
        out[li] = selector_lib.selected_width(gcfg.mode, k, F, gcfg.block_size)
    return out


def compaction_shards(gcfg: GriffinConfig, k: int, d_ff: int) -> int:
    """TP degree for the shard-local compaction gather (1 unless the
    selection was per-shard balanced top-k with divisible widths)."""
    sh = gcfg.tp_shards
    if (
        sh > 1
        and gcfg.per_shard_topk
        and gcfg.mode == "topk"
        and d_ff % sh == 0
        and k % sh == 0
    ):
        return sh
    return 1


def shard_indices(idx: torch.Tensor, d_ff: int, rank: int, n: int) -> torch.Tensor:
    """The experts of a global selection ``idx`` [k] that fall in rank
    ``rank``'s contiguous F-block of ``d_ff / n`` neurons, as local
    indices.  Balanced per-shard top-k puts exactly ``k / n`` in every
    block; any other count raises (the rank could not compact from its
    own weights)."""
    w = d_ff // n
    lo = rank * w
    local = idx[(idx >= lo) & (idx < lo + w)] - lo
    if local.numel() * n != idx.numel():
        raise ValueError(
            f"selection of {idx.numel()} experts puts {local.numel()} in "
            f"rank {rank}'s block of {w}, not {idx.numel()} / {n}: "
            f"tensor-parallel compaction needs balanced per-shard top-k "
            f"(GriffinConfig(mode='topk', per_shard_topk=True, "
            f"tp_shards={n}))")
    return local


def select_and_compact(
    stats_tree: Dict[int, Any],
    ffn_tree: Dict[int, Dict],
    gcfg: GriffinConfig,
    *,
    ks: Optional[Dict[int, int]] = None,
    seq_lens: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    on_select=None,
    shard: Optional[Tuple[int, int]] = None,
) -> Tuple[Dict[int, Dict], Dict[int, int]]:
    """Selection + compaction with per-layer expert budgets — the one
    entry point of the serving path.

    ``stats_tree``/``ffn_tree`` come from ``decoder.prune_stats_tree`` /
    ``decoder.extract_ffn_tree``; ``ks`` from ``plan_k_tree`` (None ->
    the global ``gcfg.k_of`` budget everywhere).  Every layer has its own
    buffer, so each keeps its natural width (the reference pads the
    instances of a scan-stacked leaf to the widest one).
    ``generator`` feeds the sampling modes.  ``on_select(li, idx)``
    observes each raw selection.
    ``shard=(rank, n)``: ``ffn_tree`` holds a tensor-parallel rank's
    F-block of every layer; the selection runs on the global statistics
    as without it, and the rank compacts its own experts
    (``shard_indices``) from its own weights — width ``k / n``.
    Returns ``(pruned_tree, widths)`` with ``widths[li]`` = the layer's
    (global) buffer width."""
    out: Dict[int, Dict] = {}
    widths: Dict[int, int] = {}
    for li, leaf in stats_tree.items():
        s_sq = _s_sq(leaf)
        F = s_sq.shape[-1]
        idx = select_experts(s_sq, gcfg, seq_lens=seq_lens,
                             k=None if ks is None else ks[li],
                             generator=generator)
        if on_select is not None:
            on_select(li, idx)
        widths[li] = int(idx.shape[0])
        if shard is not None:
            out[li] = compact(ffn_tree[li], shard_indices(idx, F, *shard))
        else:
            out[li] = compact(ffn_tree[li], idx,
                              shards=compaction_shards(gcfg, widths[li], F))
    return out, widths


def select_and_compact_mesh(
    stats_tree: Dict[int, Any],
    ffn_tree: Dict[int, Dict],
    gcfg: GriffinConfig,
    cfg,
    *,
    ks: Optional[Dict[int, int]] = None,
) -> Tuple[Dict[int, Dict], Dict[int, torch.Tensor], Dict[int, torch.Tensor]]:
    """``select_and_compact`` on this rank's shard of a serving mesh
    (``sharding.axis_rules``): ``stats_tree`` holds the statistics of this
    data rank's rows and of its ``model`` block of each F axis,
    ``ffn_tree`` its blocks of the FF weights.

    Eq. 7's sum over the batch is all-reduced over the batch axes, so
    every data rank selects the same neurons.  Balanced per-shard top-k
    (``tp_shards`` a multiple of the ``model`` extent) keeps ``k / n`` of
    each rank's block, the global selection's share of it
    (``shard_indices``), found from the block alone; the rank compacts
    its own block.  Returns ``(pruned blocks, {li: this rank's experts
    as global indices}, {li: this rank's block of s-bar})``."""
    from repro_torch.distributed import sharding as shlib

    mesh, rules = shlib.active_rules()
    baxes = shlib.batch_axes(mesh, rules)
    widths = ffn_widths(cfg)
    ks = ks or plan_k_tree(cfg, gcfg)
    out: Dict[int, Dict] = {}
    experts: Dict[int, torch.Tensor] = {}
    scores: Dict[int, torch.Tensor] = {}
    for li, leaf in stats_tree.items():
        s_sq = _s_sq(leaf)
        F_loc, F, k = s_sq.shape[-1], widths[li], ks[li]
        s = scores[li] = shlib.psum(aggregate_stats(s_sq), baxes)
        n = F // F_loc
        if n == 1:
            idx = select_from_scores(s, gcfg, F, k)
            r = 0
        else:
            sh = gcfg.tp_shards
            if not (gcfg.mode == "topk" and gcfg.per_shard_topk and sh % n == 0
                    and F % sh == 0 and k % sh == 0):
                raise ValueError(
                    f"layer {li}: a mesh prefill over a {n}-way split F needs "
                    f"balanced per-shard top-k with tp_shards a multiple of "
                    f"{n} dividing F={F} and k={k} (got {gcfg})")
            idx = selector_lib.select_topk_per_shard(s, k // n, sh // n)
            r = mesh.coord("model")
        out[li] = compact(ffn_tree[li], idx)
        experts[li] = idx + r * F_loc
    return out, experts, scores


def pad_pruned_tree(pruned: Dict[int, Dict], widths: Dict[int, int],
                    shards: int = 1) -> Dict[int, Dict]:
    """Pad every layer of a compacted tree to ``widths[li]`` experts
    (zero ``w2`` rows — bit-exact; see ``ffn.pad_compacted``).  Layers
    already at their target width pass through untouched."""
    from repro_torch.models.layers.ffn import pad_compacted

    return {li: pad_compacted(ffn, widths[li], shards=shards)
            for li, ffn in pruned.items()}
