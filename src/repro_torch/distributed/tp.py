"""Tensor parallelism for the paged serving path (port of
``repro/distributed/tp.py``).

One mesh axis (``model`` by default) carries head-parallel attention and
FF-hidden-parallel FFN through the whole paged step.  The reference runs
one program over all shards (``shard_map``); the port runs **one process
per rank** (``launch.mesh``), each with this rank's ``PagedTP``:

* **KV page pools** hold this rank's KV heads of every page
  (``[pages, page, KV/N, hd]``; int8/fp8 scale pools sliced along the
  same axis), so pool bytes per rank are total / N and the paged
  attention kernel runs unchanged on the local heads.  Block tables,
  positions, write masks and page counts are replicated host state:
  every rank gets the same submissions and schedules the same way.
* **Attention projections** hold this rank's heads; the out-projection's
  contraction over heads is a partial sum that ``sharding.psum_if_tp``
  all-reduces before the replicated bias.
* **FF weights** hold this rank's contiguous block of the hidden axis,
  including the per-slot GRIFFIN-compacted weights: the selection pads
  ``k_ff`` to a multiple of N (``GriffinConfig.k_of``) and balanced
  per-shard top-k puts exactly ``k/N`` experts in each rank's F-block, so
  every rank compacts its own block from its own weights
  (``griffin.select_and_compact(..., shard=)``) and the compacted decode
  needs one all-reduce after the down-projection, as the dense one.
* **Everything else is replicated** (embed table, LM head, norms,
  residual stream), so logits come out identical on every rank and the
  host scheduler and sampler need no rank-aware logic.

The per-rank step is the ordinary ``decoder.decode_step_paged`` /
``verify_step_paged`` / ``draft_verify_paged`` body run with a *local*
config (head counts divided by N) inside ``sharding.tp_axis``.  The
reference's ``probe`` and ``cow`` wrappers have no counterpart: the
port's flocking probe is a ``prefill`` with statistics (every step
writes the pools in place, and the server restores the pages a probe
touched), and ``decoder.copy_pool_pages`` copies whole pages of any head
count, so the server runs it on a rank's pools as they are.  The
GRIFFIN row norms are all-reduced inside the step (two-step
``expert_stat``, ``ffn.griffin_stat_sq``); the statistics themselves are
rank-local along F until ``gather_stats`` rebuilds the global ``[B, F]``
tree every rank selects from.

Placement (``shard_params`` / ``shard_pools`` / ``shard_pruned``) keeps
this rank's contiguous block along each resolved dimension: block j is
rank j, the shard-major order of the reference's ``NamedSharding``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.sharding import mesh_axis_size
from repro_torch.models import decoder
from repro_torch.models import param as param_lib

# innermost-dict leaf names of a (per-slot) compacted FF tree -> the
# logical axes of the *trailing* dims; leading dims (slot axis) are
# replicated
_PRUNED_AXES = {
    "w1": ("embed", "mlp"),
    "wg": ("embed", "mlp"),
    "w2": ("mlp", "embed"),
    "b1": ("mlp",),
    "bg": ("mlp",),
    "b2": ("act_embed",),
}

#: the statistics split along F (``x_sq`` is replicated)
_SHARDED_STATS = ("s_sq", "z_sq")


def gather_stats(stats: Optional[Dict[int, Dict]], mesh) -> Optional[Dict[int, Dict]]:
    """Rank-local GRIFFIN statistics -> the global layout on every rank.

    ``s_sq`` [B, F/N] and ``z_sq`` [F/N] hold this rank's contiguous
    F-block (rank j = block j, the global column order).  Each rank writes
    its blocks into one zeroed fp32 buffer of the global sizes and one
    ``all_reduce`` sums the ranks' buffers: exact, since every other term
    added to a value is 0.0, and it needs only ``all_reduce``, which gloo
    documents for CUDA tensors (not ``all_gather``).  ``x_sq`` is already
    replicated."""
    if stats is None:
        return None
    n, r = mesh.size, mesh.rank
    parts = [(li, k, leaf[k]) for li, leaf in stats.items()
             for k in _SHARDED_STATS if k in leaf]
    if not parts:
        return stats
    total = sum(t.numel() * n for _, _, t in parts)
    buf = torch.zeros(total, dtype=torch.float32, device=parts[0][2].device)
    out = {li: dict(leaf) for li, leaf in stats.items()}
    off = 0
    for li, k, t in parts:
        w = t.shape[-1]
        shape = tuple(t.shape[:-1]) + (w * n,)
        view = buf[off: off + t.numel() * n].view(shape)
        view[..., r * w: (r + 1) * w] = t
        out[li][k] = view
        off += t.numel() * n
    dist.all_reduce(buf, group=mesh.group)
    return out


def pool_shard_bytes(pools: Any) -> int:
    """Bytes of KV pool held by this rank (= total / N when the kv_heads
    axis is split N ways)."""
    if isinstance(pools, dict):
        return sum(pool_shard_bytes(v) for v in pools.values())
    if isinstance(pools, (list, tuple)):
        return sum(pool_shard_bytes(v) for v in pools)
    return pools.numel() * pools.element_size()


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor of a parameter tree (the same walk)."""
    return pool_shard_bytes(tree)


class PagedTP:
    """This rank's share of a tensor-parallel paged server: the resolved
    spec trees (params, pools, per-slot compacted FF), the local config,
    placement, and the per-rank step wrappers the server calls in place
    of its single-device steps."""

    def __init__(self, cfg, mesh, *, backend: str = "gather",
                 kv_dtype: str = "fp32"):
        axis = mesh.axis  # a ServingMesh is 1-D and names its axis
        self.cfg, self.mesh, self.axis, self.backend = cfg, mesh, axis, backend
        # quantized pools shard transparently: the scale pools carry the
        # same ("pages", None, "kv_heads", None) axes as the data, so each
        # rank holds its heads' scales and runs the same quantize program
        # on its local head slice
        self.kv_dtype = kv_dtype
        n = mesh_axis_size(mesh, axis)
        self.n = n
        self.rank = mesh.rank
        bad = {
            name: dim
            for name, dim in (
                ("num_heads", cfg.num_heads),
                ("num_kv_heads", cfg.num_kv_heads),
                ("d_ff", cfg.d_ff),
            )
            if dim % n != 0
        }
        if bad:
            raise ValueError(
                f"{cfg.name}: tensor-parallel paged serving needs every "
                f"sharded dim divisible by the {axis!r} axis (size {n}); "
                f"got {bad}. Head-axis sharding cannot replicate-fallback "
                f"here — the per-shard psums assume real partitioning."
            )
        self.cfg_local = cfg.replace(
            num_heads=cfg.num_heads // n, num_kv_heads=cfg.num_kv_heads // n
        )
        # shard ids of the mesh; each rank records its own step time under
        # its id (obs.stragglers)
        self.shard_ids = tuple(range(n))
        self.rules = shlib.make_paged_tp_rules(axis)
        self._param_shapes = decoder.model_specs(cfg)
        self.param_specs = shlib.tree_specs(self._param_shapes, mesh, self.rules)

    # -- spec trees --------------------------------------------------------
    def pool_pspecs(self, num_pages: int, page_size: int) -> Any:
        return shlib.tree_specs(
            decoder.paged_pool_specs(self.cfg, num_pages, page_size,
                                     self.kv_dtype),
            self.mesh, self.rules)

    def pruned_pspecs(self, pruned: Dict[int, Dict]) -> Dict[int, Dict]:
        """Spec tree of a (per-slot) compacted FF tree ``{li: {leaf:
        tensor}}`` of GLOBAL widths (leading slot dims replicated,
        trailing dims per ``_PRUNED_AXES``).  The compacted width must
        divide the axis — the selection guarantees it
        (``GriffinConfig.k_of`` with ``tp_shards``); a non-divisible width
        here is a config error, not a replicate-fallback case."""

        def leaf(path: str, key: str, arr) -> shlib.Spec:
            axes = _PRUNED_AXES[key]
            full = (None,) * (arr.ndim - len(axes)) + axes
            spec = shlib.spec_for(full, self.rules, self.mesh,
                                  tuple(arr.shape))
            if key != "b2" and self.axis not in spec:
                raise ValueError(
                    f"compacted FF leaf {path}/{key} with shape "
                    f"{tuple(arr.shape)} is not divisible by the "
                    f"{self.axis!r} axis (size {self.n}) — the divisible-"
                    f"k_ff rule holds per layer: pass a GriffinConfig with "
                    f"tp_shards={self.n} (tier budgets pad each layer's k to "
                    f"a multiple, see griffin.tier_k)."
                )
            return spec

        return {li: {k: leaf(f"layer{li}", k, v) for k, v in ffn.items()}
                for li, ffn in pruned.items()}

    # -- placement ---------------------------------------------------------
    def split_dims(self, spec: shlib.Spec):
        """The dimensions ``spec`` splits over this mesh's axis."""
        return [d for d, ax in enumerate(spec)
                if self.axis in ((ax,) if isinstance(ax, str) else (ax or ()))]

    def block(self, t: torch.Tensor, spec: shlib.Spec) -> torch.Tensor:
        """This rank's contiguous block of a global tensor along every
        dimension ``spec`` splits over the axis (a fresh tensor, so the
        global one can be freed)."""
        dims = self.split_dims(spec)
        if not dims or self.n == 1:
            return t
        out = t
        for d in dims:
            w = out.shape[d] // self.n
            out = out.narrow(d, self.rank * w, w)
        return out.clone()

    def _local_shape(self, shape, spec) -> Tuple[int, ...]:
        dims = self.split_dims(spec)
        return tuple(s // self.n if d in dims else s
                     for d, s in enumerate(shape))

    def _shard(self, tree: Any, specs: Any, shapes: Any = None,
               device=None) -> Any:
        if isinstance(tree, dict):
            return {k: self._shard(v, specs[k],
                                   None if shapes is None else shapes[k],
                                   device)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._shard(v, specs[i],
                                None if shapes is None else shapes[i], device)
                    for i, v in enumerate(tree)]
        out = None
        if shapes is not None:
            full = tuple(shapes.shape)
            if tuple(tree.shape) != full:
                if tuple(tree.shape) != self._local_shape(full, specs):
                    raise ValueError(
                        f"leaf of shape {tuple(tree.shape)} is neither the "
                        f"global {full} nor its block "
                        f"{self._local_shape(full, specs)}")
                out = tree  # already this rank's block
        if out is None:
            out = self.block(tree, specs)
        return out if device is None else out.to(device)

    def shard_params(self, params: Dict, device=None) -> Dict:
        """This rank's parameters from the global tree (leaves that are
        already this rank's block pass through), moved to ``device`` if
        given: a rank takes its blocks of a host tree without ever
        holding the whole model on its card."""
        return self._shard(params, self.param_specs, self._param_shapes,
                           device)

    def shard_pools(self, pools: Any, num_pages: int, page_size: int) -> Any:
        return self._shard(pools, self.pool_pspecs(num_pages, page_size))

    def shard_pruned(self, pruned: Dict[int, Dict]) -> Dict[int, Dict]:
        return self._shard(pruned, self.pruned_pspecs(pruned))

    def init_params(self, seed: int = 0, device=None) -> Dict:
        """This rank's block of ``decoder.init_params(cfg, seed, device)``,
        drawn leaf by leaf (each global leaf is drawn as the single-device
        init draws it, then cut), so the ranks together hold the single
        device's weights and no rank ever holds the whole model."""
        return param_lib.init_params(
            self._param_shapes, seed, self.cfg.dtype,
            torch.device(device) if device is not None else self.mesh.device,
            select=lambda s, t: self.block(
                t, shlib.spec_for(s.axes, self.rules, self.mesh, s.shape)))

    def init_pools(self, num_pages: int, page_size: int, device) -> Any:
        """Zeroed pools of this rank's KV heads."""
        return decoder.init_paged_pools(self.cfg_local, num_pages, page_size,
                                        self.kv_dtype, device)

    # -- step wrappers -----------------------------------------------------
    def prefill(self, params, pools, bt, tokens, pos, mask, pruned,
                collect: bool):
        """``decode_step_paged`` on this rank's shard; the statistics come
        back global (``gather_stats``)."""
        with shlib.tp_axis(self.mesh):
            logits, pools, stats = decoder.decode_step_paged(
                params, self.cfg_local, pools, bt, tokens, pos,
                write_mask=mask, pruned=pruned, collect_stats=collect,
                backend=self.backend, kv_dtype=self.kv_dtype,
            )
        return logits, pools, gather_stats(stats, self.mesh)

    def decode(self, params, pools, bts, toks, pos, mask, pruned):
        """A step without statistics: ``(logits, pools)``."""
        return self.prefill(params, pools, bts, toks, pos, mask, pruned,
                            False)[:2]

    def draft_verify(self, params, pools, bts, toks, pos, kr, live, pruned,
                     num_steps: int, spec_k: int):
        """The fused speculative round on this rank's shard: the draft
        loop's logits are replicated (all-reduced after the out- and
        down-projections), so every rank's in-loop ``argmax`` picks the
        same token and the verify matrix is identical across ranks."""
        with shlib.tp_axis(self.mesh):
            return decoder.draft_verify_paged(
                params, self.cfg_local, pools, bts, toks, pos, kr, live,
                pruned, num_steps=num_steps, spec_k=spec_k,
                backend=self.backend, kv_dtype=self.kv_dtype,
            )

    def verify(self, params, pools, bts, toks, pos, mask):
        with shlib.tp_axis(self.mesh):
            return decoder.verify_step_paged(
                params, self.cfg_local, pools, bts, toks, pos, mask,
                backend=self.backend, kv_dtype=self.kv_dtype,
            )
