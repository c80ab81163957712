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
    shlib.record("all-gather", buf.numel() * 4, mesh.group)
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

    def slices(self, spec: shlib.Spec, shape) -> Tuple[slice, ...]:
        """This rank's block of a leaf of global ``shape``."""
        dims = self.split_dims(spec)
        return tuple(slice(self.rank * (s // self.n), (self.rank + 1) * (s // self.n))
                     if d in dims else slice(None) for d, s in enumerate(shape))

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
        drawn leaf by leaf (``param.init_params(blocks=)``: the block of
        the single device's draw), so the ranks together hold the single
        device's weights and no rank ever holds the whole model."""
        return param_lib.init_params(
            self._param_shapes, seed, self.cfg.dtype,
            torch.device(device) if device is not None else self.mesh.device,
            blocks=lambda s: self.slices(
                shlib.spec_for(s.axes, self.rules, self.mesh, s.shape), s.shape))

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


# ---------------------------------------------------------------------------
# training mesh
# ---------------------------------------------------------------------------

def _axes_of(ax) -> Tuple[str, ...]:
    return (ax,) if isinstance(ax, str) else tuple(ax or ())


def _pad(spec, ndim: int) -> Tuple:
    return tuple(spec) + (None,) * (ndim - len(spec))


def block_slices(spec, shape, mesh) -> Tuple[slice, ...]:
    """The block of a leaf of global ``shape`` that ``mesh``'s rank holds
    under a resolved ``spec``: along each split dimension, the block index
    over its axes (major to minor, the reference's ``NamedSharding``
    order)."""
    out = []
    for d, ax in enumerate(_pad(spec, len(shape))):
        axes = _axes_of(ax)
        if not axes:
            out.append(slice(None))
            continue
        n, i = mesh.extent(axes), mesh.coord(axes)
        w = shape[d] // n
        out.append(slice(i * w, (i + 1) * w))
    return tuple(out)


def block_shape(spec, shape, mesh) -> Tuple[int, ...]:
    """The shape of ``mesh``'s rank's block of a leaf of global ``shape``."""
    return tuple(sl.stop - sl.start if sl.start is not None else n
                 for sl, n in zip(block_slices(spec, shape, mesh), shape))


def block_of(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """``mesh``'s rank's block of a global tensor (a fresh tensor when
    cut, so the global one can be freed)."""
    if not any(_axes_of(ax) for ax in spec):
        return t
    return t[block_slices(spec, t.shape, mesh)].clone()


#: the largest all-reduce ``TrainTP.sync_grads`` packs gradients into
GRAD_BUCKET_BYTES = 256 << 20


def _map2(fn, a: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``a`` (dicts; a list of ParamSpecs or
    tensors is one stacked leaf, as in ``bridge.ref_view``)."""
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], *(r[k] for r in rest)) for k in a}
    return fn(a, *rest)


class TrainTP:
    """This rank's share of a training mesh (``launch.mesh.TrainMesh``)
    under ``rules`` (``sharding.make_rules``): the resolved specs of the
    parameters (``decoder.train_specs``) and of the optimizer state, the
    placement of a whole train state leaf by leaf, the gradient sums over
    the batch axes, and the gather back to full arrays for checkpoints.

    Each leaf is held as this rank's block along every dimension its spec
    splits (block index over a tuple of axes major to minor, the
    reference's ``NamedSharding`` order); a leaf is replicated over the
    axes its spec does not name.  The optimizer state follows its
    parameter: moments and 8-bit codes as the parameter (under
    ``bridge.ref_view``'s stacked layout, with an unsplit leading axis),
    8-bit scales as the parameter unless a rank's block cuts through the
    256-wide blocks (then replicated along the last dim), Adafactor's row
    factor as the parameter without its last dim and its column factor
    without its second to last."""

    def __init__(self, cfg, mesh, rules):
        from repro_torch.models.layers import moe as moe_lib

        self.cfg, self.mesh, self.rules = cfg, mesh, rules
        self.param_shapes = decoder.model_specs(cfg)
        self.param_specs = decoder.train_specs(cfg, mesh, rules)
        self.batch_axes = shlib.batch_axes(mesh, rules)
        # experts over a batch axis with no group limit serve the global
        # batch on every rank: their gradients are whole
        self.global_experts = moe_lib.global_dispatch(cfg, mesh, rules)

    # -- blocks ------------------------------------------------------------
    def split_axes(self, spec) -> Tuple[str, ...]:
        return tuple(a for ax in spec for a in _axes_of(ax))

    def slices(self, spec, shape) -> Tuple[slice, ...]:
        """This rank's block of a leaf of global ``shape``."""
        return block_slices(spec, shape, self.mesh)

    def block(self, t, spec):
        """This rank's block of a global tensor."""
        return block_of(t, spec, self.mesh)

    def owner(self, spec) -> bool:
        """Whether this rank is the first replica of its block (coordinate
        0 along every axis the spec does not split)."""
        used = set(self.split_axes(spec))
        return all(c == 0 for a, c in self.mesh.coords.items() if a not in used)

    # -- spec trees --------------------------------------------------------
    def _ref(self, tree):
        from repro_torch import bridge

        return bridge.ref_view(tree, self.cfg)

    def _straddles(self, shape, spec) -> bool:
        from repro_torch.training.optimizer import _QBLOCK

        ax = _pad(spec, len(shape))[-1] if shape else None
        n = self.mesh.extent(_axes_of(ax))
        return n > 1 and (shape[-1] // n) % _QBLOCK != 0

    def opt_specs(self, opt: Dict) -> Dict:
        """Specs of an optimizer state (``{m, v}``, ``{m: {q, s}}``,
        ``{f: {r, c} | {v}}``, ``step``) in ``bridge.ref_view`` layout."""
        def leaf(ps, rs, st):
            stacked = isinstance(ps, list)
            shape = (ps[0] if stacked else ps).shape
            spec = _pad(rs[0] if stacked else rs, len(shape))
            full = ((None,) if stacked else ()) + spec
            if isinstance(st, dict) and "q" in st:
                s_spec = full[:-1] + (None,) if self._straddles(shape, spec) else full
                return {"q": full, "s": s_spec}
            if isinstance(st, dict) and "r" in st:
                return {"r": full[:-1], "c": full[:-2] + full[-1:]}
            if isinstance(st, dict):
                return {"v": full}
            return full

        shapes, specs = self._ref(self.param_shapes), self._ref(self.param_specs)
        return {k: () if k == "step" else _map2(leaf, shapes, specs, v)
                for k, v in opt.items()}

    def leaf_shards(self) -> Dict:
        """The optimizer's ``LeafShard`` tree (``bridge.ref_view`` layout)."""
        from repro_torch.training.optimizer import LeafShard

        m = self.mesh

        def leaf(ps, rs):
            ps = ps[0] if isinstance(ps, list) else ps
            rs = _pad(rs[0] if isinstance(rs, list) else rs, len(ps.shape))
            sl = self.slices(rs, ps.shape)
            used = self.split_axes(rs)
            return LeafShard(
                shape=tuple(ps.shape),
                offsets=tuple(s.start or 0 for s in sl),
                groups=tuple(m.group(_axes_of(ax)) for ax in rs),
                owner=self.owner(rs), world=m.group(m.axes),
                split=m.group(used) if used else None)

        return _map2(leaf, self._ref(self.param_shapes),
                     self._ref(self.param_specs))

    # -- placement ---------------------------------------------------------
    def _walk(self, fn, tree, specs):
        if isinstance(tree, dict):
            return {k: self._walk(fn, v, specs[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [self._walk(fn, v, specs[i]) for i, v in enumerate(tree)]
        return fn(tree, specs)

    def shard_params(self, params: Dict, device=None) -> Dict:
        """This rank's blocks of a global parameter tree, moved to
        ``device`` if given."""
        return self._walk(lambda t, s: self.block(t, s) if device is None
                          else self.block(t, s).to(device), params,
                          self.param_specs)

    def init_params(self, seed: int = 0, device=None) -> Dict:
        """This rank's blocks of ``decoder.init_params(cfg, seed, device)``:
        each the block of the single device's draw, a large leaf drawn
        only in the slices the block touches (``param.init_params``), so a
        rank's peak is its blocks and one slice (or one small leaf)."""
        resolved: Dict[int, Any] = {}

        def note(ps, rs):
            if isinstance(ps, dict):
                for k in ps:
                    note(ps[k], rs[k])
            elif isinstance(ps, list):
                for a, b in zip(ps, rs):
                    note(a, b)
            else:
                resolved[id(ps)] = rs

        note(self.param_shapes, self.param_specs)
        return param_lib.init_params(
            self.param_shapes, seed, self.cfg.dtype,
            torch.device(device) if device is not None else self.mesh.device,
            blocks=lambda s: self.slices(resolved[id(s)], s.shape))

    def abstract_params(self) -> Dict:
        """This rank's parameter blocks as ``meta`` tensors (shapes and
        dtypes, no allocation, no draw)."""
        dt = param_lib.torch_dtype(self.cfg.dtype)

        def leaf(ps, rs):
            return torch.empty(block_shape(rs, ps.shape, self.mesh), device="meta",
                               dtype=param_lib.torch_dtype(ps.dtype) if ps.dtype
                               else dt)

        return self._walk(leaf, self.param_shapes, self.param_specs)

    def abstract_train_state(self, optimizer) -> Dict:
        """This rank's train state as ``meta`` tensors: its parameter
        blocks and the optimizer state of those blocks (its layout follows
        ``opt_specs``), built without the host draw of
        ``init_train_state``."""
        params = self.abstract_params()
        return {"params": params,
                "opt": optimizer.init(self._ref(params), shard=self.leaf_shards()),
                "step": torch.empty((), dtype=torch.int32, device="meta")}

    def init_train_state(self, optimizer, seed: int = 0, device=None) -> Dict:
        """This rank's train state: ``init_params`` and the optimizer's
        initial state of its blocks."""
        params = self.init_params(seed, device)
        dev = params["final_norm"]["scale"].device
        return {"params": params,
                "opt": optimizer.init(self._ref(params), shard=self.leaf_shards()),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}

    # -- gradients ---------------------------------------------------------
    def sync_grads(self, grads: Dict, seq_parallel: bool = False) -> Dict:
        """Sum each gradient over the batch axes its leaf is not split
        over, in place (FSDP leaves arrive summed over ``data`` from the
        gather's backward; a leaf split over ``data`` by group-limited
        experts sees only its rows' tokens; experts without a group limit
        see the global batch on every rank, and take no sum).  After a
        ``seq_parallel`` step each rank's gradient of a leaf ``model``
        does not split is its sequence block's share: summed over
        ``model`` too.  Leaves are packed by (axes, dtype) into buckets of
        at most ``GRAD_BUCKET_BYTES``, one all-reduce each, in the same
        order on every rank."""
        packs: Dict[Tuple, List[torch.Tensor]] = {}
        over = self.batch_axes + (("model",) if seq_parallel else ())
        experts = self._expert_leaves() if self.global_experts else set()

        def note(g, spec):
            if id(spec) in experts:
                axes = tuple(a for a in over if a == "model"
                             and a not in self.split_axes(spec))
            else:
                axes = tuple(a for a in over if a not in self.split_axes(spec))
            if axes and self.mesh.extent(axes) > 1:
                packs.setdefault((axes, g.dtype), []).append(g)
            return g

        self._walk(note, grads, self.param_specs)
        for (axes, _), gs in packs.items():
            group = self.mesh.group(axes)
            i = 0
            while i < len(gs):
                j, size = i, 0
                while j < len(gs) and (j == i or size + gs[j].numel()
                                       * gs[j].element_size() <= GRAD_BUCKET_BYTES):
                    size += gs[j].numel() * gs[j].element_size()
                    j += 1
                buf = torch.cat([g.reshape(-1) for g in gs[i:j]])
                shlib.all_reduce_(buf, group)
                off = 0
                for g in gs[i:j]:
                    g.copy_(buf[off: off + g.numel()].view_as(g))
                    off += g.numel()
                i = j
        return grads

    def _expert_leaves(self) -> set:
        """ids of the resolved specs of the routed experts' leaves."""
        out = set()

        def walk(ps, rs):
            if isinstance(ps, dict):
                for k in ps:
                    walk(ps[k], rs[k])
            elif isinstance(ps, list):
                for a, b in zip(ps, rs):
                    walk(a, b)
            elif "experts" in ps.axes:
                out.add(id(rs))

        walk(self.param_shapes, self.param_specs)
        return out

    # -- gathering ---------------------------------------------------------
    def _gather_leaf(self, t: torch.Tensor, spec) -> torch.Tensor:
        """The global tensor of a leaf (every rank gets it, on the host
        for gloo): each block written by its first replica into zeros,
        summed over the mesh."""
        spec = _pad(spec, t.dim())
        shape = tuple(s * self.mesh.extent(_axes_of(ax))
                      for s, ax in zip(t.shape, spec))
        if shape == tuple(t.shape):
            return t.detach().cpu() if self.mesh.backend == "gloo" else t.detach()
        dev = torch.device("cpu") if self.mesh.backend == "gloo" else t.device
        full = torch.zeros(shape, dtype=t.dtype, device=dev)
        if self.owner(spec):
            full[self.slices(spec, shape)] = t.detach().to(dev)
        # sum the bit patterns as integers: one rank writes each element,
        # so the sum is that element's bits, signed zeros included
        bits = full.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
            full.element_size()]) if full.is_floating_point() else full
        buf = bits.to(torch.int32) if bits.element_size() < 4 else bits
        shlib.all_reduce_(buf, self.mesh.group(self.mesh.axes),
                          kind="all-gather")
        if buf is not bits:
            bits.copy_(buf.to(bits.dtype))
        return full

    def gather_params(self, params: Dict) -> Dict:
        """The global parameter tree (CPU for gloo), on every rank."""
        return self._walk(self._gather_leaf, params, self.param_specs)

    def gather_state(self, state: Dict) -> Dict:
        """The global train state on every rank (CPU for gloo): what a
        checkpoint holds."""
        return {"params": self.gather_params(state["params"]),
                "opt": self._walk(self._gather_leaf, state["opt"],
                                  self.opt_specs(state["opt"])),
                "step": state["step"].detach().cpu()}
