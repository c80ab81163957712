"""Cell construction for the dry-run and the card (port of
``repro/launch/cells.py``).

A *cell* = (architecture x input shape x mesh).  The reference builds a
jit-able step over the whole mesh with abstract inputs and their
``NamedSharding``s; the port runs one process per rank, so a cell is
**one rank's program**: ``fn`` plus ``args``, ``meta`` tensors of this
rank's blocks under ``policy_for``'s rules (``Cell.resolved``, the
reference's shardings as resolved specs).  ``launch.dryrun`` steps
``fn`` once on those ``meta`` tensors over a ``dry_train_mesh``;
``materialize`` makes real tensors of the same shapes, so the card runs
the very ``fn`` the dry-run stepped, as the reference's launchers and
dry-run share these builders.

Serving cells (prefill with GRIFFIN statistics and selection, decode on
the compacted FF) run under the mesh's serve rules with the collectives
written out (``serving.steps``).  Under ``seq_parallel`` rules a batch's
sequence arrives split over ``model`` (its resolved spec); the cell's
program gathers it (``_whole_seq``) and the decoder splits the residual
stream along it again.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.distributed import sharding as shlib
from repro_torch.distributed.tp import (TrainTP, block_of, block_shape,
                                        block_slices)
from repro_torch.launch.policies import CellPolicy
from repro_torch.models import decoder, param as param_lib
from repro_torch.models.param import ParamSpec
from repro_torch.serving import steps as steps_lib
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.train_step import build_train_step

#: the learning rate of a train cell's optimizer (the reference's)
TRAIN_LR = 3e-4


@dataclass
class Cell:
    """One rank's program of a cell: ``fn(*args)``.  ``specs`` holds, per
    argument, the global ParamSpec tree its blocks are cut from (None for
    a host value or a train state), ``resolved`` the resolved spec tree
    of its blocks."""
    name: str
    fn: Callable
    args: Tuple
    specs: Tuple
    resolved: Tuple
    mesh: Any
    policy: CellPolicy
    kind: str
    cfg: ModelConfig
    shape: ShapeConfig
    accum_steps: int = 1
    optimizer: Optional[Any] = None
    notes: List[str] = field(default_factory=list)


def _walk(fn, spec_tree, resolved):
    if isinstance(spec_tree, dict):
        return {k: _walk(fn, v, resolved[k]) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [_walk(fn, v, resolved[i]) for i, v in enumerate(spec_tree)]
    return fn(spec_tree, resolved)


def _meta(spec_tree, resolved, mesh, dtype):
    dt = param_lib.torch_dtype(dtype)
    return _walk(lambda s, r: torch.empty(
        block_shape(r, s.shape, mesh), device="meta",
        dtype=param_lib.torch_dtype(s.dtype) if s.dtype else dt),
        spec_tree, resolved)


def _whole_seq(inputs: Dict[str, torch.Tensor], resolved) -> Dict:
    """The inputs with a sequence (dimension 1) their resolved specs split
    gathered whole (inside the mesh's ``axis_rules``)."""
    return {k: shlib.gather_dim(t, 1, shlib.split_axes(resolved[k], 1))
            for k, t in inputs.items()}


# ---------------------------------------------------------------------------
# Batch / input specs
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, ParamSpec]:
    """Global specs of a train step's batch (the reference's
    ``train_batch_specs``; its shardings are these axes resolved)."""
    B, S = shape.global_batch, shape.seq_len
    if cfg.family == "encoder":
        return {"prefix_emb": ParamSpec((B, S, cfg.d_model),
                                        ("batch", "seq", "act_embed")),
                "targets": ParamSpec((B, S), ("batch", "seq"), dtype="int32")}
    if cfg.family == "vlm":
        Pn = cfg.num_prefix_embeddings
        return {"prefix_emb": ParamSpec((B, Pn, cfg.d_model),
                                        ("batch", "seq", "act_embed")),
                "tokens": ParamSpec((B, S - Pn), ("batch", "seq"), dtype="int32")}
    return {"tokens": ParamSpec((B, S), ("batch", "seq"), dtype="int32")}


def prefill_input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, ParamSpec]:
    specs = train_batch_specs(cfg, shape)
    specs.pop("targets", None)
    return specs


def _resolve(spec_tree, mesh, rules):
    return shlib.tree_specs(spec_tree, mesh, rules)


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------

def build_train_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     pol: CellPolicy) -> Cell:
    """A train step of this rank: its blocks of the train state (built on
    ``meta`` by ``TrainTP.abstract_train_state``, never drawn) and of the
    batch; every microbatch and the optimizer update."""
    optimizer = opt_lib.get_optimizer(pol.optimizer, TRAIN_LR)
    tp = TrainTP(cfg, mesh, pol.rules)
    state = tp.abstract_train_state(optimizer)
    b_specs = train_batch_specs(cfg, shape)
    b_res = _resolve(b_specs, mesh, pol.rules)
    batch = _meta(b_specs, b_res, mesh, cfg.dtype)
    rows = next(iter(batch.values())).shape[0]
    accum = min(pol.accum_steps, rows)
    notes = []
    if accum != pol.accum_steps:
        notes.append(f"accum_steps {pol.accum_steps} -> {accum}: this rank "
                     f"holds {rows} rows of the batch")
    step = build_train_step(cfg, optimizer, accum_steps=accum, mesh=mesh,
                            rules=pol.rules, local_batch=True)

    def fn(state, batch):
        with shlib.axis_rules(mesh, pol.rules):
            batch = _whole_seq(batch, b_res)
        return step(state, batch)

    return Cell(name=f"{cfg.name}:{shape.name}:train", fn=fn,
                args=(state, batch), specs=(None, b_specs),
                resolved=({"params": tp.param_specs}, b_res), mesh=mesh,
                policy=pol, kind="train", cfg=cfg, shape=shape,
                accum_steps=accum, optimizer=optimizer, notes=notes)


def build_prefill_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                       pol: CellPolicy) -> Cell:
    """Prefill with GRIFFIN statistics, selection and compaction of this
    rank's FF blocks; the KV comes back as this rank's cache blocks."""
    prefill = steps_lib.build_prefill_step(cfg, pol.griffin, q_chunk=pol.q_chunk,
                                           global_batch=shape.global_batch)
    p_specs = decoder.model_specs(cfg)
    p_res = decoder.train_specs(cfg, mesh, pol.rules)
    i_specs = prefill_input_specs(cfg, shape)
    i_res = _resolve(i_specs, mesh, pol.rules)
    rules = pol.rules

    def fn(params, inputs):
        with shlib.axis_rules(mesh, rules):
            inputs = _whole_seq(inputs, i_res)
            return prefill(params, inputs.get("tokens"), inputs.get("prefix_emb"))

    return Cell(name=f"{cfg.name}:{shape.name}:prefill", fn=fn,
                args=(_meta(p_specs, p_res, mesh, cfg.dtype),
                      _meta(i_specs, i_res, mesh, cfg.dtype)),
                specs=(p_specs, i_specs), resolved=(p_res, i_res), mesh=mesh,
                policy=pol, kind="prefill", cfg=cfg, shape=shape)


def build_decode_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      pol: CellPolicy) -> Cell:
    """One decode step at ``pos = seq_len - 1`` over this rank's block of
    the contiguous cache, on its blocks of the compacted FF."""
    use_pruned = pol.griffin is not None
    B, S = shape.global_batch, shape.seq_len
    p_specs = decoder.model_specs(cfg)
    p_res = decoder.train_specs(cfg, mesh, pol.rules)
    c_specs = decoder.cache_specs(cfg, B, S)
    c_res = decoder.serve_specs(cfg, c_specs, mesh, pol.rules)
    if use_pruned:
        pr_specs = decoder.pruned_ffn_specs(cfg, pol.griffin.sparsity)
        pr_res = _resolve(pr_specs, mesh, pol.rules)
    else:
        pr_specs, pr_res = {}, {}
    t_specs = ParamSpec((B, 1), ("batch", "seq"), dtype="int32")
    t_res = shlib.spec_for(t_specs.axes, pol.rules, mesh, t_specs.shape)
    dec = steps_lib.build_decode_step(cfg, use_pruned, cache_specs=c_res)
    rules = pol.rules

    def fn(params, cache, pruned, token, pos):
        with shlib.axis_rules(mesh, rules):
            return dec(params, cache, pruned, token, pos)

    args = (_meta(p_specs, p_res, mesh, cfg.dtype),
            _meta(c_specs, c_res, mesh, cfg.dtype),
            _meta(pr_specs, pr_res, mesh, cfg.dtype),
            _meta(t_specs, t_res, mesh, cfg.dtype), S - 1)
    return Cell(name=f"{cfg.name}:{shape.name}:decode"
                + ("+griffin" if use_pruned else ""), fn=fn, args=args,
                specs=(p_specs, c_specs, pr_specs, t_specs, None),
                resolved=(p_res, c_res, pr_res, t_res, None), mesh=mesh,
                policy=pol, kind="decode", cfg=cfg, shape=shape)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               pol: CellPolicy) -> Cell:
    if shape.kind == "train":
        return build_train_cell(cfg, shape, mesh, pol)
    if shape.kind == "prefill":
        return build_prefill_cell(cfg, shape, mesh, pol)
    return build_decode_cell(cfg, shape, mesh, pol)


# ---------------------------------------------------------------------------
# Bytes and real tensors
# ---------------------------------------------------------------------------

def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor of a tree (dicts, lists, tuples)."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def input_bytes(cell: Cell) -> int:
    """This rank's bytes of the cell's inputs: parameters, optimizer
    state, cache, compacted FF and batch (the reference's
    ``_device_bytes``)."""
    return tree_bytes(cell.args)


def _random_specs(spec_tree):
    """The specs with every leaf drawn from N(0, 1) (a cache or an input
    of random values, not zeros)."""
    return param_lib.tree_map_specs(
        lambda s: ParamSpec(s.shape, s.axes, init="embed", scale=1.0,
                            dtype=s.dtype), spec_tree)


def materialize(cell: Cell, device, seed: int = 0, *, params=None,
                pruned=None) -> Tuple:
    """Real tensors of the cell's argument shapes on ``device``: the
    parameters as ``decoder.init_params(cfg, seed)`` draws them, the
    cache and float inputs from N(0, 1) (seeds + 1 and + 3), the
    compacted FF drawn as weights (seed + 2), tokens from ``numpy``
    (seed + 3); each leaf is this rank's block of the one-device draw
    (``param.init_params(blocks=)``), so every mesh and the one-device
    run see the same values.  A
    train cell gets ``TrainTP.init_train_state``.  ``params`` / ``pruned``
    given (this rank's blocks, e.g. a prefill cell's) are used as they
    are."""
    cfg, dev, mesh = cell.cfg, torch.device(device), cell.mesh

    def floats(specs, res, s: int, random: bool = False):
        flat: Dict[int, Any] = {}
        tree = _random_specs(specs) if random else specs
        _walk(lambda a, r: flat.__setitem__(id(a), r), tree, res)
        return param_lib.init_params(
            tree, s, cfg.dtype, dev,
            blocks=lambda a: block_slices(tuple(flat[id(a)]), a.shape, mesh))

    def tokens(spec: ParamSpec, res, s: int) -> torch.Tensor:
        rng = np.random.RandomState(s)
        t = torch.from_numpy(rng.randint(0, cfg.vocab_size, size=spec.shape)
                             .astype(np.int32))
        return block_of(t, tuple(res), mesh).to(dev)

    def inputs(specs: Dict[str, ParamSpec], res, s: int) -> Dict:
        return {k: tokens(v, res[k], s + j) if v.dtype == "int32"
                else floats(v, res[k], s + j, random=True)
                for j, (k, v) in enumerate(sorted(specs.items()))}

    if cell.kind == "train":
        tp = TrainTP(cfg, mesh, cell.policy.rules)
        return (tp.init_train_state(cell.optimizer, seed, dev),
                inputs(cell.specs[1], cell.resolved[1], seed + 3))
    if params is None:
        params = floats(cell.specs[0], cell.resolved[0], seed)
    if cell.kind == "prefill":
        return params, inputs(cell.specs[1], cell.resolved[1], seed + 3)
    _, c_specs, pr_specs, t_spec, _ = cell.specs
    _, c_res, pr_res, t_res, _ = cell.resolved
    if pruned is None:
        pruned = {int(li): v for li, v in floats(
            {str(li): v for li, v in pr_specs.items()},
            {str(li): v for li, v in pr_res.items()}, seed + 2).items()}
    return (params, floats(c_specs, c_res, seed + 1, random=True), pruned,
            tokens(t_spec, t_res, seed + 3), cell.args[4])
