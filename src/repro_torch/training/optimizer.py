"""Optimizers over trees of tensors (port of ``repro/training/optimizer.py``).

* ``adamw``     — AdamW with fp32 state (master-precision moments).
* ``adam8bit``  — AdamW with **blockwise int8-quantized moments**
                  (~2 bytes/param of optimizer state instead of 8: what
                  lets a 9B model train on one 80 GB card).
* ``adafactor`` — factored second moments (rank-1) for matrices.
* ``sgdm``      — SGD with momentum (baseline).

Each factory returns ``Optimizer(init, update)``; ``update`` maps
``(grads, state, params) -> (new_params, new_state)`` and runs under
``torch.no_grad()``.  Learning-rate schedules are ``step -> lr``
callables of an int32 step tensor (``schedule.py``).  The arithmetic is
the reference's op for op, in fp32, each parameter cast back to its dtype.

Trees are nested dicts.  A leaf is a tensor, or a list of same-shape
tensors standing for their stack on a new leading axis: that is how
``train_step.ref_view`` shows the port's per-layer parameters in the
reference's scan-stacked layout without copying them.  The state is a
tree of real tensors in that layout (``m``/``v``; ``{q, s}``; ``{r, c}``
or ``{v}``; ``step``), so a train state checkpoints and bridges leaf for
leaf.  AdamW, 8-bit Adam and SGDM act on each element (each row, for the
int8 blocks) on its own, so they update a stacked leaf one layer at a
time through views of its state; Adafactor factors and RMS-clips over
the whole stacked leaf, as the reference does, so it stacks the layers
for the update.

Unlike the reference, ``update`` writes the new values into the tensors
it is given and returns the same trees: new arrays would hold a second
copy of every parameter and moment, which at Yi-9B's size does not fit
on the card.  A caller that needs the old values clones them first.

On a training mesh each rank updates its own block of every leaf:
``init(params, shard=)`` and ``update(..., shard=)`` take a tree of
``LeafShard`` (``distributed.tp.TrainTP.leaf_shards``), the same layout
as ``params``.  AdamW and SGDM act on each element; what spans a split
dimension is summed over the ranks that split it: the global gradient
norm of the clip, Adafactor's row and column means and its update RMS,
and 8-bit Adam's block maxima where a 256-wide block straddles ranks
(a block that lies within a rank stays local).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Tuple[Any, Any]]


Schedule = Callable[[torch.Tensor], torch.Tensor]


@dataclass(frozen=True)
class LeafShard:
    """Where this rank's block of one parameter leaf lies on the mesh
    (for a scan-stacked leaf: of each layer's tensor)."""
    shape: Tuple[int, ...]  # the global shape
    offsets: Tuple[int, ...]  # this rank's first index along each dim
    groups: Tuple[Any, ...]  # per dim: the ranks splitting it, or None
    owner: bool  # the first replica of its block: counts in mesh sums
    world: Any  # every rank of the mesh
    split: Any  # the ranks splitting any dim, or None

    def stacked(self) -> "LeafShard":
        return LeafShard((0,) + self.shape, (0,) + self.offsets,
                         (None,) + self.groups, self.owner, self.world,
                         self.split)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (the identity for None)."""
    if group is None:
        return x
    from repro_torch.distributed.sharding import all_reduce_

    return all_reduce_(x.contiguous().clone(), group)


def _const(lr: float) -> Schedule:
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------

def _is_stack(x: Any) -> bool:
    return isinstance(x, (list, tuple))


def _shape(p) -> Tuple[int, ...]:
    return (len(p),) + tuple(p[0].shape) if _is_stack(p) else tuple(p.shape)


def _leaves(tree: Any) -> list:
    """Tensors in the reference's leaf order (dict keys sorted, as
    ``jax.tree.leaves``; a stacked leaf's layers in order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    return list(tree) if _is_stack(tree) else [tree]


def _map(fn: Callable, params: Any, *trees: Any) -> Any:
    """``fn(leaf, *subtrees)`` over the leaves of ``params`` (tensors or
    stacked leaves), with the subtrees of ``trees`` at the same path."""
    if isinstance(params, dict):
        return {k: _map(fn, params[k], *(t[k] for t in trees)) for k in params}
    return fn(params, *trees)


def _tensors(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tensors(fn, v) for k, v in tree.items()}
    return fn(tree)


def _write(dst: Any, src: Any) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _write(dst[k], src[k])
    else:
        dst.copy_(src)


def _device(params: Any) -> torch.device:
    return _leaves(params)[0].device


def _no_shard(params):
    return _map(lambda p: None, params)


def _apply(upd: Callable, params, grads, states, separable: bool,
           shard=None) -> None:
    """``upd(p, g, sh, *state_leaves) -> (new_p, *new_state_leaves)`` on
    every leaf, written in place (``sh``: the leaf's ``LeafShard`` or
    None).  A stacked leaf goes layer by layer through views of its
    stacked state when ``separable``, else as one stack."""
    def leaf(p, g, sh, *st):
        if not _is_stack(p):
            new = upd(p, g, sh, *st)
            p.copy_(new[0])
            for s, n in zip(st, new[1:]):
                _write(s, n)
        elif separable and p[0].dim() > 0:
            for i, (pi, gi) in enumerate(zip(p, g)):
                sti = [_tensors(lambda t: t[i], s) for s in st]
                new = upd(pi, gi, sh, *sti)
                pi.copy_(new[0])
                for s, n in zip(sti, new[1:]):
                    _write(s, n)
        else:
            new = upd(torch.stack(list(p)), torch.stack(list(g)),
                      None if sh is None else sh.stacked(), *st)
            for pi, ni in zip(p, new[0]):
                pi.copy_(ni)
            for s, n in zip(st, new[1:]):
                _write(s, n)

    with torch.no_grad():
        _map(leaf, params, grads,
             _no_shard(params) if shard is None else shard, *states)


def _zeros(params):
    return _map(lambda p: torch.zeros(_shape(p), dtype=torch.float32,
                                      device=_device(p)), params)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(
    lr: float | Schedule = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    grad_clip: float = 1.0,
) -> Optimizer:
    sched = lr if callable(lr) else _const(lr)

    def init(params, shard=None):
        return {"m": _zeros(params), "v": _zeros(params),
                "step": torch.zeros((), dtype=torch.int32, device=_device(params))}

    def update(grads, state, params, step=None, shard=None):
        step = state["step"] + 1
        scale = _clip_scale(grads, grad_clip, shard)
        lr_t = sched(step)
        bc1 = 1.0 - b1 ** step.to(torch.float32)
        bc2 = 1.0 - b2 ** step.to(torch.float32)

        def upd(p, g, sh, m, v):
            g = _clip(g, scale).to(torch.float32)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * torch.square(g)
            mh = m / bc1
            vh = v / bc2
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - lr_t * delta).to(p.dtype), m, v

        _apply(upd, params, grads, (state["m"], state["v"]), separable=True,
               shard=shard)
        return params, {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Blockwise int8 moment quantization
# ---------------------------------------------------------------------------

_QBLOCK = 256


def _qblock(d: int) -> int:
    """Block size along the last dim (the int8 payload keeps the
    parameter's shape; a last dim that 256 does not divide is one block)."""
    return _QBLOCK if d % _QBLOCK == 0 else d


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 [..., d] -> (int8 [..., d], fp32 scales [..., d/bs]); rounds
    half to even, as ``jnp.round``."""
    d = x.shape[-1] if x.dim() else 1
    x = x.reshape(tuple(x.shape) or (1,))
    bs = _qblock(d)
    xr = x.reshape(*x.shape[:-1], d // bs, bs)
    scale = torch.amax(torch.abs(xr), dim=-1) / 127.0  # [..., d/bs]
    q = torch.round(xr / torch.clamp_min(scale[..., None], 1e-12)).to(torch.int8)
    return q.reshape(x.shape), scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    shape = tuple(shape) or (1,)
    d = shape[-1]
    bs = _qblock(d)
    xr = q.to(torch.float32).reshape(*shape[:-1], d // bs, bs)
    return (xr * scale[..., None]).reshape(shape)


def _straddles(sh: Optional[LeafShard], w: int) -> bool:
    """Whether this rank's last-dim block of width ``w`` cuts through the
    global 256-wide (or whole-dim) quantization blocks."""
    return (sh is not None and len(sh.shape) > 0 and sh.groups[-1] is not None
            and w % _QBLOCK != 0)


def _block_ids(sh: LeafShard, w: int, device) -> Tuple[torch.Tensor, int]:
    D = sh.shape[-1]
    bs = _qblock(D)
    return (sh.offsets[-1] + torch.arange(w, device=device)) // bs, D // bs


def _quantize_sh(x: torch.Tensor, sh: Optional[LeafShard]):
    """``_quantize`` of this rank's block: local blocks, or, where the
    block cuts through quantization blocks, their maxima taken over the
    ranks that split the last dim (scales ``[..., D/bs]``, replicated
    along it)."""
    if not _straddles(sh, x.shape[-1] if x.dim() else 1):
        return _quantize(x)
    bid, nb = _block_ids(sh, x.shape[-1], x.device)
    amax = torch.zeros(*x.shape[:-1], nb, dtype=torch.float32, device=x.device)
    amax.scatter_reduce_(-1, bid.expand(x.shape), torch.abs(x), "amax")
    from repro_torch.distributed.sharding import all_reduce_

    all_reduce_(amax, sh.groups[-1], dist.ReduceOp.MAX)
    scale = amax / 127.0
    q = torch.round(x / torch.clamp_min(scale[..., bid], 1e-12)).to(torch.int8)
    return q, scale


def _dequantize_sh(q, scale, shape, sh: Optional[LeafShard]) -> torch.Tensor:
    shape = tuple(shape)
    if not _straddles(sh, shape[-1] if shape else 1):
        return _dequantize(q, scale, shape)
    bid, _ = _block_ids(sh, shape[-1], q.device)
    return q.to(torch.float32) * scale[..., bid]


def adam8bit(
    lr: float | Schedule = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.01,
    grad_clip: float = 1.0,
) -> Optimizer:
    sched = lr if callable(lr) else _const(lr)

    def q_init(p, sh=None):
        shape, dev = _shape(p), _device(p)
        if _straddles(sh, shape[-1] if shape else 1):
            nb = sh.shape[-1] // _qblock(sh.shape[-1])
            return {"q": torch.zeros(shape, dtype=torch.int8, device=dev),
                    "s": torch.zeros(shape[:-1] + (nb,), dtype=torch.float32,
                                     device=dev)}
        q, s = _quantize(torch.zeros(shape, dtype=torch.float32, device=dev))
        return {"q": q, "s": s}

    def init(params, shard=None):
        shard = _no_shard(params) if shard is None else shard
        return {"m": _map(q_init, params, shard), "v": _map(q_init, params, shard),
                "step": torch.zeros((), dtype=torch.int32, device=_device(params))}

    def update(grads, state, params, step=None, shard=None):
        step = state["step"] + 1
        scale = _clip_scale(grads, grad_clip, shard)
        lr_t = sched(step)
        bc1 = 1.0 - b1 ** step.to(torch.float32)
        bc2 = 1.0 - b2 ** step.to(torch.float32)

        def upd(p, g, sh, mq, vq):
            g = _clip(g, scale).to(torch.float32)
            m = b1 * _dequantize_sh(mq["q"], mq["s"], p.shape, sh) + (1 - b1) * g
            # v is stored in the sqrt domain: halves the dynamic range so
            # the int8 code does not crush small second moments to zero
            v_prev = torch.square(_dequantize_sh(vq["q"], vq["s"], p.shape, sh))
            v = b2 * v_prev + (1 - b2) * torch.square(g)
            mh = m / bc1
            vh = v / bc2
            delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(torch.float32)
            new_p = (p.to(torch.float32) - lr_t * delta).to(p.dtype)
            nmq, nms = _quantize_sh(m, sh)
            nvq, nvs = _quantize_sh(torch.sqrt(v), sh)
            return new_p, {"q": nmq, "s": nms}, {"q": nvq, "s": nvs}

        _apply(upd, params, grads, (state["m"], state["v"]), separable=True,
               shard=shard)
        return params, {"m": state["m"], "v": state["v"], "step": step}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Adafactor (factored second moments)
# ---------------------------------------------------------------------------

def adafactor(
    lr: float | Schedule = 1e-2,
    decay: float = 0.8,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
) -> Optimizer:
    sched = lr if callable(lr) else _const(lr)

    def init_leaf(p):
        shape, dev = _shape(p), _device(p)
        if len(shape) >= 2:
            return {"r": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),
                    "c": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32,
                                     device=dev)}
        return {"v": torch.zeros(shape, dtype=torch.float32, device=dev)}

    def init(params, shard=None):
        return {"f": _map(init_leaf, params),
                "step": torch.zeros((), dtype=torch.int32, device=_device(params))}

    def update(grads, state, params, step=None, shard=None):
        step = state["step"] + 1
        t = step.to(torch.float32)
        beta = 1.0 - t ** (-decay)
        lr_t = sched(step)

        def mean(x, dim, sh, pdim, keepdim=False):
            # mean over p's dim ``pdim`` (x's ``dim``), summed over the
            # ranks that split it
            if sh is None or sh.groups[pdim] is None:
                return torch.mean(x, dim=dim, keepdim=keepdim)
            tot = _sum(torch.sum(x, dim=dim, keepdim=keepdim), sh.groups[pdim])
            return tot / sh.shape[pdim]

        def upd(p, g, sh, f):
            g = g.to(torch.float32)
            g2 = torch.square(g) + eps
            if p.dim() >= 2:
                r = beta * f["r"] + (1 - beta) * mean(g2, -1, sh, -1)
                c = beta * f["c"] + (1 - beta) * mean(g2, -2, sh, -2)
                denom = torch.clamp_min(mean(r, -1, sh, -2, keepdim=True), eps)
                vhat = r[..., :, None] * c[..., None, :] / denom[..., None]
                u = g * torch.rsqrt(vhat + eps)
                nf = {"r": r, "c": c}
            else:
                v = beta * f["v"] + (1 - beta) * g2
                u = g * torch.rsqrt(v + eps)
                nf = {"v": v}
            # update clipping (RMS), over the whole leaf
            if sh is None or sh.split is None:
                ms = torch.mean(torch.square(u))
            else:
                full = u.numel()
                for d, grp in enumerate(sh.groups):
                    if grp is not None:
                        full = full // u.shape[d] * sh.shape[d]
                ms = _sum(torch.sum(torch.square(u)), sh.split) / full
            rms = torch.sqrt(ms + 1e-12)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            new_p = p.to(torch.float32) - lr_t * (
                u + weight_decay * p.to(torch.float32))
            return new_p.to(p.dtype), nf

        _apply(upd, params, grads, (state["f"],), separable=False, shard=shard)
        return params, {"f": state["f"], "step": step}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------

def sgdm(lr: float | Schedule = 0.1, momentum: float = 0.9,
         grad_clip: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else _const(lr)

    def init(params, shard=None):
        return {"m": _zeros(params),
                "step": torch.zeros((), dtype=torch.int32, device=_device(params))}

    def update(grads, state, params, step=None, shard=None):
        step = state["step"] + 1
        scale = _clip_scale(grads, grad_clip, shard)
        lr_t = sched(step)

        def upd(p, g, sh, m):
            m = momentum * m + _clip(g, scale).to(torch.float32)
            return (p.to(torch.float32) - lr_t * m).to(p.dtype), m

        _apply(upd, params, grads, (state["m"],), separable=True, shard=shard)
        return params, {"m": state["m"], "step": step}

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# Utilities
# ---------------------------------------------------------------------------

def _clip_scale(grads, max_norm: float, shard=None):
    """The factor ``clip_by_global_norm`` multiplies every gradient by
    (None when ``max_norm`` is 0): the norm summed in fp32 over the
    leaves in the reference's order.  On a mesh each rank adds the blocks
    it is the first replica of, and one all-reduce adds the ranks."""
    if not max_norm:
        return None
    with torch.no_grad():
        if shard is None:
            sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                     for g in _leaves(grads))
        else:
            shs = _leaves(_map(lambda g, sh: [sh] * len(g) if _is_stack(g)
                               else sh, grads, shard))
            sq = sum(torch.sum(torch.square(g.to(torch.float32)))
                     * (1.0 if sh.owner else 0.0)
                     for g, sh in zip(_leaves(grads), shs))
            sq = _sum(sq, shs[0].world)
        norm = torch.sqrt(sq)
        return torch.clamp_max(max_norm / torch.clamp_min(norm, 1e-12), 1.0)


def _clip(g: torch.Tensor, scale) -> torch.Tensor:
    if scale is None:
        return g
    return (g.to(torch.float32) * scale).to(g.dtype)  # promoted, as jnp


def clip_by_global_norm(grads, max_norm: float):
    scale = _clip_scale(grads, max_norm)
    if scale is None:
        return grads

    def leaf(g):
        return [_clip(t, scale) for t in g] if _is_stack(g) else _clip(g, scale)

    return _map(leaf, grads)


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    return {
        "adamw": adamw,
        "adam8bit": adam8bit,
        "adafactor": adafactor,
        "sgdm": sgdm,
    }[name](lr, **kw)
