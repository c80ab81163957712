"""Meshes over ``torch.distributed`` (port of ``repro/launch/mesh.py``).

The reference's mesh is a set of devices one program is compiled for.
The port runs **one process per shard**, and the ranks meet only in
collectives:

* a ``ServingMesh`` (``make_serving_mesh``) is one rank's view of the
  1-D tensor-parallel serving mesh: every rank builds the same
  ``PagedServer`` on its own shard, gets the same submissions, and the
  ranks meet in the all-reduces of ``distributed.sharding.psum_if_tp``
  and ``distributed.tp.gather_stats``;
* a ``TrainMesh`` (``make_host_mesh``, ``make_production_mesh``) is one
  rank's view of the named training mesh (``data`` and ``model``, and
  ``pod`` for two pods): its coordinates, and one process group for each
  set of axes (the ranks that differ only along those axes), the
  combined group of all axes included.  Ranks are laid out row-major
  over the axes, as ``jax.make_mesh`` lays out devices.

Backends are chosen by the caller, never switched here:

* ``"nccl"`` — one card per rank (``cuda:(rank % device_count)``); NCCL
  refuses two ranks on one card, so fewer cards than ranks is an error
  that names ``gloo``.
* ``"gloo"`` — any number of ranks on the CPU (``device="cpu"``, the only
  backend there) or sharing one card: gloo reduces CUDA tensors by
  staging them through host memory.  The port's TP path needs only
  ``all_reduce``, which gloo documents for CUDA tensors.

``run_ranks`` spawns the ranks of one mesh on this host and collects
what each returns.  The production shapes are the reference's pod
shapes (16 x 16, 2 x 16 x 16) with one NCCL rank per card.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import queue
import signal
import socket
import time
import traceback
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, FrozenSet, List, Optional, Sequence,
                    Tuple)

import torch
import torch.distributed as dist

from repro_torch.kernels import backend as backend_lib

BACKENDS = ("nccl", "gloo")

#: the collectives' timeout of a run without a time limit
GROUP_TIMEOUT_S = 600.0

#: the kernel modules whose launch counters ``run_ranks`` sends back
_COUNTED = ("paged_attn", "expert_stat", "paged_gather", "griffin_ffn",
            "glu_ffn")


@dataclass(frozen=True)
class ServingMesh:
    """One rank's view of a 1-D tensor-parallel mesh.  With ``group``
    None it only names the axis and its size (spec resolution, the
    reference's ``AbstractMesh``); its collectives then fail."""
    axis: str = "model"
    size: int = 1
    rank: int = 0
    backend: Optional[str] = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: Any = None

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return (self.axis,)

    @property
    def shape(self) -> Dict[str, int]:
        return {self.axis: self.size}


def abstract_mesh(n: int, axis: str = "model") -> ServingMesh:
    """Axis name and size only: enough to resolve specs (no ranks)."""
    return ServingMesh(axis=axis, size=n)


@dataclass(frozen=True)
class TrainMesh:
    """One rank's view of a named training mesh.  ``groups`` maps each
    non-empty set of axes to the process group of this rank's neighbours
    along those axes (the combined group of all axes is the world); with
    no groups it only names the axes and their sizes (spec resolution)."""
    axes: Tuple[str, ...] = ("data", "model")
    dims: Tuple[int, ...] = (1, 1)
    rank: int = 0
    backend: Optional[str] = None
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    groups: Dict[FrozenSet[str], Any] = field(default_factory=dict)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.axes

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis (row-major rank layout)."""
        out, r = {}, self.rank
        for ax, d in reversed(list(zip(self.axes, self.dims))):
            out[ax] = r % d
            r //= d
        return {ax: out[ax] for ax in self.axes}

    def coord(self, axes) -> int:
        """This rank's block index over ``axes`` (one axis, or a tuple in
        major-to-minor order, as a tuple rule splits a dimension)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        c, idx = self.coords, 0
        for ax in axes:
            idx = idx * self.shape[ax] + c[ax]
        return idx

    def extent(self, axes) -> int:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return math.prod(self.shape[a] for a in axes)

    def group(self, axes):
        """This rank's process group over ``axes`` (None for no axes)."""
        axes = frozenset((axes,) if isinstance(axes, str) else axes)
        return self.groups[axes] if axes else None


def abstract_train_mesh(shape: Sequence[int] = (2, 2),
                        axes: Sequence[str] = ("data", "model")) -> TrainMesh:
    """Axis names and sizes only: enough to resolve specs (no ranks)."""
    return TrainMesh(axes=tuple(axes), dims=tuple(shape))


def _group_blocks(axes: Tuple[str, ...], dims: Tuple[int, ...]):
    """For every non-empty set of axes (in a fixed order), the blocks of
    ranks that differ only along it, each with the coordinates of the
    other axes (row-major rank layout)."""
    coords = list(itertools.product(*[range(d) for d in dims]))
    for k in range(1, len(axes) + 1):
        for sub in itertools.combinations(range(len(axes)), k):
            blocks: Dict[tuple, List[int]] = {}
            for r, c in enumerate(coords):
                rest = tuple(c[i] for i in range(len(axes)) if i not in sub)
                blocks.setdefault(rest, []).append(r)
            yield frozenset(axes[i] for i in sub), sub, coords, blocks


def _train_groups(axes: Tuple[str, ...], dims: Tuple[int, ...], rank: int):
    """``dist.new_group`` for every set of axes and every block of ranks
    that differ only along it, called in the same order on every rank (a
    rank must join the creation of groups it is not in)."""
    out: Dict[FrozenSet[str], Any] = {}
    for key, sub, coords, blocks in _group_blocks(axes, dims):
        if len(sub) == len(axes):
            out[key] = dist.group.WORLD
            continue
        mine = tuple(coords[rank][i] for i in range(len(axes)) if i not in sub)
        for rest, ranks in blocks.items():
            g = dist.new_group(ranks)
            if rest == mine:
                out[key] = g
    return out


def dry_train_mesh(shape: Sequence[int] = (16, 16),
                   axes: Sequence[str] = ("data", "model"),
                   rank: int = 0) -> TrainMesh:
    """Rank ``rank``'s view of a ``shape`` mesh whose groups are
    ``sharding.DryGroup``s: the members ``make_host_mesh`` would give
    that rank's groups (the same ``_group_blocks``), so a group that
    crosses a node is one here too, and collectives are recorded, not
    run.  The dry-run steps one rank's program on ``meta`` tensors over
    it."""
    from repro_torch.distributed.sharding import DryGroup

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} outside the mesh {shape}")
    groups: Dict[FrozenSet[str], Any] = {}
    for key, sub, coords, blocks in _group_blocks(axes, shape):
        mine = tuple(coords[rank][i] for i in range(len(axes)) if i not in sub)
        groups[key] = DryGroup(blocks[mine])
    return TrainMesh(axes=axes, dims=shape, rank=rank, backend="dry",
                     device=torch.device("meta"), groups=groups)


def _check_backend(backend: str, device, n: int, what: str) -> torch.device:
    """The device of a mesh of ``n`` ranks on ``backend``, or the reason
    it cannot run there."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = backend_lib.resolve_device(device)
    if dev.type == "cpu" and backend != "gloo":
        raise ValueError("a mesh on the CPU runs on the 'gloo' backend only")
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"mesh {what} on 'nccl' needs one card per rank, found "
            f"{torch.cuda.device_count()}: NCCL refuses two ranks on one "
            f"card; let the ranks share it with backend='gloo'")
    return dev


def _join(n: int, backend: str, rank, init_method, timeout_s: float,
          what: str) -> int:
    """Join the default group of ``n`` ranks (or check the one this
    process joined); returns this rank."""
    if not dist.is_initialized():
        if rank is None or init_method is None:
            raise ValueError(f"{what}: a process that has not joined a "
                             "group needs rank and init_method")
        dist.init_process_group(
            backend, init_method=init_method, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    elif dist.get_world_size() != n or dist.get_backend() != backend:
        raise RuntimeError(
            f"this process already joined a group of "
            f"{dist.get_world_size()} ranks on {dist.get_backend()!r}, "
            f"not {n} on {backend!r}")
    return dist.get_rank()


def _rank_device(dev: torch.device, r: int, n: int) -> torch.device:
    if dev.type == "cpu":
        # the ranks share the host's cores: one rank's intra-op threads
        # would otherwise contend with the others' at every collective
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
        return dev
    dev = torch.device("cuda", r % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def make_host_mesh(shape: Sequence[int] = (2, 2),
                   axes: Sequence[str] = ("data", "model"), *,
                   backend: str, device=None, rank: Optional[int] = None,
                   init_method: Optional[str] = None,
                   timeout_s: float = 300.0) -> TrainMesh:
    """This process's rank of a ``shape`` mesh over ``axes`` on this host
    (the reference's ``make_host_mesh``): joins the default group of
    ``prod(shape)`` ranks as ``make_serving_mesh`` does and builds the
    axis groups.  ``device`` is the card by default (rank r on
    ``cuda:(r % device_count)``) or ``"cpu"``."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    dev = _check_backend(backend, device, n, f"{shape} ({n} ranks)")
    r = _join(n, backend, rank, init_method, timeout_s, "make_host_mesh")
    groups = _train_groups(axes, shape, r)
    return TrainMesh(axes=axes, dims=shape, rank=r, backend=backend,
                     device=_rank_device(dev, r, n), groups=groups)


def make_production_mesh(multi_pod: bool = False, *,
                         rank: Optional[int] = None,
                         init_method: Optional[str] = None,
                         timeout_s: float = 300.0) -> TrainMesh:
    """The reference's production mesh, one v5e-256 pod (16 x 16) or two
    (2 x 16 x 16): ``data`` carries data parallelism and FSDP, ``model``
    tensor and expert parallelism, ``pod`` pure data parallelism; one
    NCCL rank per card.  Fails naming the card count when this process
    has not joined a group of that size and fewer cards are visible, as
    the reference fails on fewer devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    joined = dist.is_initialized() and dist.get_world_size() == n
    if not joined and have < n:
        raise RuntimeError(
            f"mesh {shape} over {axes} needs {n} cards (one NCCL rank per "
            f"card), found {have}")
    return make_host_mesh(shape, axes, backend="nccl", rank=rank,
                          init_method=init_method, timeout_s=timeout_s)


def make_serving_mesh(n: int, axis: str = "model", *, backend: str,
                      device=None, rank: Optional[int] = None,
                      init_method: Optional[str] = None,
                      timeout_s: float = 300.0) -> ServingMesh:
    """This process's rank of an ``axis=n`` tensor-parallel mesh.

    Joins the default process group (``init_method`` such as
    ``tcp://localhost:PORT``, ``rank``, world size ``n``, collectives
    timing out after ``timeout_s``) unless this process already joined
    one of ``n`` ranks on ``backend``.  ``device`` is the card by default
    (rank r on ``cuda:(r % device_count)``) or ``"cpu"``."""
    dev = _check_backend(backend, device, n, f"{axis}={n}")
    r = _join(n, backend, rank, init_method, timeout_s, "make_serving_mesh")
    dev = _rank_device(dev, r, n)
    return ServingMesh(axis=axis, size=n, rank=r, backend=backend,
                       device=dev, group=dist.group.WORLD)


def launch_counts() -> Dict[str, int]:
    """Every kernel launch counter of this process, as ``module.attr``."""
    import importlib

    out = {}
    for name in _COUNTED:
        mod = importlib.import_module(f"repro_torch.kernels.{name}")
        for attr, v in vars(mod).items():
            if "launches" in attr and isinstance(v, int):
                out[f"{name}.{attr}"] = v
    return out


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank: int, n: int, axis: str, backend: str, device,
               port: int, args: Sequence, q, timeout_s: Optional[float],
               shape=None, axes=None) -> None:
    timeout_s = GROUP_TIMEOUT_S if timeout_s is None else timeout_s
    try:
        init = f"tcp://localhost:{port}"
        if shape is None:
            mesh = make_serving_mesh(n, axis, backend=backend, device=device,
                                     rank=rank, init_method=init,
                                     timeout_s=timeout_s)
        else:
            mesh = make_host_mesh(shape, axes, backend=backend, device=device,
                                  rank=rank, init_method=init,
                                  timeout_s=timeout_s)
        result = fn(mesh, *args)
        q.put((rank, True, result, launch_counts()))
    except BaseException:
        # the parent raises with this traceback
        q.put((rank, False, traceback.format_exc(), launch_counts()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, n: int, *, backend: str, device=None,
              axis: str = "model", args: Sequence = (),
              timeout_s: Optional[float] = 600.0,
              shape: Optional[Sequence[int]] = None,
              axes: Optional[Sequence[str]] = None
              ) -> Tuple[List[Any], Dict[str, int]]:
    """Run ``fn(mesh, *args)`` in ``n`` spawned processes, one per rank of
    an ``axis=n`` serving mesh on ``backend`` (``device`` as
    ``make_serving_mesh``), or, with ``shape`` and ``axes``, of that
    training mesh (``make_host_mesh``; ``n`` must be its size).

    ``fn`` must be importable by name, and it and ``args`` picklable; its
    result should be plain data (numbers, lists, numpy arrays).  Returns
    ``(results by rank, kernel launch counts summed over the ranks)``.
    Raises ``RuntimeError`` with the child's traceback if any rank fails,
    exits without a result or outlives ``timeout_s``; the other ranks,
    which would block in their next collective, are terminated.
    ``timeout_s=None`` sets no limit on the run (a server that runs until
    it is stopped; call it from the main thread): a SIGINT to this
    process is passed on to rank 0, and the run goes on until the ranks
    return; a collective of the world group still fails after
    ``GROUP_TIMEOUT_S``."""
    if shape is not None:
        shape, axes = tuple(shape), tuple(axes or ("data", "model"))
        if math.prod(shape) != n:
            raise ValueError(f"run_ranks: mesh {shape} has "
                             f"{math.prod(shape)} ranks, not {n}")
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, axis, backend, device, port, args, q,
                               timeout_s, shape, axes))
             for r in range(n)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    counts: Dict[str, int] = {}
    deadline = math.inf if timeout_s is None else time.monotonic() + timeout_s
    prev = None
    if timeout_s is None:  # a server: Ctrl-C stops it through rank 0
        prev = signal.signal(signal.SIGINT,
                             lambda *_: os.kill(procs[0].pid, signal.SIGINT))

    def take(item) -> None:
        r, ok, payload, c = item
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        (results if ok else errors)[r] = payload

    try:
        while len(results) < n and not errors:
            left = deadline - time.monotonic()
            if left <= 0:
                errors[-1] = f"timed out after {timeout_s:.0f} s"
                break
            try:
                take(q.get(timeout=min(left, 1.0)))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in results
                        and p.exitcode not in (None, 0)]
                if dead:
                    try:  # its own report may still be in the pipe
                        take(q.get(timeout=2.0))
                    except queue.Empty:
                        for r in dead:
                            errors[r] = (f"exited with code "
                                         f"{procs[r].exitcode} and no report")
    finally:
        if prev is not None:
            signal.signal(signal.SIGINT, prev)
        for p in procs:
            p.join(timeout=30 if not errors else 1)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        q.close()
    if errors:
        msg = "\n".join(f"rank {r}: {e}" for r, e in sorted(errors.items()))
        raise RuntimeError(f"run of {n} ranks on {backend} "
                           f"failed:\n{msg}")
    return [results[r] for r in range(n)], counts
