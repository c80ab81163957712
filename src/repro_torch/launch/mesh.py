"""Tensor-parallel serving meshes over ``torch.distributed`` (port of
``repro/launch/mesh.py``'s ``make_serving_mesh``).

The reference's mesh is a set of devices one program is compiled for.
The port runs **one process per shard**: every rank builds the same
``PagedServer`` on its own shard, gets the same submissions, and the
ranks meet only in the all-reduces of ``distributed.sharding.psum_if_tp``
and ``distributed.tp.gather_stats``.  A ``ServingMesh`` is this rank's
view of that: the axis name and size, its rank, the backend, its device
and the process group.

Backends are chosen by the caller, never switched here:

* ``"nccl"`` — one card per rank (``cuda:(rank % device_count)``); NCCL
  refuses two ranks on one card, so fewer cards than ranks is an error
  that names ``gloo``.
* ``"gloo"`` — any number of ranks on the CPU (``device="cpu"``, the only
  backend there) or sharing one card: gloo reduces CUDA tensors by
  staging them through host memory.  The port's TP path needs only
  ``all_reduce``, which gloo documents for CUDA tensors.

``run_ranks`` spawns the ranks of one mesh on this host and collects
what each returns.  ``make_host_mesh`` / ``make_production_mesh`` (the
reference's TPU pod shapes) are not ported (ROADMAP, Queue A item 5).
"""
from __future__ import annotations

import datetime
import os
import queue
import socket
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.kernels import backend as backend_lib

BACKENDS = ("nccl", "gloo")

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
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    dev = backend_lib.resolve_device(device)
    if dev.type == "cpu" and backend != "gloo":
        raise ValueError("a mesh on the CPU runs on the 'gloo' backend only")
    if backend == "nccl" and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"mesh {axis}={n} on 'nccl' needs one card per rank, found "
            f"{torch.cuda.device_count()}: NCCL refuses two ranks on one "
            f"card; let the ranks share it with backend='gloo'"
        )
    if not dist.is_initialized():
        if rank is None or init_method is None:
            raise ValueError("make_serving_mesh: a process that has not "
                             "joined a group needs rank and init_method")
        dist.init_process_group(
            backend, init_method=init_method, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    elif dist.get_world_size() != n or dist.get_backend() != backend:
        raise RuntimeError(
            f"this process already joined a group of "
            f"{dist.get_world_size()} ranks on {dist.get_backend()!r}, "
            f"not {n} on {backend!r}")
    r = dist.get_rank()
    if dev.type == "cpu":
        # the ranks share the host's cores: one rank's intra-op threads
        # would otherwise contend with the others' at every collective
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    if dev.type == "cuda":
        dev = torch.device("cuda", r % torch.cuda.device_count())
        torch.cuda.set_device(dev)
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
               port: int, args: Sequence, q, timeout_s: float) -> None:
    try:
        mesh = make_serving_mesh(n, axis, backend=backend, device=device,
                                 rank=rank,
                                 init_method=f"tcp://localhost:{port}",
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
              timeout_s: float = 600.0) -> Tuple[List[Any], Dict[str, int]]:
    """Run ``fn(mesh, *args)`` in ``n`` spawned processes, one per rank of
    an ``axis=n`` mesh on ``backend`` (``device`` as ``make_serving_mesh``).

    ``fn`` must be importable by name, and it and ``args`` picklable; its
    result should be plain data (numbers, lists, numpy arrays).  Returns
    ``(results by rank, kernel launch counts summed over the ranks)``.
    Raises ``RuntimeError`` with the child's traceback if any rank fails,
    exits without a result or outlives ``timeout_s``; the other ranks,
    which would block in their next collective, are terminated."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = _free_port()
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, axis, backend, device, port, args, q,
                               timeout_s))
             for r in range(n)]
    for p in procs:
        p.start()
    results: Dict[int, Any] = {}
    errors: Dict[int, str] = {}
    counts: Dict[str, int] = {}
    deadline = time.monotonic() + timeout_s

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
        raise RuntimeError(f"tensor-parallel run of {n} ranks on {backend} "
                           f"failed:\n{msg}")
    return [results[r] for r in range(n)], counts
