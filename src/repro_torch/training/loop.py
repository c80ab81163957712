"""Training loop: data -> train step -> metrics, with checkpointing,
preemption handling, straggler monitoring, and auto-resume (port of
``repro/training/loop.py``).

Checkpoints are written in the reference's layout
(``bridge.train_state_to_jax``), so ``repro.checkpoint`` restores what the
port trained, the port resumes what the reference trained, and
``launch/serve.py --ckpt-dir`` serves either.

On a training mesh (``mesh=``, ``rules=``) every rank runs this loop over
the same global batches: rank 0 writes the gathered full-array
checkpoint (``TrainTP.gather_state``, the reference's layout), every rank
restores the full arrays and cuts its blocks, and each step the ranks
agree on the preemption flag, so all of them stop at the same step.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.distributed import sharding as shlib
from repro_torch.kernels import backend
from repro_torch.runtime.preemption import PreemptionGuard
from repro_torch.runtime.straggler import StragglerDetector
from repro_torch.training.optimizer import Optimizer
from repro_torch.training.train_step import build_train_step, init_train_state


@dataclass
class TrainResult:
    state: Any
    losses: list
    steps_done: int
    preempted: bool = False


def train(
    cfg,
    optimizer: Optimizer,
    loader: Iterable[Dict[str, np.ndarray]],
    num_steps: int,
    *,
    seed: int = 0,
    ckpt: Optional[CheckpointManager] = None,
    guard: Optional[PreemptionGuard] = None,
    log_every: int = 20,
    accum_steps: int = 1,
    state: Any = None,
    log_fn: Callable[[str], None] = print,
    device=None,
    mesh=None,
    rules=None,
) -> TrainResult:
    """Train from ``state``, else from the latest checkpoint of ``ckpt``,
    else from an init drawn from ``seed``, on ``device`` (default: the
    card, or the mesh's device; a given ``state`` stays where it is).
    With ``mesh`` and ``rules``, this rank's share of the sharded run:
    ``state`` holds its blocks."""
    step_fn = build_train_step(cfg, optimizer, accum_steps=accum_steps,
                               mesh=mesh, rules=rules)
    tp = getattr(step_fn, "tp", None)
    lead = mesh is None or mesh.rank == 0
    say = log_fn if lead else (lambda s: None)
    straggler = StragglerDetector()

    start_step = 0
    if state is None:
        device = mesh.device if mesh is not None and device is None \
            else backend.resolve_device(device)
        if ckpt is not None and ckpt.latest_step() is not None:
            restored, start_step = ckpt.restore_latest()
            state = bridge.train_state_from_jax(restored, cfg, device, tp)
            say(f"[resume] restored checkpoint at step {start_step}")
        elif tp is not None:
            state = tp.init_train_state(optimizer, seed, device)
        else:
            state = init_train_state(cfg, optimizer, seed, device)
    device = state["step"].device

    def save(step: int, force: bool = False) -> None:
        full = state if tp is None else tp.gather_state(state)
        if lead:
            ckpt.save(step, bridge.train_state_to_jax(full, cfg), force=force)

    def stop() -> bool:
        flag = guard is not None and guard.preempted
        if mesh is None:
            return flag
        t = torch.tensor([1.0 if flag else 0.0], device=device)
        return bool(shlib.all_reduce_(t, mesh.group(mesh.axes)).item() > 0)

    losses = []
    preempted = False
    it = iter(loader)
    for step in range(start_step, num_steps):
        batch = {k: torch.as_tensor(v).to(device) for k, v in next(it).items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        straggler.record(0, dt)
        losses.append(loss)
        if log_every and (step % log_every == 0 or step == num_steps - 1):
            say(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
        if ckpt is not None and ckpt.should_save(step + 1):
            save(step + 1)
        if stop():
            if ckpt is not None:
                save(step + 1, force=True)
                ckpt.wait()
            say(f"[preempt] checkpointed at step {step + 1}, exiting")
            preempted = True
            break
    if ckpt is not None:
        ckpt.wait()
    return TrainResult(state=state, losses=losses, steps_done=len(losses),
                       preempted=preempted)
