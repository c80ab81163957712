"""Training loop: data -> train step -> metrics, with checkpointing,
preemption handling, straggler monitoring, and auto-resume (port of
``repro/training/loop.py``).

Checkpoints are written in the reference's layout
(``bridge.train_state_to_jax``), so ``repro.checkpoint`` restores what the
port trained, the port resumes what the reference trained, and
``launch/serve.py --ckpt-dir`` serves either.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
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
) -> TrainResult:
    """Train from ``state``, else from the latest checkpoint of ``ckpt``,
    else from an init drawn from ``seed``, on ``device`` (default: the
    card; a given ``state`` stays where it is)."""
    step_fn = build_train_step(cfg, optimizer, accum_steps=accum_steps)
    straggler = StragglerDetector()

    start_step = 0
    if state is None:
        device = backend.resolve_device(device)
        if ckpt is not None and ckpt.latest_step() is not None:
            restored, start_step = ckpt.restore_latest()
            state = bridge.train_state_from_jax(restored, cfg, device)
            log_fn(f"[resume] restored checkpoint at step {start_step}")
        else:
            state = init_train_state(cfg, optimizer, seed, device)
    device = state["step"].device

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
            log_fn(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
        if ckpt is not None and ckpt.should_save(step + 1):
            ckpt.save(step + 1, bridge.train_state_to_jax(state, cfg))
        if guard is not None and guard.preempted:
            if ckpt is not None:
                ckpt.save(step + 1, bridge.train_state_to_jax(state, cfg),
                          force=True)
                ckpt.wait()
            log_fn(f"[preempt] checkpointed at step {step + 1}, exiting")
            preempted = True
            break
    if ckpt is not None:
        ckpt.wait()
    return TrainResult(state=state, losses=losses, steps_done=len(losses),
                       preempted=preempted)
