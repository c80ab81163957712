"""Checkpoint manager: interval policy, keep-N rotation, auto-resume
(port of ``repro/checkpoint/manager.py``)."""
from __future__ import annotations

import shutil
import threading
from pathlib import Path
from typing import Any, Optional, Tuple

from repro_torch.checkpoint import checkpointer


class CheckpointManager:
    def __init__(self, ckpt_dir: str, interval: int = 100, keep: int = 3,
                 use_async: bool = True):
        self.dir = str(ckpt_dir)
        self.interval = interval
        self.keep = keep
        self.use_async = use_async
        self._pending: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.interval == 0

    def save(self, step: int, tree: Any, force: bool = False) -> bool:
        if not force and not self.should_save(step):
            return False
        self.wait()
        if self.use_async:
            self._pending = checkpointer.save_async(self.dir, step, tree)
        else:
            checkpointer.save(self.dir, step, tree)
        self._gc()
        return True

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = checkpointer.available_steps(self.dir)
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(Path(self.dir) / f"step_{s:08d}", ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = checkpointer.available_steps(self.dir)
        return steps[-1] if steps else None

    def restore_latest(self) -> Optional[Tuple[Any, int]]:
        if self.latest_step() is None:
            return None
        return checkpointer.restore(self.dir)
