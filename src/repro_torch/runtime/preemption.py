"""Preemption handling: checkpoint-on-signal (a copy of
``repro/runtime/preemption.py``).

A preempted machine gets SIGTERM with a grace window; the guard flips a
flag the train loop checks each step, forcing an immediate checkpoint +
clean exit.  ``simulate()`` lets tests trigger the same path without
signals.
"""
from __future__ import annotations

import signal
import threading
from typing import Optional


class PreemptionGuard:
    def __init__(self, install_handlers: bool = True):
        self._flag = threading.Event()
        self._installed = []
        if install_handlers:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    prev = signal.signal(sig, self._handler)
                    self._installed.append((sig, prev))
                except ValueError:  # non-main thread
                    pass

    def _handler(self, signum, frame):
        self._flag.set()

    def simulate(self) -> None:
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def uninstall(self) -> None:
        for sig, prev in self._installed:
            signal.signal(sig, prev)
        self._installed = []
