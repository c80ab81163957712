"""The serving frontend over a tensor-parallel mesh: rank 0 leads, the
other ranks replay.

The reference serves a mesh from one process, so its ``ServingFrontend``
drives one ``PagedServer`` whatever the mesh.  The port runs one process
per rank (``launch/mesh.py``), each with its own ``PagedServer`` on its
shard, and every rank must see the same submissions, cancels and ticks
in the same order, or their collectives pair up the wrong steps.

* **Rank 0 owns the socket, the clock, admission, shedding and
  cancels.**  Its frontend drives a ``MeshLeader`` in place of the
  server.  Every engine-level call the frontend makes happens inside
  ``tick()``: ``submit`` (admission), ``cancel`` (cancels and shedding)
  and ``step``.  The leader applies each to rank 0's server and records
  it.
* **One message a tick.**  Before rank 0 steps, the leader broadcasts
  the operations recorded since its last message and the order to step,
  in one ``broadcast_object_list``.  Operations of a tick that does not
  step travel with the next message; only their order against the steps
  matters to the engine.
* **The followers replay exactly** (``follow``): each applies the
  operations to its own server in order, then steps when told.  A
  submission carries rank 0's rid, prompt, ``max_new``, priority,
  absolute deadline and tier, so the schedulers order their queues alike;
  no follower reads a clock to decide anything.
* **Control messages run on a gloo group of their own**
  (``ControlChannel``): an NCCL group broadcasts CUDA tensors only, and
  the data path's group stays free for the steps' all-reduces.
* **Idle.**  An idle frontend parks on its wake event, and the
  followers wait in their next receive for as long as it idles: the
  control group's timeout (``IDLE_TIMEOUT``) is a year, as a server has
  no time limit.  A dead rank is found by the launcher's parent
  (``run_ranks``), which polls every rank's exit code each second.
* **Stop.**  ``MeshLeader.stop`` broadcasts the stop; every rank then
  returns ``outcome(server)``, which the launcher holds equal across
  ranks.  A rank that dies fails the run (``run_ranks`` ends the others):
  rank 0 never serves on alone.
"""
from __future__ import annotations

import datetime
from typing import Any, Dict, List, Optional

import numpy as np
import torch.distributed as dist

#: the control group's timeout: a follower waits for rank 0's next
#: message for as long as the frontend idles (``run_ranks``' own limit,
#: where a run has one, still ends it)
IDLE_TIMEOUT = datetime.timedelta(days=365)


class ControlChannel:
    """A gloo group over every rank of the world, for rank 0's messages.
    Built by every rank at the same point (``new_group`` is collective)."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)
        self.messages = 0

    def send(self, msg: Dict[str, Any]) -> None:
        """Rank 0: broadcast ``msg``."""
        dist.broadcast_object_list([msg], src=0, group=self.group)
        self.messages += 1

    def recv(self) -> Dict[str, Any]:
        """Ranks >= 1: the next message of rank 0."""
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        self.messages += 1
        return box[0]


class MeshLeader:
    """Rank 0's ``PagedServer`` as its frontend sees it: ``submit``,
    ``cancel`` and ``step`` are applied here and relayed to the
    followers; everything else is the server's own."""

    def __init__(self, server, channel: ControlChannel):
        self.server = server
        self.channel = channel
        self._ops: List[tuple] = []

    def __getattr__(self, name):
        return getattr(self.server, name)

    def submit(self, prompt, max_new: int, rid: Optional[int] = None,
               priority: int = 0, deadline: Optional[float] = None,
               tier: Optional[float] = None) -> int:
        rid = self.server.submit(prompt, max_new, rid=rid, priority=priority,
                                 deadline=deadline, tier=tier)
        self._ops.append(("submit", np.asarray(prompt, np.int32), int(max_new),
                          rid, priority, deadline, tier))
        return rid

    def cancel(self, rid: int, reason: str = "cancelled") -> bool:
        ok = self.server.cancel(rid, reason=reason)
        self._ops.append(("cancel", rid, reason))
        return ok

    def _send(self, step: bool = False, stop: bool = False) -> None:
        ops, self._ops = self._ops, []
        self.channel.send({"ops": ops, "step": step, "stop": stop})

    def step(self) -> bool:
        self._send(step=True)
        return self.server.step()

    def stop(self) -> None:
        """Tell the followers to return (once, after the last tick)."""
        self._send(stop=True)


def apply(server, op: tuple) -> None:
    """One recorded operation on a follower's server."""
    if op[0] == "submit":
        _, prompt, max_new, rid, priority, deadline, tier = op
        server.submit(prompt, max_new, rid=rid, priority=priority,
                      deadline=deadline, tier=tier)
    elif op[0] == "cancel":
        server.cancel(op[1], reason=op[2])
    else:
        raise ValueError(f"unknown relayed operation {op[0]!r}")


def follow(server, channel: ControlChannel) -> Dict[str, Any]:
    """A follower's loop: replay rank 0's operations and steps until the
    stop; returns ``outcome(server)``."""
    while True:
        msg = channel.recv()
        for op in msg["ops"]:
            apply(server, op)
        if msg["step"]:
            server.step()
        if msg["stop"]:
            return outcome(server)


def outcome(server) -> Dict[str, Any]:
    """What every rank must agree on after a session: the finished
    requests' streams, the aborted ones' reasons, the free pages."""
    fin = server.sched.finished
    return {
        "streams": {rid: list(r.generated) for rid, r in fin.items()
                    if not r.aborted},
        "aborted": {rid: server.metrics.requests[rid].abort_reason
                    for rid, r in fin.items() if r.aborted},
        "free_pages": server.sched.alloc.num_free,
    }
