"""Closed-loop load generator for the serving frontend.

Traffic model (the shape real chat serving sees, each knob cited by the
benchmark write-up in EXPERIMENTS.md):

* **Zipf-shared system prompts** — every session opens with one of a
  small pool of system prompts drawn Zipf(1.1), so a few prompts
  dominate and the prefix cache has something real to hit;
* **Poisson session arrivals** — exponential inter-arrival gaps at a
  configurable rate; the 1x/2x overload points in the benchmark are
  just two rates around calibrated capacity;
* **long-tail generation lengths** — per-turn ``max_new`` is lognormal
  (median short, occasional long generations), the distribution that
  makes continuous batching matter;
* **multi-turn chat** — a session is 1..max_turns turns; each turn's
  prompt is the full conversation so far (system + prior user/assistant
  tokens), so later turns are natural prefix-cache warm starts, with
  exponential think time between turns (closed loop: turn ``k+1`` is
  not sent until turn ``k``'s stream finished).

The load loop is **synchronous and clock-injected**: it interleaves
arrival submission with ``ServingFrontend.tick()`` and advances the
clock explicitly — under a ``FakeClock`` the whole run is deterministic
(tier-1 replays it twice and asserts identical event logs), and the
benchmark binds the same loop to real time by advancing nothing and
letting ``time.perf_counter`` move on its own.

Per-turn terminal handling: a rejected (429) or shed turn ends its
session — a closed-loop client that lost a turn has no conversation
state to continue from.  Sessions whose next turn would exceed the
block-table capacity end early (counted, not errored).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.frontend import (FINISHED, SHED, QueueFull,
                                    ServingFrontend, StreamHandle)

__all__ = ["TurnScript", "SessionScript", "chat_sessions",
           "run_closed_loop", "LoadResult"]


@dataclass(frozen=True)
class TurnScript:
    user_tokens: Tuple[int, ...]  # appended to the conversation
    max_new: int


@dataclass(frozen=True)
class SessionScript:
    sid: int
    start_t: float  # arrival time (relative seconds from run start)
    system: Tuple[int, ...]  # Zipf-shared opening prompt
    turns: Tuple[TurnScript, ...]
    think_s: Tuple[float, ...]  # gap before each turn past the first
    slo: str
    deadline_s: Optional[float] = None  # per-class override, if any


def chat_sessions(n_sessions: int, *, rate: float, seed: int,
                  vocab: int = 1000, n_system: int = 4,
                  system_len: int = 24, user_len: Tuple[int, int] = (3, 8),
                  max_turns: int = 3, gen_median: float = 6.0,
                  gen_sigma: float = 0.6, gen_cap: int = 24,
                  think_mean_s: float = 0.05,
                  slo_mix: Optional[Dict[str, float]] = None,
                  deadlines: Optional[Dict[str, Optional[float]]] = None,
                  ) -> List[SessionScript]:
    """Sample a reproducible session trace (all randomness from ``seed``).

    ``rate`` is the Poisson session-arrival rate (sessions/second);
    ``deadlines`` optionally overrides the per-class TTFT deadline —
    the benchmark derives these from calibrated capacity rather than
    using the static class defaults."""
    rng = np.random.default_rng(seed)
    slo_mix = slo_mix or {"interactive": 0.5, "standard": 0.3, "batch": 0.2}
    classes = sorted(slo_mix)
    probs = np.asarray([slo_mix[c] for c in classes], np.float64)
    probs = probs / probs.sum()
    # Zipf-weighted shared system prompts.  System tokens come from the
    # upper half of the vocab, user tokens from the lower half, so
    # accidental cross-prompt prefix matches cannot happen while every
    # id stays inside the model's embedding table
    systems = [tuple(int(t) for t in rng.integers(vocab // 2, vocab,
                                                  size=system_len))
               for _ in range(n_system)]
    zipf_w = 1.0 / np.arange(1, n_system + 1) ** 1.1
    zipf_w /= zipf_w.sum()
    starts = np.cumsum(rng.exponential(1.0 / rate, size=n_sessions))
    sessions = []
    for sid in range(n_sessions):
        n_turns = int(rng.integers(1, max_turns + 1))
        turns = []
        for _ in range(n_turns):
            ulen = int(rng.integers(user_len[0], user_len[1] + 1))
            gen = int(np.clip(
                np.round(rng.lognormal(np.log(gen_median), gen_sigma)),
                2, gen_cap))
            turns.append(TurnScript(
                tuple(int(t) for t in rng.integers(0, vocab // 2,
                                                   size=ulen)),
                gen))
        slo = classes[int(rng.choice(len(classes), p=probs))]
        sessions.append(SessionScript(
            sid=sid, start_t=float(starts[sid]),
            system=systems[int(rng.choice(n_system, p=zipf_w))],
            turns=tuple(turns),
            think_s=tuple(float(t) for t in
                          rng.exponential(think_mean_s, size=n_turns)),
            slo=slo,
            deadline_s=(deadlines or {}).get(slo),
        ))
    return sessions


@dataclass
class _TurnRecord:
    sid: int
    turn: int
    slo: str
    state: str  # finished | shed | cancelled | aborted | rejected
    prompt: Tuple[int, ...] = ()
    max_new: int = 0
    tokens: Tuple[int, ...] = ()
    ttft: Optional[float] = None
    slo_met: Optional[bool] = None


@dataclass
class LoadResult:
    turns: List[_TurnRecord] = field(default_factory=list)
    truncated_sessions: int = 0
    wall_s: float = 0.0

    def summary(self) -> Dict[str, float]:
        done = [t for t in self.turns if t.state == "finished"]
        met = [t for t in done if t.slo_met]
        ttfts = sorted(t.ttft for t in done if t.ttft is not None)
        goodput_tokens = sum(len(t.tokens) for t in met)

        def pct(p: float) -> float:
            if not ttfts:
                return 0.0
            return float(np.percentile(np.asarray(ttfts), p))

        n = len(self.turns)
        return {
            "turns": float(n),
            "finished": float(len(done)),
            "shed": float(sum(t.state == "shed" for t in self.turns)),
            "rejected": float(sum(t.state == "rejected"
                                  for t in self.turns)),
            "shed_rate": (sum(t.state in ("shed", "rejected")
                              for t in self.turns) / n) if n else 0.0,
            "slo_met_rate": len(met) / len(done) if done else 0.0,
            "goodput_tokens_per_sec":
                goodput_tokens / self.wall_s if self.wall_s > 0 else 0.0,
            "ttft_p50_s": pct(50),
            "ttft_p99_s": pct(99),
            "wall_s": float(self.wall_s),
        }

    def identity_pairs(self) -> Dict[Tuple[Tuple[int, ...], int],
                                     Tuple[int, ...]]:
        """(prompt, max_new) -> streamed tokens, for every finished
        turn — the oracle replay in the benchmark drains these through
        a fresh synchronous server and compares token-for-token.
        Determinism of the engine guarantees duplicates agree; assert
        rather than silently keep one."""
        out: Dict[Tuple[Tuple[int, ...], int], Tuple[int, ...]] = {}
        for t in self.turns:
            if t.state != "finished":
                continue
            key = (t.prompt, t.max_new)
            if key in out:
                assert out[key] == t.tokens, \
                    f"same (prompt, max_new) produced different streams: {key[1]}"
            out[key] = t.tokens
        return out


def run_closed_loop(frontend: ServingFrontend, sessions: List[SessionScript],
                    *, clock: Callable[[], float],
                    advance: Optional[Callable[[float], Any]] = None,
                    tick_s: float = 0.002,
                    max_ticks: int = 1_000_000) -> LoadResult:
    """Drive ``sessions`` through ``frontend`` to completion.

    ``clock`` must be the frontend's clock.  ``advance`` moves virtual
    time (``FakeClock.advance``); leave it ``None`` when the clock is
    real time (the benchmark path) — then ``tick_s`` is ignored, engine
    work paces the loop on its own, and an idle wait for a future
    arrival is a real ``time.sleep`` (benchmark only; the tier-1 path
    always injects ``advance``)."""
    import time as _time
    t0 = clock()
    # per-session cursor: conversation tokens so far + next turn index
    convo: Dict[int, List[int]] = {}
    next_turn: Dict[int, int] = {}
    # (due_t, sid): a session's next turn becomes submittable at due_t
    due: List[Tuple[float, int]] = sorted(
        (s.start_t + t0, s.sid) for s in sessions)
    by_sid = {s.sid: s for s in sessions}
    inflight: Dict[int, Tuple[StreamHandle, _TurnRecord]] = {}
    res = LoadResult()
    cap = frontend.sched.pcfg.max_request_len

    def submit_due() -> None:
        while due and due[0][0] <= clock():
            _, sid = due.pop(0)
            s = by_sid[sid]
            k = next_turn.setdefault(sid, 0)
            turn = s.turns[k]
            ctx = convo.setdefault(sid, list(s.system))
            prompt = ctx + list(turn.user_tokens)
            rec = _TurnRecord(sid, k, s.slo, "submitted")
            if len(prompt) + turn.max_new > cap:
                res.truncated_sessions += 1
                continue  # session over: context no longer fits
            try:
                h = frontend.submit(np.asarray(prompt, np.int32),
                                    turn.max_new, slo=s.slo,
                                    deadline_s=s.deadline_s)
            except QueueFull:
                rec.state = "rejected"
                res.turns.append(rec)
                continue  # closed loop: rejected turn ends the session
            rec.prompt = tuple(prompt)
            rec.max_new = turn.max_new
            inflight[h.rid] = (h, rec)

    def reap_done() -> None:
        for rid in [r for r, (h, _) in inflight.items() if h.done]:
            h, rec = inflight.pop(rid)
            rec.state = h.state
            rec.tokens = tuple(h.tokens)
            rec.slo_met = h.slo_met
            tl = frontend.metrics.requests.get(rid)
            if tl is not None:
                rec.ttft = tl.ttft
            res.turns.append(rec)
            s = by_sid[rec.sid]
            if h.state == FINISHED and rec.turn + 1 < len(s.turns):
                # assistant reply joins the conversation; next turn
                # arrives after think time
                convo[rec.sid] = list(rec.prompt) + list(rec.tokens)
                next_turn[rec.sid] = rec.turn + 1
                due.append((clock() + s.think_s[rec.turn + 1], rec.sid))
                due.sort()
            # shed/rejected/cancelled/aborted turns end the session

    ticks = 0
    while due or inflight or frontend.has_work:
        submit_due()
        frontend.tick()
        reap_done()
        ticks += 1
        if ticks > max_ticks:
            raise RuntimeError(f"load loop not done after {max_ticks} ticks")
        idle = not inflight and not frontend.has_work and due
        if advance is not None:
            if due or inflight or frontend.has_work:
                advance(tick_s)
            if idle:
                # idle until the next arrival: jump straight to it
                advance(max(0.0, due[0][0] - clock()))
        elif idle:
            _time.sleep(max(0.0, due[0][0] - clock()))
    res.wall_s = clock() - t0
    return res
