"""Generation engine: prefill -> GRIFFIN select/compact -> pruned decode
(port of ``repro/serving/engine.py``).

Two serving modes:

* ``GenerationEngine.generate`` — synchronized batch generation: all
  sequences share a position counter and GRIFFIN's selection is
  aggregated over the batch by eq. 7 — exactly the paper's batched
  setting (Table 4).  The prompt runs through ``decoder.forward`` with
  the full FF blocks and the statistics (``expert_stat`` on the card),
  the prefill K/V fill a contiguous decode cache, and every later token
  runs ``decoder.decode_step`` on the compacted FF.
* ``ContinuousBatcher`` — slot-based continuous batching: requests of
  different lengths join and leave a fixed set of slots, each with its
  own position counter, cache and GRIFFIN expert set.

The production serving path for the dense attention families is
``serving/server.py::PagedServer``; the ``ContinuousBatcher`` is the
fallback for the families the paged path does not cover (MoE, MLA, SSM
and the RG-LRU hybrid, whose caches hold recurrent states beside or
instead of KV).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import griffin as griffin_lib
from repro_torch.kernels import backend as backend_lib
from repro_torch.models import decoder
from repro_torch.serving.sampling import SamplingConfig, sample


def _resolve(params: Dict, device, who: str) -> torch.device:
    """``device`` (the card by default), which must hold ``params``."""
    dev = backend_lib.resolve_device(device)
    table = params["embed"]["table"]
    if table.device.type != dev.type:
        raise ValueError(f"params live on {table.device}, the {who} on {dev}")
    return dev


class GenerationEngine:
    """Batch generation with the paper's prompt->generation split.

    ``params`` live on ``device`` (the card unless ``device="cpu"``).
    The reference jits its prefill and decode; here they are plain
    methods."""

    def __init__(
        self,
        cfg,
        params: Dict,
        gcfg: Optional[griffin_lib.GriffinConfig] = None,
        max_len: int = 2048,
        q_chunk: int = 512,
        device=None,
    ):
        self.device = _resolve(params, device, "engine")
        self.cfg = cfg
        self.params = params
        self.gcfg = gcfg if (gcfg is not None and cfg.griffin and cfg.has_ffn) else None
        self.max_len = max_len
        self.q_chunk = q_chunk

    def prefill(self, tokens: torch.Tensor):
        """Full-model prompt pass: (last logits [B, V], ``decoder.Aux``
        with the prefill K/V and, with GRIFFIN, the statistics)."""
        logits, aux = decoder.forward(
            self.params, self.cfg, tokens, collect_stats=self.gcfg is not None,
            want_kv=True, q_chunk=self.q_chunk, logits_mode="last",
        )
        return logits[:, 0], aux

    def decode(self, cache, pruned, token: torch.Tensor, pos: int):
        """One step on the (compacted) model: (logits [B,1,V], cache)."""
        return decoder.decode_step(self.params, self.cfg, cache, token, pos,
                                   pruned)

    # -- GRIFFIN ----------------------------------------------------------
    def select_and_compact(self, stats) -> Dict:
        stats = decoder.prune_stats_tree(stats, self.cfg)
        ffn_tree = decoder.extract_ffn_tree(self.params, self.cfg)
        pruned, _ = griffin_lib.select_and_compact(stats, ffn_tree, self.gcfg)
        return pruned

    # -- API ---------------------------------------------------------------
    def generate(
        self,
        tokens,  # [B, S] prompt (tensor or array)
        steps: int,
        sampling: SamplingConfig = SamplingConfig(),
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Returns generated tokens [B, steps] int32 on the engine's
        device.  Stochastic sampling draws from ``generator`` (on that
        device; the reference takes a ``PRNGKey``); greedy needs none."""
        tokens = torch.as_tensor(tokens, device=self.device)
        B, S = tokens.shape
        if S + steps > self.max_len:
            raise ValueError(f"prompt {S} + steps {steps} > max_len {self.max_len}")
        last_logits, aux = self.prefill(tokens)
        pruned = self.select_and_compact(aux.stats) if self.gcfg else None
        cache = decoder.init_cache(self.cfg, B, self.max_len, self.device)
        cache = decoder.fill_cache_from_prefill(self.cfg, cache, aux.kv)
        del aux

        tok = sample(last_logits, generator, sampling)[:, None]
        out = [tok]
        for pos in range(S, S + steps - 1):
            logits, cache = self.decode(cache, pruned, tok, pos)
            tok = sample(logits[:, 0], generator, sampling)[:, None]
            out.append(tok)
        return torch.cat(out, dim=1)


# ---------------------------------------------------------------------------
# Continuous batching
# ---------------------------------------------------------------------------

@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # [S] int32
    max_new: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Slot-based continuous batching with per-slot GRIFFIN expert sets.

    ``n_slots`` sequences decode in lockstep; a finished slot is refilled
    by prefilling the next queued request into a fresh B=1 cache.  Each
    slot keeps its own position and, with GRIFFIN, its own compacted FF.
    The reference ``vmap``s a B=1 ``decode_step`` over every slot and
    discards the empty slots' outputs; here each tick runs one B=1
    ``decode_step`` per **live** slot, which gives the same tokens (a
    slot's step reads only its own cache, and an MoE step routes its one
    token at the capacity of a one-token call, as under ``vmap``).
    ``params`` live on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, cfg, params, n_slots: int = 4, max_len: int = 512,
                 gcfg: Optional[griffin_lib.GriffinConfig] = None,
                 device=None):
        self.device = _resolve(params, device, "batcher")
        self.cfg, self.params = cfg, params
        self.n_slots, self.max_len = n_slots, max_len
        self.gcfg = gcfg if (gcfg is not None and cfg.griffin and cfg.has_ffn) else None
        self.cache: List[Optional[List[Dict]]] = [None] * n_slots
        self.pruned: List[Optional[Dict]] = [None] * n_slots
        self.pos = np.zeros(n_slots, np.int64)
        self.active: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []

    def submit(self, prompt: np.ndarray, max_new: int, rid: int):
        self.queue.append(Request(rid, np.asarray(prompt, np.int32), max_new))

    def _insert(self, slot: int, req: Request):
        tokens = torch.as_tensor(req.prompt, device=self.device)[None, :]
        logits, aux = decoder.forward(
            self.params, self.cfg, tokens, collect_stats=self.gcfg is not None,
            want_kv=True, q_chunk=256, logits_mode="last")
        cache = decoder.init_cache(self.cfg, 1, self.max_len, self.device)
        self.cache[slot] = decoder.fill_cache_from_prefill(self.cfg, cache, aux.kv)
        if self.gcfg:
            stats = decoder.prune_stats_tree(aux.stats, self.cfg)
            ffn_tree = decoder.extract_ffn_tree(self.params, self.cfg)
            self.pruned[slot], _ = griffin_lib.select_and_compact(
                stats, ffn_tree, self.gcfg)
        req.generated.append(int(torch.argmax(logits[0, 0])))
        self.active[slot] = req
        self.pos[slot] = len(req.prompt)

    def step(self) -> bool:
        """One scheduler tick: refill free slots, one decode step for
        every live slot.  Returns False when no work remains."""
        for s in range(self.n_slots):
            if self.active[s] is None and self.queue:
                self._insert(s, self.queue.pop(0))
        live = [s for s in range(self.n_slots) if self.active[s] is not None]
        if not live:
            return False
        for s in live:
            req = self.active[s]
            tok = torch.tensor([[req.generated[-1]]], dtype=torch.int32,
                               device=self.device)
            logits, _ = decoder.decode_step(self.params, self.cfg, self.cache[s],
                                            tok, int(self.pos[s]), self.pruned[s])
            req.generated.append(int(torch.argmax(logits[0, 0])))
            self.pos[s] += 1
            if len(req.generated) >= req.max_new or self.pos[s] >= self.max_len - 1:
                req.done = True
                self.active[s] = None
                self.cache[s] = self.pruned[s] = None
        return True

    def run(self) -> Dict[int, List[int]]:
        """Serve every queued request: ``{rid: generated tokens}``."""
        all_reqs = list(self.queue)
        while self.step():
            pass
        return {r.rid: r.generated for r in all_reqs}
