"""Generation engine: prefill -> GRIFFIN select/compact -> pruned decode
(port of ``repro/serving/engine.py::GenerationEngine``).

``GenerationEngine.generate`` is synchronized batch generation: all
sequences share a position counter and GRIFFIN's selection is
aggregated over the batch by eq. 7 — exactly the paper's batched
setting (Table 4).  The prompt runs through ``decoder.forward`` with the
full FF blocks and the statistics (``expert_stat`` on the card), the
prefill K/V fill a contiguous decode cache, and every later token runs
``decoder.decode_step`` on the compacted FF.  The production serving
path is ``serving/server.py::PagedServer``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import griffin as griffin_lib
from repro_torch.kernels import backend as backend_lib
from repro_torch.models import decoder
from repro_torch.serving.sampling import SamplingConfig, sample


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
        self.device = backend_lib.resolve_device(device)
        table = params["embed"]["table"]
        if table.device.type != self.device.type:
            raise ValueError(
                f"params live on {table.device}, the engine on {self.device}")
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
