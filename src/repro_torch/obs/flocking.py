"""Live flocking telemetry: does the expert set a request decodes with
still match its evolving activations?  (Port of ``repro/obs/flocking.py``.)

GRIFFIN selects each request's top-``k_ff`` FF experts once, from the
prefill statistic (eq. 6), and decodes with that fixed compacted set.
The paper's flocking claim is that this is safe because decode tokens
keep activating the same neurons.  This module measures that claim
*live*, per request and per layer:

* **Jaccard overlap** between the prefill-selected expert set and the
  top-``k_ff`` of the running decode-time statistic (eq. 6 accumulated
  over sampled decode tokens, via the dense probe step) — the paper's
  Figure-2 measure, applied prefill-vs-decode instead of
  sequence-vs-sequence.
* **Angular distance** ``arccos(cos_sim)/pi`` between the prefill
  statistic vector and the running decode statistic vector — the
  selection-free version of the same question (sensitive to drift the
  top-k set hides).

Inputs arrive from ``PagedServer``: ``on_select`` at compaction time
(the selection and the statistic it was made from), ``on_probe`` every
N ticks with the dense stats of one decode step (the server restores
every page the probe wrote, so serving state and outputs are
untouched).  The port's trees are keyed by layer index (``{li: ...}``);
each layer is named as the reference names it (``seg0/pos0[3]``, from
``decoder.layer_paths``), so a gauge such as
``flocking_jaccard{layer="seg0/pos0[3]"}`` is the same series from
either server.  Per-layer aggregates land on bounded-cardinality
registry gauges (labelled by layer name, never by request id);
per-request values are returned to the caller for trace emission and
kept in ``last`` for end-of-drain reporting.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.griffin import GriffinConfig
from repro_torch.models import decoder
from repro_torch.obs.registry import Registry

__all__ = ["FlockingMonitor", "layer_names", "flatten_stats",
           "flatten_selection"]


def layer_names(cfg) -> Dict[int, str]:
    """``{li: name}`` in the reference's flattened naming: a layer of a
    scan segment is ``seg{i}/pos{j}[instance]``, an unrolled one
    ``seg{i}/layer{j}``."""
    out = {}
    for li, (path, inst, _) in enumerate(decoder.layer_paths(cfg)):
        out[li] = f"{path}[{inst}]" if "/pos" in path else path
    return out


def _order(names: Dict[int, str]) -> List[int]:
    """Layer indices in the order the reference walks its tree: sorted
    segment and position keys, then scan instances in order."""
    def key(li: int) -> Tuple[str, str, int]:
        seg, rest = names[li].split("/")
        name, _, inst = rest.partition("[")
        return seg, name, int(inst.rstrip("]") or 0)
    return sorted(names, key=key)


def _host(ts: List[torch.Tensor]) -> List[np.ndarray]:
    """Tensors -> fp32 numpy arrays in one device-to-host copy."""
    if not ts:
        return []
    flat = torch.cat([t.detach().float().reshape(-1) for t in ts]).cpu().numpy()
    out, i = [], 0
    for t in ts:
        out.append(flat[i : i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


def flatten_stats(stats_tree: Dict[int, Any],
                  names: Dict[int, str]) -> Dict[str, np.ndarray]:
    """``{li: {"s_sq": [B, F], ...}}`` -> ``{layer_name: s_sq [B, F]}``
    in the reference's order.  Zero-width placeholders (F == 0) are
    dropped."""
    lis = [li for li in _order(names)
           if li in stats_tree and stats_tree[li]["s_sq"].shape[-1] > 0]
    arrs = _host([stats_tree[li]["s_sq"] for li in lis])
    return {names[li]: a for li, a in zip(lis, arrs)}


def flatten_selection(sel_tree: Dict[int, torch.Tensor],
                      names: Dict[int, str]) -> Dict[str, np.ndarray]:
    """``{li: idx [k]}`` -> ``{layer_name: idx [k]}`` (same naming as
    ``flatten_stats``)."""
    return {names[li]: sel_tree[li].detach().cpu().numpy()
            for li in _order(names)
            if li in sel_tree and sel_tree[li].numel() > 0}


def _topk_set(s: np.ndarray, k: int) -> np.ndarray:
    k = min(k, s.shape[-1])
    return np.argpartition(-s, k - 1)[:k] if k < s.shape[-1] \
        else np.arange(s.shape[-1])


def _angular(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 1.0 if na != nb else 0.0
    cos = float(np.dot(a, b) / (na * nb))
    return float(np.arccos(np.clip(cos, -1.0, 1.0)) / np.pi)


class FlockingMonitor:
    """Per-request, per-layer expert-selection stability gauges."""

    def __init__(self, gcfg: GriffinConfig, registry: Registry, cfg):
        self.gcfg = gcfg
        self.registry = registry
        self.names = layer_names(cfg)
        # per live request: selection, prefill stat, running decode s_sq
        self._sel: Dict[int, Dict[str, set]] = {}
        self._prefill_s: Dict[int, Dict[str, np.ndarray]] = {}
        self._decode_s_sq: Dict[int, Dict[str, np.ndarray]] = {}
        self._probe_count: Dict[int, int] = {}
        # final per-request aggregate, kept after finish (same growth
        # class as ServingMetrics.requests)
        self.last: Dict[int, Dict[str, float]] = {}
        self.probes = registry.counter(
            "flocking_probes", help="Dense probe steps executed")
        self.probed_requests = registry.counter(
            "flocking_probed_requests",
            help="Per-request probe observations (requests x probes)")

    # -- lifecycle ---------------------------------------------------------
    def live_rids(self) -> List[int]:
        """Requests with per-request working state still held."""
        return list(self._sel)

    def on_select(self, rid: int, sel_tree: Dict[int, torch.Tensor],
                  stats_tree: Dict[int, Any]) -> None:
        """Record the expert selection a request was compacted with and
        the prefill statistic it came from."""
        sel = flatten_selection(sel_tree, self.names)
        self._sel[rid] = {name: set(idx.tolist()) for name, idx in sel.items()}
        pre: Dict[str, np.ndarray] = {}
        for name, s_sq in flatten_stats(stats_tree, self.names).items():
            # prefill stats are per-request: [1, F] -> eq. 6 vector [F]
            pre[name] = np.sqrt(np.maximum(s_sq.sum(axis=0), 0.0))
        self._prefill_s[rid] = pre
        self._decode_s_sq.setdefault(rid, {})
        self._probe_count.setdefault(rid, 0)

    def on_probe(self, rows: Dict[int, int],
                 stats_tree: Dict[int, Any]) -> Dict[int, Dict[str, float]]:
        """Fold one dense probe step into the running decode statistics.

        ``rows`` maps rid -> row index in the probe batch; ``stats_tree``
        is the (pruned) stats tree of one ``decode_step_paged`` with
        ``collect_stats`` — ``s_sq`` rows of non-probed slots are zero
        (masked) and simply ignored.  Returns per-rid mean Jaccard and
        angular distance for trace emission.
        """
        layers = flatten_stats(stats_tree, self.names)
        if not layers:
            return {}
        self.probes.inc()
        results: Dict[int, Dict[str, float]] = {}
        per_layer: Dict[str, List[Tuple[float, float]]] = {}
        for rid, row in rows.items():
            sel = self._sel.get(rid)
            if sel is None:
                continue
            acc = self._decode_s_sq.setdefault(rid, {})
            self._probe_count[rid] = self._probe_count.get(rid, 0) + 1
            self.probed_requests.inc()
            jacs, angs = [], []
            for name, s_sq in layers.items():
                if name not in sel:
                    continue
                vec = s_sq[row]
                run = acc.get(name)
                acc[name] = vec if run is None else run + vec
                s_dec = np.sqrt(np.maximum(acc[name], 0.0))
                k = self.gcfg.k_of(s_dec.shape[-1])
                top = set(_topk_set(s_dec, k).tolist())
                jac = len(top & sel[name]) / max(1, len(top | sel[name]))
                pre = self._prefill_s.get(rid, {}).get(name)
                ang = _angular(pre, s_dec) if pre is not None else 0.0
                jacs.append(jac)
                angs.append(ang)
                per_layer.setdefault(name, []).append((jac, ang))
            if jacs:
                res = {"jaccard": float(np.mean(jacs)),
                       "angular": float(np.mean(angs)),
                       "probes": float(self._probe_count[rid])}
                results[rid] = res
                self.last[rid] = res
        for name, vals in per_layer.items():
            js, angs = zip(*vals)
            self.registry.gauge(
                "flocking_jaccard", labels={"layer": name},
                help="Jaccard(prefill selection, running decode top-k)",
            ).set(float(np.mean(js)))
            self.registry.gauge(
                "flocking_angular", labels={"layer": name},
                help="Angular distance prefill vs running decode statistic",
            ).set(float(np.mean(angs)))
        return results

    def on_finish(self, rid: int) -> Optional[Dict[str, float]]:
        """Drop per-request working state; returns the final aggregate
        (also kept in ``last``)."""
        self._sel.pop(rid, None)
        self._prefill_s.pop(rid, None)
        self._decode_s_sq.pop(rid, None)
        self._probe_count.pop(rid, None)
        return self.last.get(rid)
