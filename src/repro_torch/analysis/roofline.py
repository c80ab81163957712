"""Three-term roofline for an NVIDIA H100 SXM5 card (port of
``repro/analysis/roofline.py``, whose rates are a TPU's).

    compute term    = FLOPs per card      / peak FLOP/s for the dtype
    memory term     = HBM bytes per card  / HBM bandwidth
    collective term = wire bytes per card / link bandwidth, NVLink for a
                      group inside a node, the network for one that
                      crosses nodes

The rates are the H100 SXM5 datasheet's (NVIDIA; dense, per card, at the
700 W limit): they are what ``chip_smoke.py``'s kernel bounds divide by
too.  A card set below 700 W runs slower than these under load.
FLOPs and HBM bytes come from ``analysis.analytic`` (the port has no
compiled artifact to read them from); wire bytes from the collectives a
step records (``analysis.collectives``).

MODEL_FLOPS (the "useful FLOPs" yardstick) = 6*N*D for dense training,
2*N*D for inference forward passes (N = params, D = tokens processed),
with N replaced by active params for MoE.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

#: dense peak FLOP/s per card by dtype (datasheet): bf16 / fp16 on the
#: tensor cores, fp32 outside them
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
#: HBM3 bandwidth per card, bytes/s (datasheet)
HBM_BW = 3.35e12
#: HBM3 capacity per card, bytes (datasheet: 80 GB)
HBM_CAPACITY = 80e9
#: NVLink 4 bandwidth per card and direction, bytes/s (datasheet: 900 GB/s
#: both ways), between the cards of one node
NVLINK_BW = 450e9
#: cards per node (HGX / DGX H100)
NODE_SIZE = 8
#: bandwidth per card between nodes, bytes/s: one 400 Gb/s NDR port a card
NETWORK_BW = 50e9


def peak_flops(dtype: str = "bfloat16") -> float:
    """Dense peak FLOP/s of one card for a model dtype (``cfg.dtype``)."""
    return PEAK_FLOPS[str(dtype)]


@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_per_chip: float = 0.0
    hlo_flops_per_chip: float = 0.0
    peak_flops: float = PEAK_FLOPS["bfloat16"]

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> Optional[float]:
        if self.hlo_flops_per_chip:
            return self.model_flops_per_chip / self.hlo_flops_per_chip
        return None

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Fraction of the compute roofline achievable if the dominant
        term were the only cost: MODEL_FLOPS-time / bound-time."""
        if self.bound_s <= 0:
            return None
        return (self.model_flops_per_chip / self.peak_flops) / self.bound_s

    def as_dict(self) -> Dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "model_flops_per_chip": self.model_flops_per_chip,
            "hlo_flops_per_chip": self.hlo_flops_per_chip,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "peak_flops": self.peak_flops,
        }


def from_costs(
    flops_per_chip: float,
    hbm_bytes_per_chip: float,
    collective_bytes_per_chip: float,
    model_flops_total: float = 0.0,
    chips: int = 1,
    *,
    network_bytes_per_chip: float = 0.0,
    dtype: str = "bfloat16",
) -> Roofline:
    """The three terms on the card's rates.  ``network_bytes_per_chip`` is
    the share of the wire bytes whose groups cross a node (the rest go
    over NVLink); ``dtype`` picks the peak."""
    peak = peak_flops(dtype)
    nvlink = collective_bytes_per_chip - network_bytes_per_chip
    return Roofline(
        compute_s=flops_per_chip / peak,
        memory_s=hbm_bytes_per_chip / HBM_BW,
        collective_s=nvlink / NVLINK_BW + network_bytes_per_chip / NETWORK_BW,
        model_flops_per_chip=model_flops_total / max(chips, 1),
        hlo_flops_per_chip=flops_per_chip,
        peak_flops=peak,
    )


# ---------------------------------------------------------------------------
# MODEL_FLOPS accounting
# ---------------------------------------------------------------------------

def count_params(cfg) -> Dict[str, int]:
    """Exact total params from the spec tree + analytic active params."""
    from repro_torch.models import decoder, param as param_lib

    total = param_lib.param_count(decoder.model_specs(cfg))
    active = total
    if cfg.num_experts:
        glu = 3 if cfg.glu else 2
        per_expert = glu * cfg.d_model * cfg.moe_d_ff
        n_moe_layers = cfg.num_layers - cfg.num_dense_layers
        inactive = (cfg.num_experts - cfg.experts_per_token) * per_expert * n_moe_layers
        active = total - inactive
    return {"total": int(total), "active": int(active)}


def model_flops(cfg, shape) -> float:
    """6*N*D (train) / 2*N*D (inference), N = active params, D = tokens.

    For decode shapes D = global_batch (one new token per sequence); the
    attention read over the KV cache is accounted in the memory term, not
    here (classical 6ND ignores attention; we report it as the yardstick
    the field uses)."""
    n = count_params(cfg)["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence
