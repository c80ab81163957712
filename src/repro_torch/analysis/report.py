"""The params, dry-run and roofline tables from the port's dry-run
artifacts and the analytic cost model (port of
``repro/analysis/report.py``), on the H100's datasheet rates
(``analysis.roofline``): analytic terms and what the dry-run counted on
``meta`` (its peak, its FLOPs in "MODEL_FLOPS/counted", the reference's
"MODEL_FLOPS/HLO"), not measurements.

  PYTHONPATH=src python -m repro_torch.analysis.report [--art artifacts/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from repro_torch.analysis.roofline import count_params
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, cell_supported

#: cards of one production pod (16 x 16)
POD_CARDS = 256

LEVERS = {
    "compute": "reduce non-model FLOPs (causal chunking, capacity factor)",
    "memory": "cut bytes/step: GRIFFIN pruning, cache layout, quantized cache",
    "collective": "reshard to kill gathers (EP a2a, weight-stationary prefill)",
}


def _fmt(x, unit="", scale=1.0, digits=3):
    if x is None:
        return "—"
    return f"{x * scale:.{digits}g}{unit}"


def load(art_dir: Path, arch: str, shape: str, pods: int, tag: str = ""):
    name = f"{arch}_{shape}_p{pods}" + (f"_{tag}" if tag else "")
    f = art_dir / f"{name}.json"
    if not f.exists():
        return None
    return json.loads(f.read_text())


def dryrun_table(art_dir: Path) -> str:
    rows = [
        "| arch | shape | pods=1 | pods=2 | bytes/rank (inputs) "
        "| peak (args + temp) | step on meta (s) |",
        "|---|---|---|---|---|---|---|",
    ]
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, reason = cell_supported(cfg, shape)
            if not ok:
                rows.append(f"| {arch} | {sname} | skip | skip | — | — | {reason} |")
                continue
            r1 = load(art_dir, arch, sname, 1)
            r2 = load(art_dir, arch, sname, 2)
            s1 = (r1 or {}).get("status", "—")
            s2 = (r2 or {}).get("status", "—")
            mem = (r1 or {}).get("memory", {}) or {}
            rows.append(f"| {arch} | {sname} | {s1} | {s2} | "
                        f"{_fmt(mem.get('input_bytes_per_device'), ' GB', 1e-9)} | "
                        f"{_fmt(mem.get('peak_bytes'), ' GB', 1e-9)} | "
                        f"{_fmt((r1 or {}).get('step_s'))} |")
    return "\n".join(rows)


def roofline_table(art_dir: Path) -> str:
    """Single-pod roofline, as each record's ``roofline`` holds it: the
    analytic FLOPs and bytes on the card's rates, and the collectives the
    dry-run recorded (NVLink inside a node, the network across nodes);
    beside the model's FLOPs over the analytic ones, over the FLOPs the
    dry-run counted."""
    rows = [
        "| arch | shape | compute (s) | memory (s) | collective (s) | dominant "
        "| MODEL_FLOPS/analytic | MODEL_FLOPS/counted | roofline frac "
        "| one-line lever |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for arch in ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            if not cell_supported(cfg, shape)[0]:
                continue
            rec = load(art_dir, arch, sname, 1)
            if rec is None or rec.get("status") != "ok":
                rows.append(f"| {arch} | {sname} | (no artifact) |" + " |" * 7)
                continue
            r = rec["roofline"]
            dom = r["dominant"]
            terms = " | ".join(_fmt(r[k], digits=4) for k in (
                "compute_s", "memory_s", "collective_s"))
            counted = rec.get("counted", {}).get("flops_per_chip")
            rows.append(
                f"| {arch} | {sname} | {terms} | {dom} | "
                f"{_fmt(r['useful_ratio'])} | "
                f"{_fmt(r['model_flops_per_chip'] / counted if counted else None)} | "
                f"{_fmt(r['roofline_fraction'])} | {LEVERS[dom]} |"
            )
    return "\n".join(rows)


def params_table() -> str:
    rows = ["| arch | total params | active/token |", "|---|---|---|"]
    for arch in ASSIGNED_ARCHS:
        n = count_params(get_config(arch))
        rows.append(f"| {arch} | {n['total']/1e9:.2f}B | {n['active']/1e9:.2f}B |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--art", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)
    art = Path(args.art)
    print("## Params\n")
    print(params_table())
    print("\n## Dry-run\n")
    print(dryrun_table(art))
    print(f"\n## Roofline (one pod of {POD_CARDS} H100s, analytic FLOPs/bytes on "
          "the datasheet rates + the collectives the dry-run recorded)\n")
    print(roofline_table(art))


if __name__ == "__main__":
    main()
