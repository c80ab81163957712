"""Multi-pod dry-run (port of ``repro/launch/dryrun.py``): build every
(architecture x input shape x mesh) cell on the production meshes, step
one rank's program once, and read a three-term H100 roofline from it.

The reference compiles the whole mesh's SPMD program for 512 XLA host
devices.  The port runs one process per rank, so it steps **one rank's
program** (``--rank``, default 0) on the ``meta`` device (shapes, no
memory, no arithmetic: the kernel wrappers take their plain versions)
over a ``launch.mesh.dry_train_mesh``, whose groups record every
collective instead of running it.  A train cell's step includes all its
microbatches and the optimizer update.

The roofline's FLOPs and HBM bytes are ``analysis.analytic``'s, its
wire bytes the collectives the step recorded (``analysis.collectives``),
all on the card's datasheet rates (``analysis.roofline``): the lower
bound a measured step is divided by.  The same step is counted
(``collectives.count_ops``, the counterpart of the reference's
``cost_analysis()`` and ``memory_analysis()``): ``counted`` holds its
FLOPs, elementwise FLOPs and eager operand bytes (traffic, not a bound),
``flops_counted_over_analytic`` sets its FLOPs against the analytic
ones, and ``memory`` its argument, output, alias and temp bytes and the
peak (arguments + temp) against the card's HBM (``fits_card``).  XLA's
generated code size has no counterpart.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --pods 2
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all        # every runnable cell
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch deepseek-v3-671b --moe-group-limit 1
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --seq-parallel
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b mamba2-1.3b --shape train_4k prefill_32k --seq-parallel
Artifacts: JSON per cell under --out (default artifacts/dryrun_torch/).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Optional

from repro_torch.analysis import analytic, collectives as coll_lib
from repro_torch.analysis import roofline as rl
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeConfig, cell_supported
from repro_torch.distributed import sharding as shlib
from repro_torch.launch import cells as cells_lib
from repro_torch.launch.mesh import dry_train_mesh
from repro_torch.launch.policies import CellPolicy, policy_for


#: the record's two sources: the roofline's FLOPs and bytes, and the count
COST_SOURCE = "roofline: analytic; counted: aten dispatch of one rank's step"


def production_shape(pods: int):
    """``(shape, axes)`` of the reference's production mesh."""
    return ((2, 16, 16), ("pod", "data", "model")) if pods == 2 else \
        ((16, 16), ("data", "model"))


def cell_config(arch: str, *, moe_group_limit: int = 0, kv_int8: bool = False,
                pad_heads: bool = False):
    cfg = get_config(arch)
    if moe_group_limit:
        cfg = cfg.replace(moe_group_limit=moe_group_limit)
    if kv_int8:
        cfg = cfg.replace(kv_cache_int8=True)
    if pad_heads:
        from repro_torch.distributed.transforms import pad_attention_heads

        cfg = pad_attention_heads(cfg, tp=16).replace(name=arch)
    return cfg


def step_cell(cell: cells_lib.Cell, args=None):
    """Step ``cell.fn`` once (on ``args``, default the cell's ``meta``
    ones) and return ``(count, records, seconds)``: ``count_ops`` of the
    step, the collectives it issued and its host wall (the count's
    included)."""
    shlib.reset_records()
    t0 = time.perf_counter()
    count = coll_lib.count_ops(cell.fn, *(cell.args if args is None else args))
    dt = time.perf_counter() - t0
    records = list(shlib.RECORDS)
    shlib.reset_records()
    return count, records, dt


def run_cell(arch: str, shape_name: str, *, pods: int = 1, use_griffin: bool = True,
             seq_parallel: bool = False, optimizer: Optional[str] = None,
             q_chunk: Optional[int] = None, tag: str = "",
             moe_group_limit: int = 0, kv_int8: bool = False,
             pad_heads: bool = False, griffin_sparsity: float = 0.5,
             fsdp: Optional[bool] = None, rank: int = 0,
             shape: Optional[ShapeConfig] = None,
             mesh_shape=None) -> dict:
    """One cell's record.  ``shape`` / ``mesh_shape`` override the named
    shape and the production mesh (a cut cell, or the card's (2, 2))."""
    cfg = cell_config(arch, moe_group_limit=moe_group_limit, kv_int8=kv_int8,
                      pad_heads=pad_heads)
    shape = shape or SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    rec = {
        "arch": arch, "shape": shape_name, "pods": pods, "rank": rank,
        "griffin": bool(use_griffin and cfg.griffin and cfg.has_ffn
                        and shape.kind != "train"),
        "seq_parallel": seq_parallel, "tag": tag,
    }
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec

    dims, axes = mesh_shape or production_shape(pods)
    chips = 1
    for d in dims:
        chips *= d
    pol = policy_for(cfg, shape, seq_parallel=seq_parallel, optimizer=optimizer,
                     use_griffin=use_griffin, griffin_sparsity=griffin_sparsity,
                     fsdp=fsdp)
    if q_chunk:
        pol = CellPolicy(rules=pol.rules, optimizer=pol.optimizer,
                         accum_steps=pol.accum_steps, griffin=pol.griffin,
                         q_chunk=q_chunk)
    rec["optimizer"] = pol.optimizer if shape.kind == "train" else None
    rec["mesh"] = {"shape": list(dims), "axes": list(axes)}

    try:
        mesh = dry_train_mesh(dims, axes, rank)
        cell = cells_lib.build_cell(cfg, shape, mesh, pol)
        count, records, step_s = step_cell(cell)
    except Exception as e:  # a failing cell is a bug or a named refusal
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
        return rec

    rec["accum_steps"] = cell.accum_steps if shape.kind == "train" else None
    sp = griffin_sparsity if rec["griffin"] and shape.kind == "decode" else 0.0
    cost = analytic.cell_cost(cfg, shape, griffin_sparsity=sp)
    coll = coll_lib.collective_bytes(records, node_size=rl.NODE_SIZE)
    mf = rl.model_flops(cfg, shape)
    roof = rl.from_costs(cost.flops / chips, cost.hbm_bytes / chips,
                         coll["bytes_total"], model_flops_total=mf, chips=chips,
                         network_bytes_per_chip=coll["bytes_network"],
                         dtype=cfg.dtype)
    c = count.cost
    mem = dict(count.memory, input_bytes_per_device=cells_lib.input_bytes(cell))
    mem["fits_card"] = mem["peak_bytes"] <= rl.HBM_CAPACITY
    rec.update(
        status="ok",
        chips=chips,
        step_s=round(step_s, 3),
        cost_source=COST_SOURCE,
        flops_per_chip=cost.flops / chips,
        hbm_bytes_per_chip=cost.hbm_bytes / chips,
        counted={"flops_per_chip": c["flops"],
                 "elementwise_flops_per_chip": c["elementwise_flops"],
                 "bytes_accessed_per_chip": c["bytes_accessed"],
                 "by_op": c["by_op"], "plain_versions": c["plain_versions"]},
        flops_counted_over_analytic=c["flops"] / (cost.flops / chips),
        collectives=coll,
        collective_summary=coll_lib.summary(records),
        memory=mem,
        model_flops_total=mf,
        roofline=roof.as_dict(),
        ops=count.ops,
        notes=cell.notes,
    )
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", choices=ASSIGNED_ARCHS + ["tinylm", "lm100m"])
    ap.add_argument("--shape", nargs="+", choices=list(SHAPES))
    ap.add_argument("--pods", type=int, default=1, choices=[1, 2])
    ap.add_argument("--all", action="store_true",
                    help="run every runnable (arch x shape) cell for this pod "
                    "count (--arch alone: every shape of that arch)")
    ap.add_argument("--no-griffin", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--q-chunk", type=int, default=None)
    ap.add_argument("--moe-group-limit", type=int, default=0)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--pad-heads", action="store_true")
    ap.add_argument("--griffin-sparsity", type=float, default=0.5)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank whose program is stepped")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells stepped at once, one process each")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        todo = [(a, s) for a in ASSIGNED_ARCHS for s in SHAPES]
        # the slowest steps first (train cells, the largest model's
        # first), so that parallel jobs end together
        todo.sort(key=lambda t: (t[1] != "train_4k", t[0] != "deepseek-v3-671b"))
    elif args.arch:  # the shapes given, or every shape of each arch
        todo = [(a, s) for a in args.arch for s in (args.shape or SHAPES)]
    else:
        ap.error("--arch [--shape] or --all required")

    kw = dict(pods=args.pods, use_griffin=not args.no_griffin,
              seq_parallel=args.seq_parallel, optimizer=args.optimizer,
              q_chunk=args.q_chunk, tag=args.tag,
              moe_group_limit=args.moe_group_limit, kv_int8=args.kv_int8,
              pad_heads=args.pad_heads, griffin_sparsity=args.griffin_sparsity,
              fsdp=False if args.no_fsdp else None, rank=args.rank)
    if args.jobs > 1:
        import multiprocessing

        with multiprocessing.get_context("spawn").Pool(args.jobs) as pool:
            recs = pool.imap(_run_one, [(a, s, kw) for a, s in todo])
            return _report(todo, recs, args, out_dir)
    return _report(todo, (run_cell(a, s, **kw) for a, s in todo), args, out_dir)


def _run_one(item) -> dict:
    import warnings

    arch, shape_name, kw = item
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return run_cell(arch, shape_name, **kw)


def _report(todo, recs, args, out_dir: Path) -> int:
    """Write each record, print one line a cell, name the failed cells."""
    failed = []
    for (arch, shape_name), rec in zip(todo, recs):
        suffix = ("_" + args.tag) if args.tag else ""
        name = f"{arch}_{shape_name}_p{args.pods}" \
               + ("_nogriffin" if args.no_griffin else "") \
               + ("_sp" if args.seq_parallel else "") + suffix
        (out_dir / f"{name}.json").write_text(json.dumps(rec, indent=1))
        status = rec["status"]
        if status == "ok":
            r = rec["roofline"]
            extra = (f" bytes/rank={rec['memory']['input_bytes_per_device']:.4e}"
                     f" peak={rec['memory']['peak_bytes']:.4e}"
                     f" flops_counted/analytic="
                     f"{rec['flops_counted_over_analytic']:.4f}"
                     f" dominant={r['dominant']} bound={r['bound_s']:.4e}s"
                     f" coll={rec['collectives']['bytes_total']:.4e}B"
                     f" step={rec['step_s']}s")
        elif status == "error":
            failed.append(f"{arch} x {shape_name}")
            extra = " " + rec["error"][:300]
        else:
            extra = " " + rec["reason"]
        print(f"[{status:7s}] {arch} x {shape_name} (pods={args.pods}){extra}",
              flush=True)
    if failed:
        print(f"{len(failed)} cell(s) failed: " + "; ".join(failed), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
