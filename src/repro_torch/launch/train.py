"""Training launcher of the port, on the card by default (port of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinylm \\
      --device cpu --steps 20

Builds the mesh, applies the per-arch sharding policy
(``launch/policies.py``: the rules and the optimizer), shards the train
state, and runs the fault-tolerant loop (``training/loop.py``:
checkpoints in the reference's layout, auto-resume, preemption,
straggler monitoring) over ``SyntheticCorpus`` batches.  Flags, defaults
and the config rule are the reference's (``--mesh host``, the default,
trains the reduced same-family config over the visible cards as a
``(1, n)`` mesh, and no mesh for one card; ``--mesh pod`` / ``2pod``
take the reference's pod shapes with one NCCL rank per card and fail
naming the card count where there are fewer), plus:

* ``--device`` picks the device (default: the card);
* ``--mesh-shape DxM`` runs a ``(data, model)`` mesh of D x M ranks
  spawned on this host (``launch.mesh.run_ranks``; rank 0 prints),
  ``--tp-backend`` its backend: ``nccl`` (the default on the card, one
  card per rank) or ``gloo`` (the only one on ``--device cpu``; on the
  card it lets the ranks share one card).

The init is drawn on the CPU from seed 0 and moved to the device, so the
card and the CPU train the same weights (they are not the reference's
``PRNGKey(0)`` draw).  ``main(argv)`` returns the per-step losses.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
from repro_torch.distributed.tp import TrainTP
from repro_torch.kernels import backend
from repro_torch.launch.mesh import make_production_mesh, run_ranks
from repro_torch.launch.policies import policy_for
from repro_torch.runtime.preemption import PreemptionGuard
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.loop import train
from repro_torch.training.schedule import warmup_cosine
from repro_torch.training.train_step import init_train_state


def default_optimizer(cfg) -> str:
    """The reference's choice (``policy_for``): 8-bit Adam for
    DeepSeek-V3 at full size, AdamW otherwise."""
    return policy_for(cfg, ShapeConfig("cli", 128, 8, "train")).optimizer


def _mesh_shape(spec: str) -> Tuple[int, int]:
    try:
        d, m = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh-shape wants DxM (e.g. 2x2), got {spec!r}") from None
    if d < 1 or m < 1:
        raise argparse.ArgumentTypeError(f"--mesh-shape {spec!r}: sizes >= 1")
    return d, m


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinylm",
                    choices=ASSIGNED_ARCHS + ["tinylm", "lm100m"])
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "2pod"],
                    help="host: local devices; pod: 16x16; 2pod: 2x16x16")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default=None)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (plain PyTorch versions)")
    ap.add_argument("--mesh-shape", type=_mesh_shape, default=None,
                    help="DxM: a (data, model) mesh of D*M ranks spawned on "
                         "this host")
    ap.add_argument("--tp-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend of --mesh-shape: nccl "
                         "(the default on the card, one card per rank) or "
                         "gloo (the only one on --device cpu; on the card "
                         "it lets the ranks share one card)")
    return ap


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    device = backend.resolve_device(args.device)
    shape = None
    if args.mesh != "host":
        try:
            mesh = make_production_mesh(multi_pod=args.mesh == "2pod")
        except RuntimeError as e:
            ap.error(f"--mesh {args.mesh} trains with data and tensor "
                     f"parallelism over the reference's pod shape: {e}")
        return _run(args, mesh)
    if args.mesh_shape is not None:
        shape = args.mesh_shape
    elif device.type == "cuda" and torch.cuda.device_count() > 1:
        shape = (1, torch.cuda.device_count())  # the reference's host rule
    if shape is None:
        return _run(args, None)
    tp_backend = args.tp_backend or ("gloo" if device.type == "cpu" else "nccl")
    if device.type == "cpu" and tp_backend != "gloo":
        ap.error("--mesh-shape on --device cpu runs on --tp-backend gloo only")
    n = shape[0] * shape[1]
    print(f"[mesh] data={shape[0]} model={shape[1]}: {n} ranks on "
          f"{tp_backend} ({device.type})")
    results, _ = run_ranks(_train_rank, n, backend=tp_backend,
                           device=args.device, shape=shape,
                           axes=("data", "model"), args=(argv,),
                           timeout_s=3600)
    return results[0]


def _train_rank(mesh, argv: List[str]) -> List[float]:
    """One rank of ``--mesh-shape`` (spawned by ``run_ranks``)."""
    args = build_parser().parse_args(argv)
    return _run(args, mesh)


def _run(args, mesh) -> List[float]:
    cfg = get_config(args.arch, smoke=args.smoke or args.mesh == "host")
    pol = policy_for(cfg, ShapeConfig("cli", args.seq, args.batch, "train"),
                     optimizer=args.optimizer)
    lead = mesh is None or mesh.rank == 0
    device = mesh.device if mesh is not None else backend.resolve_device(args.device)
    if lead:
        print(f"[device] {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                      if device.type == "cuda" else ""))
    sched = warmup_cosine(args.lr, max(args.steps // 10, 5), args.steps)
    optimizer = opt_lib.get_optimizer(pol.optimizer, sched)
    rules = pol.rules if mesh is not None else None

    corpus = SyntheticCorpus(vocab=cfg.vocab_size, seed=0)
    loader = ShardedLoader(corpus, batch=args.batch, seq_len=args.seq, seed=1)
    mgr = CheckpointManager(args.ckpt_dir, interval=args.ckpt_every) \
        if args.ckpt_dir else None
    state = None
    if mgr is None or mgr.latest_step() is None:
        # drawn on the CPU, so the card's run starts where the CPU's does;
        # on a mesh each rank draws only its blocks
        state = _to(init_train_state(cfg, optimizer, 0, "cpu") if mesh is None
                    else TrainTP(cfg, mesh, rules).init_train_state(
                        optimizer, 0, "cpu"), device)
    guard = PreemptionGuard()
    try:
        res = train(cfg, optimizer, loader, args.steps, ckpt=mgr, guard=guard,
                    log_every=10, accum_steps=args.accum, state=state,
                    device=device, mesh=mesh, rules=rules)
    finally:
        guard.uninstall()
        loader.close()
    return res.losses


if __name__ == "__main__":
    main()
