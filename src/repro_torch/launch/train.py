"""Training launcher of the port, on the card by default (port of
``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinylm \\
      --device cpu --steps 20

Runs the fault-tolerant loop (``training/loop.py``: checkpoints in the
reference's layout, auto-resume, preemption, straggler monitoring) over
``SyntheticCorpus`` batches.  Flags, defaults and the config rule are
the reference's (``--mesh host``, the default, trains the reduced
same-family config), except:

* ``--device`` picks the device (default: the card);
* ``--mesh pod`` / ``2pod`` is refused: tensor parallelism is not ported.

The init is drawn on the CPU from seed 0 and moved to the device, so the
card and the CPU train the same weights (they are not the reference's
``PRNGKey(0)`` draw).  ``main(argv)`` returns the per-step losses.
"""
from __future__ import annotations

import argparse
from typing import List, Optional, Sequence

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
from repro_torch.kernels import backend
from repro_torch.runtime.preemption import PreemptionGuard
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.loop import train
from repro_torch.training.schedule import warmup_cosine
from repro_torch.training.train_step import init_train_state

_NO_MESH = ("--mesh pod/2pod: tensor parallelism is not ported to the "
            "PyTorch trainer (ROADMAP Queue A item 4)")


def default_optimizer(cfg) -> str:
    """The reference's choice (``repro/launch/policies.py:76-77``):
    8-bit Adam for DeepSeek-V3 at full size, AdamW otherwise."""
    return "adam8bit" if cfg.name == "deepseek-v3-671b" else "adamw"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinylm",
                    choices=ASSIGNED_ARCHS + ["tinylm", "lm100m"])
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "2pod"],
                    help="host: one device (pod / 2pod: not ported)")
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
    return ap


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mesh != "host":
        ap.error(_NO_MESH)

    cfg = get_config(args.arch, smoke=args.smoke or args.mesh == "host")
    device = backend.resolve_device(args.device)
    print(f"[device] {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                  if device.type == "cuda" else ""))
    sched = warmup_cosine(args.lr, max(args.steps // 10, 5), args.steps)
    optimizer = opt_lib.get_optimizer(args.optimizer or default_optimizer(cfg),
                                      sched)

    corpus = SyntheticCorpus(vocab=cfg.vocab_size, seed=0)
    loader = ShardedLoader(corpus, batch=args.batch, seq_len=args.seq, seed=1)
    mgr = CheckpointManager(args.ckpt_dir, interval=args.ckpt_every) \
        if args.ckpt_dir else None
    state = None
    if mgr is None or mgr.latest_step() is None:
        state = _to(init_train_state(cfg, optimizer, 0, "cpu"), device)
    guard = PreemptionGuard()
    try:
        res = train(cfg, optimizer, loader, args.steps, ckpt=mgr, guard=guard,
                    log_every=10, accum_steps=args.accum, state=state,
                    device=device)
    finally:
        guard.uninstall()
        loader.close()
    return res.losses


if __name__ == "__main__":
    main()
