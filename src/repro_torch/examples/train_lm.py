"""End-to-end training driver: data pipeline -> train step ->
checkpoints -> auto-resume, with preemption handling (port of
``examples/train_lm.py``).

  PYTHONPATH=src python -m repro_torch.examples.train_lm --model tinylm --steps 400
  PYTHONPATH=src python -m repro_torch.examples.train_lm --model lm100m \\
      --steps 300 --batch 8 --seq 512        # the ~100M-parameter config

Checkpoints (the reference's layout) go under
``ARTIFACTS/models_torch/<name>`` unless ``--ckpt-dir``; a rerun resumes
from the last one.  Runs on the card unless ``--device cpu``.
"""
import argparse
from typing import Optional, Sequence

from repro_torch import bridge
from repro_torch.analysis.roofline import count_params
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
from repro_torch.examples import common
from repro_torch.runtime.preemption import PreemptionGuard
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.loop import train
from repro_torch.training.schedule import warmup_cosine


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="tinylm", choices=["tinylm", "lm100m"])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adam8bit", "adafactor", "sgdm"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' trains on the CPU")
    args = ap.parse_args(argv)

    cfg = get_config(args.model)
    n = count_params(cfg)["total"]
    print(f"model={cfg.name} params={n/1e6:.1f}M layers={cfg.num_layers} "
          f"d_model={cfg.d_model}")

    sched = warmup_cosine(args.lr, warmup_steps=max(args.steps // 20, 10),
                          total_steps=args.steps)
    opt = opt_lib.get_optimizer(args.optimizer, sched)
    corpus = SyntheticCorpus(vocab=cfg.vocab_size, seed=0)

    ckpt_dir = args.ckpt_dir or str(common.ARTIFACTS / "models_torch" / cfg.name)
    mgr = CheckpointManager(ckpt_dir, interval=args.ckpt_every, keep=2)
    guard = PreemptionGuard()
    loader = ShardedLoader(corpus, batch=args.batch, seq_len=args.seq, seed=1)

    try:
        res = train(cfg, opt, loader, args.steps, ckpt=mgr, guard=guard,
                    accum_steps=args.accum, device=args.device)
    finally:
        loader.close()
        guard.uninstall()
    mgr.save(int(res.state["step"]), bridge.train_state_to_jax(res.state, cfg),
             force=True)
    mgr.wait()
    first = res.losses[0] if res.losses else float("nan")
    last = res.losses[-1] if res.losses else float("nan")
    print(f"done: steps={res.steps_done} loss {first:.3f} -> {last:.3f} "
          f"(ckpts in {ckpt_dir})")
    return res


if __name__ == "__main__":
    main()
