"""The trained tiny model and held-out sequences the examples use (port
of ``benchmarks/common.py``'s ``trained_tiny`` and ``eval_sequences``).

``trained_tiny`` trains with the reference's recipe (AdamW on a 25-step
warmup cosine to 3e-3, batches of 16 x 256 from the synthetic corpus)
through the port's ``training/loop.train`` and caches the checkpoint, in
the reference's layout, under ``ARTIFACTS / "models_torch" /
"<arch>-s<steps>"``: never under ``artifacts/models/``, where the
reference's own model lives.  Its init is the port's draw, not the
reference's ``PRNGKey(0)``, so the two models differ; both follow the
same recipe.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
from repro_torch.kernels import backend
from repro_torch.training import optimizer as opt_lib
from repro_torch.training.loop import train
from repro_torch.training.schedule import warmup_cosine

#: the root of everything the examples write (checkpoints, the heat map),
#: relative to the working directory as the reference's ``artifacts/``
ARTIFACTS = Path("artifacts")

#: ``trained_tiny``'s default length of training (the reference's)
STEPS = 500


def ckpt_dir(arch: str, steps: int) -> Path:
    """Where ``trained_tiny(steps, arch)`` keeps its model."""
    return ARTIFACTS / "models_torch" / f"{arch}-s{steps}"


def recipe_optimizer(steps: int):
    """The reference's optimizer for a run of ``steps`` steps."""
    return opt_lib.adamw(warmup_cosine(3e-3, 25, steps))


def recipe_loader(cfg, start_step: int = 0) -> ShardedLoader:
    """The reference's batches from step ``start_step`` on (each batch a
    pure function of its step index)."""
    corpus = SyntheticCorpus(vocab=cfg.vocab_size, seed=0)
    return ShardedLoader(corpus, batch=16, seq_len=256, seed=1,
                         start_step=start_step)


def trained_tiny(steps: int = None, arch: str = "tinylm",
                 device=None) -> Tuple[object, Dict]:
    """Load the tiny LM ``arch`` trained for exactly ``steps`` steps
    (default ``STEPS``), on ``device`` (the card unless ``"cpu"``);
    train and cache it on first use.

    The cache directory is keyed by ``(arch, steps)``.  Only the final
    checkpoint counts: an interrupted run leaves intermediate saves
    that resume training from the last of them, with the loader started
    at that step, so a resumed run consumes exactly the batches a clean
    run would and ends at the same model."""
    steps = STEPS if steps is None else int(steps)
    dev = backend.resolve_device(device)
    cfg = get_config(arch)
    mgr = CheckpointManager(str(ckpt_dir(arch, steps)), interval=100, keep=2)
    if mgr.latest_step() != steps:
        loader = recipe_loader(cfg, mgr.latest_step() or 0)
        try:
            res = train(cfg, recipe_optimizer(steps), loader, steps, ckpt=mgr,
                        log_every=100, device=dev)
        finally:
            loader.close()
        mgr.save(int(res.state["step"]), bridge.train_state_to_jax(res.state, cfg),
                 force=True)
        mgr.wait()
    state, _ = mgr.restore_latest()
    return cfg, bridge.params_from_jax(state["params"], cfg, dev)


def eval_sequences(cfg, n: int, length: int, seed: int = 123,
                   device=None) -> torch.Tensor:
    """Held-out sequences from the same synthetic language (different
    seeds than training), ``[n, length]`` int64 on ``device``."""
    corpus = SyntheticCorpus(vocab=cfg.vocab_size, seed=0)
    rows = [corpus.sample(length, seed=seed + 7919 * i) for i in range(n)]
    return torch.from_numpy(np.stack(rows).astype(np.int64)).to(
        backend.resolve_device(device))
