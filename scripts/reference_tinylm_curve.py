#!/usr/bin/env python3
"""The JAX package's tinylm training curve under the quality benchmarks'
recipe (``benchmarks/common.py::trained_tiny``: AdamW, ``warmup_cosine(
3e-3, 25, 500)``, ``SyntheticCorpus(vocab, seed=0)``, ``ShardedLoader(
batch=16, seq_len=256, seed=1)``, 500 steps at fp32, ``PRNGKey(0)``
init), run on the CPU with ``repro.training.loop.train``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_tinylm_curve.py

Prints ``{step: loss}`` at steps 0, 100, ..., 400 and 499 as JSON: the
reference losses that ``chip_smoke.py`` phase 13b holds the port's
training on the card to (``TINY_REF_LOSSES``).  About 6 minutes on 8
CPU cores.
"""
import json

from repro.configs.registry import get_config
from repro.data.pipeline import ShardedLoader, SyntheticCorpus
from repro.training import optimizer as opt_lib
from repro.training.loop import train
from repro.training.schedule import warmup_cosine

STEPS = 500


def main() -> None:
    cfg = get_config("tinylm")
    opt = opt_lib.adamw(warmup_cosine(3e-3, 25, STEPS))
    loader = ShardedLoader(SyntheticCorpus(vocab=cfg.vocab_size, seed=0),
                           batch=16, seq_len=256, seed=1)
    try:
        res = train(cfg, opt, loader, STEPS, log_every=100)
    finally:
        loader.close()
    at = list(range(0, STEPS, 100)) + [STEPS - 1]
    print(json.dumps({s: res.losses[s] for s in at}))


if __name__ == "__main__":
    main()
