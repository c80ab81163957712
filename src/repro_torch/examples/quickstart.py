"""Quickstart: GRIFFIN serving in ~30 lines (port of
``examples/quickstart.py``).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Loads (or trains) the tiny char-LM, then generates with the full model
and with GRIFFIN at 50% FF sparsity — same prompts, near-identical
continuations, half the decode-phase FF compute.  Runs on the card
unless ``--device cpu``.
"""
import argparse
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.griffin import GriffinConfig
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.examples.common import eval_sequences, trained_tiny
from repro_torch.serving.engine import GenerationEngine


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)
    cfg, params = trained_tiny(device=args.device)
    prompts = eval_sequences(cfg, n=2, length=96, device=args.device)

    full = GenerationEngine(cfg, params, gcfg=None, max_len=160,
                            device=args.device)
    griffin = GenerationEngine(
        cfg, params, gcfg=GriffinConfig(sparsity=0.5, per_shard_topk=False),
        max_len=160, device=args.device,
    )
    out_full = np.asarray(full.generate(prompts, steps=32).cpu())
    out_griffin = np.asarray(griffin.generate(prompts, steps=32).cpu())

    agree = (out_full == out_griffin).mean()
    print(f"GRIFFIN@50% vs full model — token agreement: {agree:.2%}")
    tok = ByteTokenizer()
    for i in range(2):
        print(f"\nprompt[{i}]  : ...{tok.decode(prompts[i, -24:].cpu().numpy())!r}")
        print(f"full      : {tok.decode(out_full[i])!r}")
        print(f"griffin50 : {tok.decode(out_griffin[i])!r}")
    return out_full, out_griffin


if __name__ == "__main__":
    main()
