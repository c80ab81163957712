"""Flocking analysis (paper section 4.1, Figures 1-2, Appendix C; port of
``examples/flocking_analysis.py``).

  PYTHONPATH=src python -m repro_torch.examples.flocking_analysis \\
      [--device cpu] [--emit-profile PATH]

Prints per-layer flocking scores for the trained model on (a) a real
held-out sequence, (b) a token-permuted version, (c) uniform-random
tokens (the Appendix C ablation), plus the inter- vs intra-sequence
Jaccard contrast that motivates ADAPTIVE (per-sequence) selection.
Also dumps a Figure-1-style heat map as CSV under the port's artifacts
(``ARTIFACTS/flocking_torch/``).

With ``--emit-profile PATH`` it additionally runs the offline
profile-derivation pass (``analysis/profile.py``) and writes a
``SparsityProfile`` JSON artifact servable via
``python -m repro_torch.launch.serve --sparsity-profile PATH --tier T``.
Runs on the card unless ``--device cpu``.
"""
import argparse
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.flocking import (
    flocking_score,
    heatmap_data,
    jaccard_topk,
    pairwise_jaccard,
    sequence_statistic,
)
from repro_torch.examples import common
from repro_torch.models import decoder


def layer_activations(params, cfg, tokens) -> List[torch.Tensor]:
    """Z per FF layer for one sequence: list of [S, F]."""
    _, aux = decoder.forward(params, cfg, tokens, collect_stats=True,
                             want_z=True, logits_mode="last")
    st = decoder.prune_stats_tree(aux.stats, cfg)
    return [st[li]["z"][0] for li in sorted(st)]


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--emit-profile", metavar="PATH", default=None,
                    help="derive a per-layer SparsityProfile from the "
                         "flocking pass and write it as JSON")
    ap.add_argument("--profile-seqs", type=int, default=4,
                    help="held-out sequences for profile derivation")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)
    dev = args.device

    cfg, params = common.trained_tiny(device=dev)
    rng = np.random.default_rng(0)
    seq = common.eval_sequences(cfg, n=1, length=192, device=dev)
    perm = seq[:, torch.from_numpy(rng.permutation(192)).to(seq.device)]
    rand = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, 192))
                            ).to(seq.device)

    print("per-layer flocking score (mean pairwise top-5% Jaccard across tokens)")
    print("layer,real,permuted,random")
    z_real = layer_activations(params, cfg, seq)
    z_perm = layer_activations(params, cfg, perm)
    z_rand = layer_activations(params, cfg, rand)
    scores = []
    for li, (a, b, c) in enumerate(zip(z_real, z_perm, z_rand)):
        scores.append((flocking_score(a), flocking_score(b), flocking_score(c)))
        print(f"{li},{scores[-1][0]:.3f},{scores[-1][1]:.3f},{scores[-1][2]:.3f}")

    # inter- vs intra-sequence top-k agreement (Figure 2's contrast)
    seqs = common.eval_sequences(cfg, n=6, length=192, device=dev)
    stats = [sequence_statistic(layer_activations(params, cfg, seqs[i:i+1])[2])
             for i in range(6)]
    inter = pairwise_jaccard(stats, k=cfg.d_ff // 2).mean()
    h1 = sequence_statistic(layer_activations(params, cfg, seqs[:1, :96])[2])
    h2 = sequence_statistic(layer_activations(params, cfg, seqs[:1, 96:])[2])
    intra = jaccard_topk(h1, h2, cfg.d_ff // 2)
    print(f"\ntop-50% expert-set Jaccard: intra-sequence={intra:.3f} "
          f"inter-sequence={inter:.3f}")
    print("(high intra + low inter == the paper's case for adaptive selection)")

    out = common.ARTIFACTS / "flocking_torch" / "heatmap_layer2.csv"
    out.parent.mkdir(parents=True, exist_ok=True)
    hm = heatmap_data(z_real[2], tokens=128, feats=cfg.d_ff)
    np.savetxt(out, hm, delimiter=",", fmt="%.4f")
    print(f"heat map (|Z-bar|, layer 2) written to {out}")

    profile = None
    if args.emit_profile:
        from repro_torch.analysis.profile import derive_profile

        prof_seqs = common.eval_sequences(cfg, n=args.profile_seqs, length=192,
                                          device=dev)
        profile = derive_profile(cfg, params, prof_seqs)
        dest = Path(args.emit_profile)
        dest.parent.mkdir(parents=True, exist_ok=True)
        profile.save(dest)
        n_layers = sum(len(ws) for _, ws in profile.weights)
        print(f"\nsparsity profile ({n_layers} layer weights) written to {dest}")
        for p, ws in profile.weights:
            print(f"  {p}: " + " ".join(f"{w:.3f}" for w in ws))
    return dict(scores=scores, intra=intra, inter=float(inter), heatmap=hm,
                profile=profile)


if __name__ == "__main__":
    main()
