"""Paged-KV serving with chunked prefill + per-request GRIFFIN (port of
``examples/serve_batched.py``).

  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]

Submits a stream of requests with mixed prompt/generation lengths to the
paged serving stack (server -> scheduler -> block-table KV pools).  Each
request streams its GRIFFIN statistic across prefill chunks and decodes
with its own compacted expert set (the paper's adaptive property), while
the scheduler interleaves prefill chunks into the running decode batch
and preempts-by-eviction when the page pool runs dry.  Runs on the card
unless ``--device cpu``.
"""
import argparse
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.griffin import GriffinConfig
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.examples.common import trained_tiny
from repro_torch.serving.server import PagedServer


def requests(cfg, n_req: int = 10):
    """The reference example's requests: ``[(prompt, max_new)]``."""
    corpus = SyntheticCorpus(vocab=cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    out = []
    for rid in range(n_req):
        plen = int(rng.integers(16, 64))
        gen = int(rng.integers(8, 24))
        out.append((corpus.sample(plen, seed=1000 + rid), gen))
    return out


def main(argv: Optional[Sequence[str]] = None) -> Dict[int, List[int]]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)
    cfg, params = trained_tiny(device=args.device)

    srv = PagedServer(
        cfg, params,
        gcfg=GriffinConfig(sparsity=0.5, per_shard_topk=False),
        page_size=16, num_pages=48, n_slots=4, prefill_chunk=32, max_len=128,
        device=args.device,
    )
    reqs = requests(cfg)
    n_req = len(reqs)
    for rid, (prompt, gen) in enumerate(reqs):
        srv.submit(prompt, max_new=gen, rid=rid)

    t0 = time.perf_counter()
    results = srv.drain()
    if srv.device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(v) for v in results.values())
    m = srv.metrics.summary()
    where = "on 1 CPU core" if srv.device.type == "cpu" \
        else f"on {torch.cuda.get_device_name(srv.device)}"
    print(f"served {n_req} requests / {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s {where}, 4 slots)")
    print(f"  ttft p50={m['ttft_p50_s']:.3f}s p95={m['ttft_p95_s']:.3f}s  "
          f"tpot p50={m['tpot_p50_s'] * 1e3:.1f}ms  "
          f"pool occupancy={m['pool_occupancy_mean']:.0%}  "
          f"preemptions={m['preemptions']:.0f}")
    for rid in sorted(results):
        print(f"  req {rid}: {len(results[rid])} tokens")
    return results


if __name__ == "__main__":
    main()
