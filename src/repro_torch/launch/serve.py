"""Serving launcher of the port: prefill -> GRIFFIN select/compact ->
pruned decode over the paged-KV ``PagedServer``, or the
``ContinuousBatcher`` slot fallback for the archs the paged path does
not cover (MoE, MLA, SSM, the RG-LRU hybrid, the encoder and the VLM,
which serve token prompts without their frontend), on the card by
default (port of ``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinylm \\
      --requests 8 --sparsity 0.5

``--device cpu`` runs the kernels' plain PyTorch versions on the CPU;
without it and without a CUDA device the launcher fails.  ``--http
HOST:PORT`` serves ``POST /v1/generate`` (SSE), ``GET /metrics`` and
``GET /healthz`` through ``serving/frontend.py`` instead of draining
synthetic requests.

Flags, defaults, checks and summary lines are the reference's, except:

* ``--torch-profile DIR`` (the reference's ``--jax-profile``) writes a
  ``torch.profiler`` trace of the drain to ``DIR/trace.json``;
* ``--device`` picks the device (default: the card);
* ``--mesh model=N`` spawns N ranks (``launch.mesh.run_ranks``), each
  serving its shard of the same requests; ``--tp-backend`` picks
  ``nccl`` (the default on the card: one card per rank) or ``gloo`` (the
  only backend on ``--device cpu``; on the card it lets N ranks share
  one card).  Rank 0 prints the summary lines; ``main`` checks that
  every rank's streams are equal and returns rank 0's.  With ``--http``
  rank 0 serves the frontend and relays each tick's submissions, cancels
  and step to the other ranks (``serving/relay.py``); the run has no time
  limit, Ctrl-C (a SIGINT to the launcher or to every process) stops
  every rank, and ``main`` checks that their streams, aborts and free
  pages are equal.

The slot fallback refuses ``--spec-k``, the observability flags and
``--http``, as the reference does.  Without a checkpoint (``--ckpt-dir``,
default ``artifacts/models/<arch>-s500``) tinylm serves an untrained
init, and every other arch its smoke-size config with an init, drawn on
the CPU from seed 0 (so the card and the CPU serve the same weights;
they are not the reference's ``PRNGKey(0)`` draw).  ``main(argv)``
returns the drained ``{rid: tokens}`` (None in ``--http`` mode).
"""
from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
import signal
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.profiler

from repro_torch import bridge
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
from repro_torch.core.griffin import TIERS, GriffinConfig, SparsityProfile
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.distributed.tp import PagedTP, pool_shard_bytes, tree_bytes
from repro_torch.kernels import backend
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import decoder
from repro_torch.obs.export import write_trace
from repro_torch.obs.trace import Tracer
from repro_torch.serving import relay
from repro_torch.serving.engine import ContinuousBatcher
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.serving.server import PagedServer
from repro_torch.serving.slo import SLO_CLASSES

def parse_mesh(spec: str):
    """``model=N`` -> (axis, N)."""
    try:
        axis, n = spec.split("=")
        return axis.strip(), int(n)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--mesh wants AXIS=N (e.g. model=2), got {spec!r}"
        )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="tinylm",
                    choices=ASSIGNED_ARCHS + ["tinylm", "tinylm-tp"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=64)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--no-griffin", action="store_true")
    ap.add_argument("--tier", type=float, default=None, choices=list(TIERS),
                    help="per-request sparsity tier: the fraction of FF "
                         "experts every request keeps (1.0 = dense path, "
                         "bit-exact).  Synthetic requests all carry it; in "
                         "--http mode it becomes the default for requests "
                         "that don't send a \"tier\" field.  Omit for the "
                         "global --sparsity budget")
    ap.add_argument("--sparsity-profile", default=None, metavar="PATH",
                    help="per-layer expert-budget profile JSON; scales "
                         "each layer's tier budget by its weight.  "
                         "Requires --tier")
    ap.add_argument("--spec-k", type=int, default=0,
                    help="self-speculative decoding: tokens drafted per "
                         "verify with the GRIFFIN-compacted weights "
                         "(requires GRIFFIN; output stays dense-exact)")
    ap.add_argument("--spec-impl", default="fused",
                    choices=["fused", "per_token"],
                    help="draft-loop implementation: 'fused' runs the "
                         "whole k-token draft + verify round with one host "
                         "sync; 'per_token' syncs per draft token, kept as "
                         "a differential oracle (token-identical)")
    ap.add_argument("--no-adaptive-spec", action="store_true",
                    help="pin the draft length at --spec-k instead of "
                         "adapting it per request from the live "
                         "acceptance EWMA")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable shared-prefix paged-KV reuse (radix "
                         "cache + copy-on-write pages; output is "
                         "token-identical either way)")
    ap.add_argument("--kernel-backend", default="auto",
                    choices=["auto", "fused", "gather"],
                    help="paged-attention path: the fused paged_attn "
                         "kernel, the gather-then-attend path (paged_gather "
                         "kernel on the card), or auto (fused on the card, "
                         "gather on the CPU); output is token-identical")
    ap.add_argument("--kv-dtype", default="fp32",
                    choices=["fp32", "bf16", "int8", "fp8"],
                    help="paged KV-pool storage dtype: fp32 inherits the "
                         "model dtype; bf16 halves pool bytes; int8/fp8 "
                         "quantize pages with per-page-per-head scales "
                         "dequantized inside the attention kernel")
    ap.add_argument("--mesh", type=parse_mesh, default=None,
                    metavar="AXIS=N",
                    help="tensor-parallel paged serving over an N-way "
                         "mesh axis (e.g. model=2): N ranks, each holding "
                         "its KV heads, attention heads and FF block")
    ap.add_argument("--tp-backend", default=None, choices=["nccl", "gloo"],
                    help="torch.distributed backend of --mesh: nccl (the "
                         "default on the card, one card per rank) or gloo "
                         "(the only one on --device cpu; on the card it "
                         "lets the ranks share one card)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the drain as structured spans and write "
                         "a Chrome/Perfetto trace.json")
    ap.add_argument("--metrics-snapshot", default=None, metavar="PATH",
                    help="write end-of-drain metrics: .json -> JSON "
                         "snapshot, anything else -> Prometheus text "
                         "exposition")
    ap.add_argument("--flocking-telemetry", type=int, default=0,
                    metavar="N",
                    help="probe GRIFFIN expert-selection stability every "
                         "N decode ticks (Jaccard + angular drift per "
                         "layer; requires GRIFFIN; 0 = off)")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the drain into "
                         "DIR/trace.json (with --trace-out, model steps "
                         "also get record_function markers)")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the CUDA card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--http", default=None, metavar="HOST:PORT",
                    help="serve over HTTP instead of draining synthetic "
                         "requests: POST /v1/generate streams tokens as "
                         "SSE, GET /metrics is Prometheus, GET /healthz "
                         "is liveness (see serving/frontend.py)")
    ap.add_argument("--slo-class", default="standard",
                    choices=sorted(SLO_CLASSES),
                    help="default SLO class for requests that do not "
                         "name one (priority + TTFT deadline; expired "
                         "requests that produced nothing are shed)")
    return ap


def synthetic_requests(cfg, n: int, max_len: int):
    """The reference launcher's requests: ``SyntheticCorpus`` prompts of
    16..max_len/2 tokens and 8..31 new tokens, from fixed seeds."""
    corpus = SyntheticCorpus(vocab=cfg.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    return [
        (corpus.sample(int(rng.integers(16, max_len // 2)), seed=500 + rid),
         int(rng.integers(8, 32)))
        for rid in range(n)
    ]


def load_params(cfg, arch: str, ckpt_dir: Optional[str], device,
                tp: Optional[PagedTP] = None):
    """tinylm: the checkpoint's parameters (reference layout, bridged)
    or, without one, an untrained init; other archs: a smoke-size init.
    With ``tp``, only that rank's blocks reach ``device``."""
    if arch in ("tinylm", "tinylm-tp"):
        ckpt_dir = ckpt_dir or f"artifacts/models/{arch}-s500"
        mgr = CheckpointManager(ckpt_dir, interval=1)
        if mgr.latest_step() is not None:
            state, step = mgr.restore_latest()
            print(f"[ckpt] loaded {ckpt_dir} (step {step})")
            return bridge.params_from_jax(state["params"], cfg, device, tp=tp)
        print(f"[ckpt] no checkpoint in {ckpt_dir}; serving an "
              f"UNTRAINED init (train one with the reference package or "
              f"pass --ckpt-dir)")
    # drawn on the CPU: a CUDA generator draws other values from one seed
    params = decoder.init_params(cfg, seed=0, device="cpu")
    if tp is not None:
        return tp.shard_params(params, device)
    return _to(params, device)


def serve_requests(mesh, cfg, params, gcfg, prompts, server_kw: Dict) -> Dict:
    """One rank of a tensor-parallel ``PagedServer`` (``mesh``: this
    rank's ``ServingMesh``, as ``launch.mesh.run_ranks`` passes it) over
    ``prompts`` (``[(tokens, max_new)]``, rids in order).  ``params`` is
    the global tree on the host (the rank takes its blocks) or an int
    seed (the rank draws its blocks on its device,
    ``PagedTP.init_params``).  Returns plain data: the streams, this
    rank's pool and parameter bytes and the metrics summary."""
    if isinstance(params, int):
        params = PagedTP(cfg, mesh).init_params(params)
    srv = PagedServer(cfg, params, gcfg, mesh=mesh, **server_kw)
    del params
    for rid, (prompt, max_new) in enumerate(prompts):
        srv.submit(np.asarray(prompt), max_new, rid=rid)
    streams = srv.drain()
    return dict(streams=streams, pool_bytes=pool_shard_bytes(srv.pools),
                param_bytes=tree_bytes(srv.params),
                metrics=srv.metrics.summary(),
                prefix_hits=srv.metrics.prefix_hits)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def main(argv: Optional[Sequence[str]] = None
         ) -> Optional[Dict[int, List[int]]]:
    ap = build_parser()
    argv = list(sys.argv[1:] if argv is None else argv)
    args = ap.parse_args(argv)
    if args.mesh is None:
        return _serve(ap, args)
    axis, n = args.mesh
    if args.http is not None:
        _http_addr(ap, args.http)  # before any rank starts
    cfg = get_config(args.arch, smoke=args.arch not in ("tinylm", "tinylm-tp"))
    if not decoder.supports_paged(cfg):
        ap.error(f"--mesh requires the paged serving path; "
                 f"{cfg.name} falls back to the slot batcher")
    device = backend.resolve_device(args.device)
    tp_backend = args.tp_backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cpu" and tp_backend != "gloo":
        ap.error("--mesh on --device cpu runs on --tp-backend gloo only")
    print(f"[mesh] {axis}={n}: {n} ranks on {tp_backend} ({device.type})")
    http = args.http is not None
    # an --http server runs until it is stopped: no time limit, and a
    # SIGINT to this process goes to rank 0, which stops every rank
    results, _ = run_ranks(_serve_rank, n, backend=tp_backend,
                           device=args.device, axis=axis, args=(argv,),
                           timeout_s=None if http else 600.0)
    what = "streams, aborts or free pages" if http else "streams"
    for r, res in enumerate(results[1:], 1):
        if res != results[0]:
            raise RuntimeError(f"--mesh {axis}={n}: rank {r}'s {what} "
                               f"differ from rank 0's")
    return None if http else results[0]


def _serve_rank(mesh, argv: List[str]):
    """One rank of ``--mesh``: the launcher's run on this rank's shard;
    only rank 0 prints.  Under ``--http`` the other ranks ignore SIGINT
    (Ctrl-C reaches every process): rank 0's stop message ends them."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if mesh.rank == 0:
        return _serve(ap, args, mesh)
    if args.http is not None:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
    with contextlib.redirect_stdout(io.StringIO()):
        return _serve(ap, args, mesh)


def _http_addr(ap, spec: str):
    """``HOST:PORT`` -> (host, port), or the parser's error."""
    try:
        host, port = spec.rsplit(":", 1)
        return host, int(port)
    except ValueError:
        ap.error(f"--http wants HOST:PORT, got {spec!r}")


async def _serve_until_stopped(fe, host: str, port: int) -> None:
    """``fe.serve_http`` until a SIGINT, which stops the frontend after
    its tick (however many arrive)."""
    asyncio.get_running_loop().add_signal_handler(signal.SIGINT, fe.stop)
    await fe.serve_http(host, port)


def _serve(ap, args, mesh=None) -> Optional[Dict[int, List[int]]]:
    cfg = get_config(args.arch, smoke=args.arch not in ("tinylm", "tinylm-tp"))
    paged = decoder.supports_paged(cfg)
    device = mesh.device if mesh is not None \
        else backend.resolve_device(args.device)
    print(f"[device] {device}" + (f" ({torch.cuda.get_device_name(device)})"
                                  if device.type == "cuda" else ""))

    gcfg = None if (args.no_griffin or not cfg.griffin or not cfg.has_ffn) \
        else GriffinConfig(sparsity=args.sparsity)
    profile = None
    if args.sparsity_profile is not None:
        if args.tier is None:
            ap.error("--sparsity-profile requires --tier (profiles scale "
                     "tier budgets)")
        profile = SparsityProfile.load(args.sparsity_profile)
        print(f"[profile] {args.sparsity_profile} "
              f"({len(profile.weights)} layer weights, "
              f"arch={profile.arch or '?'})")
    if args.tier is not None and gcfg is None:
        ap.error("--tier requires GRIFFIN (drop --no-griffin)")
    mode = f"GRIFFIN@{args.sparsity:.0%}" if gcfg else "full model"
    if args.tier is not None:
        mode = f"GRIFFIN tier={args.tier}" + ("+profile" if profile else "")
    if args.spec_k and gcfg is None:
        ap.error("--spec-k requires GRIFFIN (drop --no-griffin)")
    if args.spec_k and not paged:
        ap.error(f"--spec-k requires the paged serving path; "
                 f"{cfg.name} falls back to the slot batcher")
    if args.spec_k:
        mode += f"+spec{args.spec_k}"
    obs_flags = (args.trace_out, args.metrics_snapshot,
                 args.flocking_telemetry, args.torch_profile)
    if any(obs_flags) and not paged:
        ap.error(f"observability flags need the paged serving path; "
                 f"{cfg.name} falls back to the slot batcher")
    if args.http is not None:
        if not paged:
            ap.error(f"--http requires the paged serving path; "
                     f"{cfg.name} falls back to the slot batcher")
        http_host, http_port = _http_addr(ap, args.http)
    if args.flocking_telemetry and gcfg is None:
        ap.error("--flocking-telemetry requires GRIFFIN "
                 "(drop --no-griffin)")

    if mesh is not None:
        mode += f"+tp{mesh.size}"
    tp = None if mesh is None else PagedTP(cfg, mesh)
    params = load_params(cfg, args.arch, args.ckpt_dir, device, tp)
    reqs = synthetic_requests(cfg, args.requests, args.max_len)
    if not paged:
        return serve_slots(cfg, params, gcfg, reqs, args, mode, device)
    tracer = None
    if args.trace_out:
        tracer = Tracer(annotate_profiler=bool(args.torch_profile))

    srv = PagedServer(
        cfg, params, gcfg=gcfg, page_size=args.page_size,
        num_pages=args.num_pages, n_slots=args.slots,
        prefill_chunk=args.prefill_chunk, max_len=args.max_len,
        spec_k=args.spec_k, spec_impl=args.spec_impl,
        adaptive_spec=not args.no_adaptive_spec,
        prefix_cache=not args.no_prefix_cache,
        kernel_backend=args.kernel_backend, kv_dtype=args.kv_dtype,
        tracer=tracer, flocking_every=args.flocking_telemetry,
        profile=profile, default_tier=args.tier, device=device,
        mesh=mesh,
    )
    del params
    if args.http is not None:
        if mesh is not None and mesh.rank > 0:  # replay rank 0's ticks
            return relay.follow(srv, relay.ControlChannel())
        leader = None if mesh is None \
            else relay.MeshLeader(srv, relay.ControlChannel())
        fe = ServingFrontend(leader or srv, default_slo=args.slo_class)
        print(f"[{mode}] http: serving on {http_host}:{http_port} "
              f"(default SLO class: {args.slo_class})")
        print(f"  POST http://{http_host}:{http_port}/v1/generate  "
              f'{{"prompt": [1,2,3], "max_new": 16, '
              f'"slo": "interactive"}}  -> SSE token stream')
        print(f"  GET  http://{http_host}:{http_port}/metrics   "
              f"(Prometheus)   /healthz (liveness)")
        try:
            asyncio.run(_serve_until_stopped(fe, http_host, http_port))
        except KeyboardInterrupt:
            pass
        # a late Ctrl-C must not cut the followers' stop message short
        prev = signal.signal(signal.SIGINT, signal.SIG_IGN)
        if leader is not None:
            leader.stop()
        signal.signal(signal.SIGINT, prev)
        m = srv.metrics.summary()
        s = fe.summary()
        print(f"[{mode}] http: accepted={s['accepted']:.0f} "
              f"completed={s['completed']:.0f} shed={s['shed']:.0f} "
              f"slo_met_rate={s['slo_met_rate']:.2f} "
              f"ttft_p99={s['ttft_p99_s']:.3f}s "
              f"steps={m['steps']:.0f}")
        return None if mesh is None else relay.outcome(srv)

    for rid, (prompt, gen) in enumerate(reqs):
        srv.submit(prompt, max_new=gen, rid=rid)
    prof = None
    if args.torch_profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
    t0 = time.perf_counter()
    results = srv.drain()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if prof is not None:
        prof.stop()
        out = Path(args.torch_profile)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "trace.json"))
        print(f"[obs] torch profile -> {out / 'trace.json'}")
    total = sum(len(v) for v in results.values())
    m = srv.metrics.summary()
    print(f"[{mode}] paged: served {args.requests} requests / {total} "
          f"tokens in {dt:.2f}s ({total/dt:.1f} tok/s, {args.slots} slots)")
    print(f"  ttft p50={m['ttft_p50_s']:.3f}s p95={m['ttft_p95_s']:.3f}s "
          f"occupancy={m['pool_occupancy_mean']:.0%} "
          f"preemptions={m['preemptions']:.0f}")
    if not args.no_prefix_cache:
        print(f"  prefix: hit_rate={m['prefix_hit_rate']:.2f} "
              f"saved_tokens={m['saved_prefill_tokens']:.0f} "
              f"cow={m['cow_copies']:.0f} "
              f"shared_pages={m['shared_pages_mean']:.1f}")
    if args.spec_k:
        print(f"  spec: acceptance={m['acceptance_rate']:.3f} "
              f"tokens/verify={m['tokens_per_verify']:.2f} "
              f"rounds={m['spec_rounds']:.0f} "
              f"k_mean={m['draft_k_mean']:.2f} "
              f"capped_rounds={m['spec_capped_rounds']:.0f}")
    if args.flocking_telemetry and srv.flocking is not None \
            and srv.flocking.last:
        vals = list(srv.flocking.last.values())
        jac = float(np.mean([v["jaccard"] for v in vals]))
        ang = float(np.mean([v["angular"] for v in vals]))
        print(f"  flocking: jaccard={jac:.3f} angular={ang:.3f} "
              f"({len(vals)} requests probed every "
              f"{args.flocking_telemetry} ticks)")
    if tracer is not None:
        path = write_trace(tracer, args.trace_out,
                           meta={"mode": mode, "requests": args.requests})
        print(f"[obs] trace ({len(tracer.events)} events) -> {path}")
    if args.metrics_snapshot:
        path = srv.metrics.write_snapshot(args.metrics_snapshot)
        print(f"[obs] metrics snapshot -> {path}")
    return results


def serve_slots(cfg, params, gcfg, reqs, args, mode: str, device
                ) -> Dict[int, List[int]]:
    """The reference's slot-batcher fallback: drain ``reqs`` through a
    ``ContinuousBatcher`` of ``--slots`` slots."""
    cb = ContinuousBatcher(cfg, params, n_slots=args.slots,
                           max_len=args.max_len, gcfg=gcfg, device=device)
    for rid, (prompt, gen) in enumerate(reqs):
        cb.submit(prompt, max_new=gen, rid=rid)
    t0 = time.perf_counter()
    results = cb.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    total = sum(len(v) for v in results.values())
    print(f"[{mode}] slots: served {args.requests} requests / {total} tokens "
          f"in {dt:.2f}s ({total/dt:.1f} tok/s, {args.slots} slots)")
    return results


if __name__ == "__main__":
    main()
