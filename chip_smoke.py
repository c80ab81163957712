#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py [--profile] [--out chiprun_out/chip_smoke.json]

Phases (any failure raises and the script exits non-zero):

1. build the hand-written kernels from ``src/repro_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card at
   Yi-9B shapes (H=32, KV=4, hd=128, page 16; decode S=1 and prefill
   chunk S=32 with fp32 and bf16 pools; ``expert_stat`` on [1,32,11008]
   bf16) and at the tinylm shapes phase 3 gives them (H=6, KV=3, hd=32,
   page 8, table width 8, fp32): ctx and statistics within
   rtol=atol=1e-5, pools bit-identical except the trash page, gathers
   exact; each timed with CUDA events (median) beside its bound and its
   plain version's time;
3. tinylm at fp32, random weights: ``PagedServer`` with the ``fused`` and
   the ``gather`` backend gives the same token streams, and the same as
   the port on the CPU (plain versions) — launches all three kernels;
4. Yi-9B at full width and depth (bf16, random weights from a seed):
   ``PagedServer`` with GRIFFIN at sparsity 0.5 and ``kernel_backend=
   "auto"`` serves 4 requests (prompts of 200-600 tokens, 32 new tokens
   each, 2 slots); prints tokens/s, TTFT p50, peak memory and launches.

The second-to-last line is a JSON object listing the kernels; the last
line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit): HBM,
# float32 outside the tensor cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 25, flush=None) -> float:
    """Median device milliseconds of ``fn`` (CUDA events around each call;
    ``flush`` is rewritten before each call so L2 starts cold).  A GPU
    spin is queued ahead of each call so the host has enqueued all of
    ``fn``'s launches before the first one runs: the events then time the
    device work, not the host's Python dispatch."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)  # ~1 ms of GPU clock cycles
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound(bytes_: float, flops: float, dtype: str = "float32"):
    """Least time for the work: bytes over the memory rate or operations
    over the peak rate for the inputs' type, whichever is larger."""
    t_b = bytes_ / HBM_BYTES_PER_S * 1e3
    t_o = flops / FLOP_PER_S[dtype] * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_attn_case(torch, gen, B, S, lens, pool_dtype, dev, H, KV, hd, page,
                    W=None):
    """``lens`` tokens already cached per request, pages scattered over
    the pool, one row partly masked; ``W`` is the block table's width
    (the server's ``max_len // page``), default the widest request."""
    need = [-(-(n + S) // page) for n in lens]
    W = W or max(need)
    P = sum(need) + 8
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    # queries and new rows come in the model dtype: bf16 beside bf16 pools
    # (Yi-9B), fp32 beside fp32 pools (tinylm)
    q, kn, vn = (rnd(B, S, H, hd).to(pool_dtype), rnd(B, S, KV, hd).to(pool_dtype),
                 rnd(B, S, KV, hd).to(pool_dtype))
    pk = rnd(P + 1, page, KV, hd).to(pool_dtype)
    pv = rnd(P + 1, page, KV, hd).to(pool_dtype)
    perm = torch.randperm(P, generator=gen, device=dev).to(torch.int32)
    bt = torch.full((B, W), -1, dtype=torch.int32, device=dev)
    c = 0
    for b in range(B):
        bt[b, : need[b]] = perm[c : c + need[b]]
        c += need[b]
    pos = torch.tensor(lens, dtype=torch.int32, device=dev)
    wm = torch.ones((B, S), dtype=torch.bool, device=dev)
    if S > 1:
        wm[0, S - 3:] = False  # a partial last chunk
    return [q, kn, vn, pk, pv, bt, pos, wm]


def paged_attn_work(args, lens):
    """(bytes, operations) the step must at least move and do: read the
    cached K/V rows, the queries, the new rows, the table, positions and
    mask once; write the context and the new rows that exist once."""
    q, kn, vn, pk, pv, bt, pos, wm = args
    B, S, H, hd = q.shape
    KV = kn.shape[2]
    isz = pk.element_size()
    n_new = int(wm.sum())
    byts = (sum(lens) * KV * hd * 2 * isz                   # cached K/V rows
            + (q.numel() + kn.numel() + vn.numel()) * q.element_size()
            + bt.numel() * 4 + pos.numel() * 4 + wm.numel()
            + B * S * H * hd * 4                            # ctx (fp32)
            + n_new * KV * hd * 2 * isz)                    # rows written
    # causal: query s of a request attends n + s + 1 keys; QK^T and PV
    flops = sum(4 * H * hd * (n + s + 1) for n in lens for s in range(S))
    return byts, flops


def gather_work(pool, bt, out):
    """Bytes a gather must move: each distinct page the clamped table
    names read once, the table read once, the output written once."""
    distinct = int(bt.clamp(min=0).unique().numel())
    page_bytes = pool[0].numel() * pool.element_size()
    return distinct * page_bytes + bt.numel() * 4 + out.numel() * out.element_size()


def phase_kernels(torch, dev, flush):
    """Each kernel against its plain version at Yi-9B shapes (timed; these
    are the numbers the kernels line reports) and at the tinylm shapes
    that phase 3 drives (checked with the same tolerances)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    results = {}
    lines = []
    yi = dict(H=32, KV=4, hd=128, page=16)
    tiny = dict(H=6, KV=3, hd=32, page=8, W=8)  # page 8, max_len 64

    # -- paged_attn: decode (B=2, S=1) and one prefill chunk (B=1) ---------
    worst = 0.0
    cases = [("yi-9b", "decode", 2, 1, [583, 431], dt, yi)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [("yi-9b", "prefill", 1, 32, [448], dt, yi)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [("tinylm", "decode", 2, 1, [43, 28], torch.float32, tiny),
              ("tinylm", "prefill", 1, 16, [32], torch.float32, tiny)]
    for model, label, B, S, lens, pool_dtype, shape in cases:
        args = paged_attn_case(torch, gen, B, S, lens, pool_dtype, dev, **shape)
        kern = [a.clone() for a in args]
        plain = [a.clone() for a in args]
        ctx_k, pk_k, pv_k = ops.paged_attention(*kern)
        ctx_r, pk_r, pv_r = ref.paged_attn_ref(*plain)
        torch.cuda.synchronize()
        what = f"paged_attn {model} {label} {pool_dtype}"
        err = (ctx_k - ctx_r).abs().max().item()
        check(torch.allclose(ctx_k, ctx_r, rtol=1e-5, atol=1e-5),
              f"{what}: ctx max err {err}")
        check(torch.equal(pk_k[:-1], pk_r[:-1]) and torch.equal(pv_k[:-1], pv_r[:-1]),
              f"{what}: pools differ")
        worst = max(worst, err)
        ms = time_ms(torch, lambda: ops.paged_attention(*kern), flush=flush)
        plain_ms = time_ms(torch, lambda: ref.paged_attn_ref(*plain), flush=flush)
        byts, flops = paged_attn_work(args, lens)
        b_ms, b_by = bound(byts, flops, str(pool_dtype).split(".")[-1])
        dt = "bf16" if pool_dtype == torch.bfloat16 else "fp32"
        lines.append(f"paged_attn {model} {label:7s} pool={dt} B={B} S={S} "
                     f"ctx={lens}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                     f"bound {b_ms:.5f} ms ({b_by})  max_abs_err {err:.3g}")
        if model == "yi-9b" and label == "decode" and dt == "bf16":
            results["paged_attn"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                         bound_by=b_by, library_ms=None,
                                         at=f"decode B={B} S=1 ctx={lens} bf16 pool")
    results["paged_attn"]["max_abs_err"] = worst

    # -- expert_stat: a Yi-9B prefill chunk [1,32,11008] bf16 and a tinylm
    # one [1,16,512] fp32, the last rows padding ---------------------------
    worst = 0.0
    for model, S, F, dtype in (("yi-9b", 32, 11008, torch.bfloat16),
                               ("tinylm", 16, 512, torch.float32)):
        z = torch.randn(1, S, F, generator=gen, device=dev).to(dtype)
        z[:, -3:] = 0  # padded chunk rows
        got, want = ops.griffin_stat(z), ref.expert_stat_ref(z)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
              f"expert_stat {model}: max err {err}")
        check(torch.equal(got, ops.griffin_stat(z)),
              f"expert_stat {model}: not deterministic")
        worst = max(worst, err)
        ms = time_ms(torch, lambda: ops.griffin_stat(z), flush=flush)
        plain_ms = time_ms(torch, lambda: ref.expert_stat_ref(z), flush=flush)
        b_ms, b_by = bound(z.numel() * z.element_size() + F * 4, 3 * z.numel())
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        lines.append(f"expert_stat {model} [1,{S},{F}] {dt}: kernel {ms:.4f} ms  "
                     f"plain {plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})  "
                     f"max_abs_err {err:.3g}")
        if model == "yi-9b":
            results["expert_stat"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                          bound_by=b_by, library_ms=None,
                                          at=f"z [1,{S},{F}] bf16")
    results["expert_stat"]["max_abs_err"] = worst

    # -- paged_gather: a Yi-9B KV pool with two requests' live tables, and
    # a tinylm one (pool [25, 8, 3*32] fp32, table [2, 8]) ----------------
    for model, P, page, E, W, live, dtype in (
            ("yi-9b", 256, 16, 4 * 128, 64, (37, 28), torch.bfloat16),
            ("tinylm", 24, 8, 3 * 32, 8, (6, 4), torch.float32)):
        pool = torch.randn(P + 1, page, E, generator=gen, device=dev).to(dtype)
        bt = torch.full((2, W), -1, dtype=torch.int32, device=dev)
        for b, n in enumerate(live):
            bt[b, :n] = torch.randperm(P, generator=gen, device=dev)[:n].to(torch.int32)
        got, want = ops.paged_gather(pool, bt), ref.paged_gather_ref(pool, bt)
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"paged_gather {model}: not exact")
        ms = time_ms(torch, lambda: ops.paged_gather(pool, bt), flush=flush)
        plain_ms = time_ms(torch, lambda: ref.paged_gather_ref(pool, bt), flush=flush)
        idx = bt.clamp(min=0).reshape(-1).long()
        lib_ms = time_ms(torch, lambda: torch.index_select(pool, 0, idx), flush=flush)
        b_ms, b_by = bound(gather_work(pool, bt, got), 0)
        dt = "bf16" if dtype == torch.bfloat16 else "fp32"
        lines.append(f"paged_gather {model} [2,{W}] pages of [{page},{E}] {dt}: "
                     f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  index_select "
                     f"{lib_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})  exact")
        if model == "yi-9b":
            results["paged_gather"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms, max_abs_err=0.0,
                at=f"pool [{P + 1},{page},{E}] bf16, bt [2,{W}]")
    return results, lines


# ---------------------------------------------------------------------------
# phases 3-4: the serving path
# ---------------------------------------------------------------------------

def scale_matrices(params, s: float) -> None:
    for lp in params["layers"]:
        for group in ("mixer", "ffn"):
            for k, v in lp[group].items():
                if k.startswith("w"):
                    v.mul_(s)


def to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, dev) for v in tree]
    return tree.to(dev)


def launches():
    from repro_torch.kernels import expert_stat, paged_attn, paged_gather

    return {"paged_attn": paged_attn.launches, "expert_stat": expert_stat.launches,
            "paged_gather": paged_gather.launches}


def reset_launches() -> None:
    from repro_torch.kernels import expert_stat, paged_attn, paged_gather

    paged_attn.launches = expert_stat.launches = paged_gather.launches = 0


def serve(server, prompts):
    for i, (p, n) in enumerate(prompts):
        server.submit(p, n, rid=i)
    return server.drain()


def phase_tinylm(torch, np, dev):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.models import decoder
    from repro_torch.serving.server import PagedServer

    cfg = get_config("tinylm")
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    prompts = [(np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)
                                .astype(np.int32)]), 12) for n in (5, 14)]
    prompts += [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 12)
                for n in (11, 27)]
    kw = dict(page_size=8, num_pages=24, n_slots=2, prefill_chunk=16, max_len=64)
    # one draw (on the CPU: generators on two devices draw differently),
    # scaled so that greedy streams vary, copied to the card
    host = decoder.init_params(cfg, seed=0, device="cpu")
    scale_matrices(host, 2.0)
    outs, counts = {}, {}
    for device, backend in (("cuda", "fused"), ("cuda", "gather"), ("cpu", "gather")):
        params = to_device(host, device)
        srv = PagedServer(cfg, params, gcfg=GriffinConfig(sparsity=0.5),
                          kernel_backend=backend, device=device, **kw)
        reset_launches()
        outs[(device, backend)] = serve(srv, prompts)
        counts[(device, backend)] = launches()
    fused, gather, cpu = outs[("cuda", "fused")], outs[("cuda", "gather")], \
        outs[("cpu", "gather")]
    check(fused == gather, f"tinylm: fused {fused} != gather {gather}")
    check(fused == cpu, f"tinylm: card {fused} != CPU plain versions {cpu}")
    check(len({t for s in fused.values() for t in s}) > 4,
          f"tinylm: degenerate streams {fused}")
    cf, cg = counts[("cuda", "fused")], counts[("cuda", "gather")]
    check(cf["paged_attn"] > 0 and cf["expert_stat"] > 0 and cf["paged_gather"] == 0,
          f"tinylm fused launches {cf}")
    check(cg["paged_gather"] > 0 and cg["expert_stat"] > 0 and cg["paged_attn"] == 0,
          f"tinylm gather launches {cg}")
    check(sum(counts[("cpu", "gather")].values()) == 0,
          "CPU run launched a kernel")
    return {k: cf[k] + cg[k] for k in cf}, fused


def phase_yi9b(torch, np, dev, profile: bool):
    from repro_torch.configs.registry import get_config
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.models import decoder
    from repro_torch.serving.server import PagedServer

    cfg = get_config("yi-9b")  # full width and depth, no cut
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = decoder.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(v.numel() for lp in params["layers"] for g in lp.values()
                   for v in g.values()) + params["embed"]["table"].numel() \
        + params["head"]["w"].numel()
    rng = np.random.default_rng(1)
    lens = (200, 350, 480, 600)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 32)
               for n in lens]
    srv = PagedServer(cfg, params, gcfg=GriffinConfig(sparsity=0.5),
                      page_size=16, num_pages=256, n_slots=2, prefill_chunk=32,
                      max_len=640, kernel_backend="auto", device=dev)
    check(srv.backend == "fused", f"auto resolved to {srv.backend}")
    step_model = srv._step_model

    def checked(*a, **k):
        out = step_model(*a, **k)
        check(bool(torch.isfinite(out[0]).all()), "yi-9b: non-finite logits")
        return out

    srv._step_model = checked
    for i, (p, n) in enumerate(prompts):
        srv.submit(p, n, rid=i)
    reset_launches()
    ticks = []
    t0 = time.perf_counter()
    while True:
        before = launches()
        more = srv.step()
        torch.cuda.synchronize()
        after = launches()
        ticks.append({k: after[k] - before[k] for k in after})
        if not more:
            break
    wall = time.perf_counter() - t0
    counts = launches()
    out = {rid: r.generated for rid, r in srv.sched.finished.items()}
    check(sorted(out) == [0, 1, 2, 3], f"yi-9b finished {sorted(out)}")
    for rid, toks in out.items():
        check(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
              f"yi-9b rid {rid}: {toks}")
    check(counts["paged_attn"] > 0 and counts["expert_stat"] > 0,
          f"yi-9b launches {counts}")
    decode_ticks = [t for t in ticks if t["expert_stat"] == 0 and t["paged_attn"]]
    m = srv.metrics.summary()
    res = dict(
        layers=cfg.num_layers, params=n_params, init_s=t_init, wall_s=wall,
        tokens_per_s=m["tokens_per_sec"], ttft_p50_s=m["ttft_p50_s"],
        tpot_p50_s=m["tpot_p50_s"], steps=m["steps"],
        prefill_chunks=m["prefill_chunks"], preemptions=m["preemptions"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts,
        paged_attn_per_decode_tick=min(t["paged_attn"] for t in decode_ticks),
        generated={rid: toks[:8] for rid, toks in out.items()},
    )
    if profile:
        res["decode_tick_profile"] = profile_decode_tick(torch, np, srv, cfg, rng)
    return res


def profile_decode_tick(torch, np, srv, cfg, rng):
    """Device time by kernel over decode ticks of two fresh requests
    (``torch.profiler``), after their prefill and first decode."""
    from torch.profiler import ProfilerActivity, profile

    for i, n in enumerate((583, 431)):
        srv.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 12,
                   rid=100 + i)
    sched = srv.sched
    while sched.queue or sched.prefilling is not None \
            or not all(len(r.generated) >= 2 for r in sched.decoding):
        srv.step()
    torch.cuda.synchronize()
    n_ticks = 4
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            srv.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            dev_us = getattr(e, "device_time_total", None)
            if dev_us is None:
                dev_us = e.cuda_time_total
            rows.append((e.key, dev_us / n_ticks / 1e3, e.count // n_ticks))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    srv.drain()
    return dict(tick_wall_ms=wall / n_ticks * 1e3, device_busy_ms=busy,
                top=[dict(kernel=k[:90], ms=ms, per_tick=c) for k, ms, c in rows[:12]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile Yi-9B decode ticks with torch.profiler")
    ap.add_argument("--out", default="", help="also write the results as JSON")
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: no src/repro_torch beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    build.build()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s")

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)  # > 50 MB L2
    kernels, lines = phase_kernels(torch, dev, flush)
    del flush
    print(f"phase 2 kernels vs plain versions ({card}):")
    for line in lines:
        print("  " + line)

    t0 = time.perf_counter()
    tiny_counts, streams = phase_tinylm(torch, np, dev)
    print(f"phase 3 tinylm fused == gather == CPU plain: {time.perf_counter() - t0:.1f} s, "
          f"launches {tiny_counts}, rid 0 {streams[0]}")

    t0 = time.perf_counter()
    yi = phase_yi9b(torch, np, dev, args.profile)
    print(f"phase 4 yi-9b ({card}): {time.perf_counter() - t0:.1f} s total, "
          f"{yi['params'] / 1e9:.2f}B params, init {yi['init_s']:.1f} s")
    for k in ("wall_s", "tokens_per_s", "ttft_p50_s", "tpot_p50_s", "steps",
              "prefill_chunks", "preemptions", "peak_mem_gb", "launches",
              "paged_attn_per_decode_tick"):
        print(f"  {k}: {yi[k]}")
    if "decode_tick_profile" in yi:
        print("  decode tick profile: " + json.dumps(yi["decode_tick_profile"]))

    sources = {"paged_attn": ("src/repro_torch/csrc/paged_attn.cu",
                              "src/repro/kernels/paged_attn.py:340"),
               "expert_stat": ("src/repro_torch/csrc/expert_stat.cu",
                               "src/repro/kernels/expert_stat.py:47"),
               "paged_gather": ("src/repro_torch/csrc/paged_gather.cu",
                                "src/repro/kernels/paged_gather.py:52")}
    entries = []
    for name, (src, replaces) in sources.items():
        r = kernels[name]
        n_tiny = tiny_counts[name]
        n_yi = yi["launches"][name]
        check(n_tiny + n_yi > 0, f"{name} was never launched on the main path")
        entries.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": n_tiny + n_yi,
                        "launches_tinylm": n_tiny, "launches_yi9b": n_yi,
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "at": r["at"]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": entries, "yi9b": yi,
             "tinylm_launches": tiny_counts}, indent=1, default=str))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
