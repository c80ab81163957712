#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py [--profile] [--out chiprun_out/chip_smoke.json]

Phases (any failure raises and the script exits non-zero):

1. build the hand-written kernels from ``src/repro_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card at
   Yi-9B shapes (H=32, KV=4, hd=128, page 16, table width 40 as phases
   4-5 serve; decode S=1, prefill chunk S=32 and the speculative verify
   call of phase 7b, B=2 S=5 (request 0's rows cross a page, request 1's
   last two masked, quantized pages growing their scales), with fp32,
   bf16, int8 and fp8 pools, the quantized ones timed from warm pools
   each call;
   ``expert_stat`` on
   [1,32,11008] bf16; ``griffin_ffn`` D=4096, F=11008, 43 of 86 blocks,
   B=2; ``glu_ffn`` [32,4096] x [4096,11008]) and at the tinylm shapes
   phase 3 gives them (H=6, KV=3, hd=32, page 8, table width 8, fp32):
   ctx and statistics within rtol=atol=1e-5, pools and scales
   bit-identical except the trash page, quantized ctx within
   ``kv_quant.ERROR_BUDGET`` of the fp32-pool plain version, gathers
   exact, FF outputs within 2e-2 (bf16) / 1e-4 (fp32 at Yi-9B width) /
   1e-5 (fp32, small); each timed with CUDA events (median) beside its
   bound and its plain version's time, beside a launch floor (a
   one-element ``fill_`` timed the same way); ``torch.profiler`` shows
   that one ``ops.paged_attention`` call at the Yi-9B decode and verify
   shapes is one device kernel for each of fp32/bf16/int8/fp8 pools, one
   ``ops.griffin_stat`` call at [1,32,11008] bf16 one device kernel, and
   one ``ops.glu_ffn_forward`` / ``ops.griffin_ffn_decode`` call at Yi-9B
   width ``GLU_FFN_KERNELS`` / ``GRIFFIN_FFN_KERNELS``; ``griffin_ffn``'s
   passes are timed apart (``kernel_times``) beside the server's decode
   FF on compacted copies (``compacted_ffn``: three library products),
   and each of its passes fits the CTAs per SM its plan counts on;
3. tinylm, random weights: ``PagedServer`` with the ``fused`` and the
   ``gather`` backend gives the same token streams, and the same as the
   port on the CPU (plain versions), with fp32, int8 and fp8 pools —
   launches the attention, statistic and gather kernels;
4. Yi-9B at full width and depth (bf16, random weights from a seed):
   ``PagedServer`` with GRIFFIN at sparsity 0.5 and ``kernel_backend=
   "auto"`` serves 4 requests (prompts of 200-600 tokens, 32 new tokens
   each, 2 slots); prints tokens/s, TTFT p50, peak memory and launches;
5. the same model, weights and requests with int8, then fp8, KV pools:
   tokens/s, TTFT, TPOT and attention bytes per token beside phase 4's,
   and the share of tokens equal to phase 4's streams (random weights:
   reported, no floor);
6. the FF kernels' entry points on the same model's 48 FF blocks: per
   layer, ``ops.glu_ffn_forward`` on a 32-token chunk against the dense
   ``ffn_forward``, and the statistic -> ``select_block_ids`` ->
   ``ops.griffin_ffn_decode`` on two decode rows against the compacted
   ``ffn_forward``;
7. speculative serving: (a) phase 3's tinylm and requests with fp32
   (TF32 off), int8 and fp8 pools: ``PagedServer(spec_k=3)`` fused on the
   card gives the same token streams as ``spec_impl="per_token"``, the
   ``gather`` backend and the CPU, and with fp32 pools as the dense
   (``gcfg=None``) server (quantized, a draft may grow a page's scale that
   the verify keeps, as in the reference: the match with dense is
   reported; on a mismatch the dense top-2 logit margin at the first
   differing token is printed); (b) phase 4's Yi-9B model and requests
   with GRIFFIN 0.5 drafts, ``spec_k=4`` fused and adaptive, beside a
   dense server: tokens/s, TTFT, TPOT, acceptance, tokens per verify,
   mean draft length, capped
   rounds, peak memory, attention launches by kind, a spec round's and a
   dense decode tick's host-clock wall time, the share of tokens equal to
   the dense streams (no floor), every verify logit finite, and one
   ``decoder.draft_verify_paged`` call run under
   ``torch.cuda.set_sync_debug_mode("error")`` (no host sync in a round);
8. the serving edge: (a) ``repro_torch.launch.serve.main`` on phase 3's
   tinylm weights, written as a checkpoint in the reference's layout:
   GRIFFIN 0.5 with int8 pools, ``--spec-k 3``, ``--trace-out``,
   ``--metrics-snapshot`` and ``--flocking-telemetry 2``; ``--no-griffin
   --kernel-backend gather``; ``--tier 0.5`` -- each run's streams equal
   the same call with ``--device cpu``, the trace validates
   (``obs.export.validate_chrome_trace``), the snapshot parses and
   ``flocking:`` is printed; (b) phase 4's Yi-9B model behind the
   HTTP/SSE ``ServingFrontend`` on a free 127.0.0.1 port with flocking
   telemetry every 4 ticks: 4 concurrent ``POST /v1/generate`` (phase 4's
   prompts, 32 new tokens, two interactive, two batch) whose SSE streams
   equal a fresh server's ``drain()``, one more the client hangs up after
   4 tokens (counted cancelled, its pages returned), ``/healthz`` and a
   ``/metrics`` that validates, the pools bit-identical around a probe;
   TTFT p50/p99, tokens/s, tick wall with and without a probe and the
   per-layer Jaccard/angular means reported; (c) the closed-loop load
   generator on the real clock over 8b's server: 6 chat sessions of at
   most 3 turns on 2 Zipf-shared 256-token system prompts, ``max_new`` at
   most 32 -- every session ends and the pool empties; goodput, shed
   rate, prefix hit rate, COW copies and TTFT p99 reported;
9. the paper's contiguous path: (a) phase 3's tinylm weights, fp32, every
   result equal to the same call on the CPU: ``GenerationEngine.generate``
   greedy tokens (dense, GRIFFIN 0.5 ``topk`` and ``blocks``, the int8
   cache), ``evaluate.generation_ppl`` and ``classification_sim`` for
   every deterministic method within ``EVAL_RTOL`` (``agree_full`` and
   ``acc`` exactly), and ``analysis.profile.derive_profile`` written to
   JSON and served by ``launch.serve.main --tier 0.5 --sparsity-profile``;
   ``expert_stat`` launched once per FF layer on every prefill with
   statistics and nothing else launched; (b) phase 4's Yi-9B model:
   ``GenerationEngine`` over 2 prompts of 512 tokens and 64 new tokens,
   dense and GRIFFIN 0.5 (prefill ms, selection ms, decode tokens/s, TPOT
   p50, peak memory, ``expert_stat`` launches per prefill -- 48 -- and
   the token agreement of the two, no floor: random weights), then
   ``generation_ppl`` at P=448, G=64 for full, griffin, magnitude and
   wanda (finite, wall time each); ``expert_stat`` at the engine's shape
   [2, 512, 11008] fp32 and bf16 against its plain version, the bf16 one
   timed beside its bound and the launch floor;
10. the MoE and MLA families: (a) the smoke Moonshot-v1-16B-A3B and
   DeepSeek-V3 configs (fp32, weights drawn on the CPU), every result
   equal to the same call on the CPU: ``GenerationEngine`` dense and
   GRIFFIN 0.5, a ``ContinuousBatcher`` of 2 slots over 4 requests of
   mixed lengths, and ``launch.serve.main`` through its slot-batcher
   fallback; (b) Moonshot-v1-16B-A3B at full width and depth (bf16,
   random weights from seed 0 drawn on the card after Yi-9B is freed):
   ``GenerationEngine`` over 2 prompts of 512 tokens and 32 new tokens,
   dense, GRIFFIN 0.5 and GRIFFIN 0.0 (equal to dense token for token;
   its compaction at k = F keeps every column in order), prefill ms,
   selection ms, TPOT p50, decode tokens/s, peak memory and 48
   ``expert_stat`` launches per GRIFFIN prefill; a ``ContinuousBatcher``
   of 2 slots over 4 requests of 200/350/480/600 prompt tokens and 16
   new tokens (tokens/s); (c) DeepSeek-V3 at full width, depth 4 (3
   dense MLA layers and one MoE layer of 256 experts, no MTP block): the
   same engine runs, 4 ``expert_stat`` launches per GRIFFIN prefill.
   Phase 2 adds ``expert_stat`` at [2, 512, F] bf16 for phase 10's
   widths F = 2816, 11264, 2048, 18432.

The second-to-last line is a JSON object listing the kernels (for
``paged_attn`` and ``paged_attn_quant`` the main fields are the Yi-9B
decode case; ``prefill_*`` and ``verify_*`` give the prefill chunk's and
the verify call's time and bound, and ``launches_decode`` /
``launches_prefill`` / ``launches_verify`` split the launches by kind;
``griffin_ffn`` adds ``pass_ms``, its passes' device times, and
``compacted_ms``, the compacted products' time; ``expert_stat`` adds
``engine_*``, its numbers at phase 9b's prompt shape, and ``moe_engine``,
its numbers at phase 10's widths); the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
outside a checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit): HBM,
# float32 outside the tensor cores, bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
FLOP_PER_S = {"float32": 67e12, "bfloat16": 989e12}

#: tolerances of the FF kernels against their plain versions: bf16 as the
#: reference's kernel tests (the plain version rounds g, h and z to bf16,
#: the kernel z only); fp32 sums of 4096 and 5504+ products in another
#: order at Yi-9B width
FF_TOL = {"bfloat16": 2e-2, "float32": 1e-4}

#: device kernels of one ``ops.glu_ffn_forward`` call: the up pass and the
#: cluster-merged down pass (``csrc/glu_ffn.cu``)
GLU_FFN_KERNELS = 2

#: device kernels of one ``ops.griffin_ffn_decode`` call: the same two
#: passes over the selected blocks (``csrc/griffin_ffn.cu``)
GRIFFIN_FFN_KERNELS = 2


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 25, flush=None, reset=None) -> float:
    """Median device milliseconds of ``fn`` (CUDA events around each call;
    ``reset``, if given, runs before each call, outside the events, to put
    back the state ``fn`` changes in place; ``flush`` is rewritten after it
    so L2 starts cold).  A GPU spin is queued ahead of each call so the
    host has enqueued all of ``fn``'s launches before the first one runs:
    the events then time the device work, not the host's Python dispatch."""
    if reset is not None:
        reset()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if reset is not None:
            reset()
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
                    W=None, in_dtype=None):
    """``lens`` tokens already cached per request, pages scattered over
    the pool, one row partly masked; ``W`` is the block table's width
    (the server's ``max_len // page``), default the widest request."""
    need = [-(-(n + S) // page) for n in lens]
    W = W or max(need)
    P = sum(need) + 8
    rnd = lambda *s: torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    # queries and new rows come in the model dtype: bf16 beside bf16 pools
    # (Yi-9B), fp32 beside fp32 pools (tinylm)
    in_dtype = in_dtype or pool_dtype
    q, kn, vn = (rnd(B, S, H, hd).to(in_dtype), rnd(B, S, KV, hd).to(in_dtype),
                 rnd(B, S, KV, hd).to(in_dtype))
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


#: the Yi-9B speculative verify call (spec_k 4, 2 slots): request 0's 5
#: rows cross a page boundary (589 cached: rows 589..593, page 16),
#: request 1 drafted k_r = 2, so its rows 3-4 are masked
VERIFY_LENS = [589, 431]


def verify_case(torch, dev, pool_dtype, in_dtype, shape):
    """The verify call's inputs, from a generator of their own (the other
    cases keep the draws they had before the verify cases existed).  One
    element of request 0's first new K and V row is 6 (the cached rows are
    N(0, 1)), so on quantized pools that page's scales grow."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    args = paged_attn_case(torch, gen, 2, 5, VERIFY_LENS, pool_dtype, dev,
                           in_dtype=in_dtype, **shape)
    args[1][0, 0, 0, 0] = args[2][0, 0, 0, 0] = 6.0
    args[7] = torch.ones((2, 5), dtype=torch.bool, device=dev)
    args[7][1, 3:] = False
    return args


def paged_attn_work(args, lens, scales=None):
    """(bytes, operations) the step must at least move and do: read the
    cached K/V rows, the queries, the new rows, the table, positions and
    mask once; write the context and the new rows that exist once.

    Quantized pools pass ``scales``: the K and V scale pools before the
    step and after the plain version's run of it.  The step then also
    reads the scale of every page it reads or writes, and where a (page,
    kv head)'s scale grew it re-encodes that page's rows: it reads the
    rows not already read as cached or written as new, writes every old
    row again and writes the new scale.  Where the scale did not grow the
    re-encode is the identity and moves nothing."""
    q, kn, vn, pk, pv, bt, pos, wm = args
    B, S, H, hd = q.shape
    KV = kn.shape[2]
    page = pk.shape[1]
    isz = pk.element_size()
    new = {}  # (request, page index) -> rows the step writes there
    for b in range(B):
        for s in range(S):
            if bool(wm[b, s]):
                j = (lens[b] + s) // page
                new[(b, j)] = new.get((b, j), 0) + 1
    moved = sum(new.values()) * KV * hd * 2 * isz           # new rows written
    if scales is not None:
        (sk0, sv0), (sk1, sv1) = scales
        pages = {(b, j) for b in range(B) for j in range(-(-lens[b] // page))}
        moved += len(pages | set(new)) * KV * 2 * 4         # scales read
        for (b, j), n in new.items():
            p = int(bt[b, j])
            cached = min(page, max(0, lens[b] - j * page))
            for s0, s1 in ((sk0, sk1), (sv0, sv1)):
                grown = int((s1[p, 0, :, 0] != s0[p, 0, :, 0]).sum())
                moved += grown * ((page - cached - n) * hd * isz  # stale rows read
                                  + (page - n) * hd * isz         # old rows rewritten
                                  + 4)                            # scale written
    byts = (sum(lens) * KV * hd * 2 * isz                   # cached K/V rows
            + (q.numel() + kn.numel() + vn.numel()) * q.element_size()
            + bt.numel() * 4 + pos.numel() * 4 + wm.numel()
            + B * S * H * hd * 4                            # ctx (fp32)
            + moved)
    # causal: query s of a request attends n + s + 1 keys; QK^T and PV
    flops = sum(4 * H * hd * (n + s + 1) for n in lens for s in range(S))
    return byts, flops


def fenced_device_events(torch, fn, tries: int = 3, complete=None):
    """The device events (kernels and copies) of one call of ``fn``, from
    ``torch.profiler``, in start order.

    CUPTI hands the profiler its device records asynchronously, and a
    trace may come back without some of them: on the H100 the first
    records after the profiler starts have been seen to go missing (one
    to a few hundred in a row), and nothing else.  So 256 short GPU spins
    (16 have been lost whole in eight traces running, before a
    DeepSeek-V3 decode step), finished before the call, go first to take
    that loss, and one more spin goes after it.  On the device timeline
    (one stream, so in launch order) the call's events are those between the last leading spin and
    the closing spin; the trace's own order is used, not the host clock,
    whose offset to the device clock a trace does not fix.  A trace that
    lost every leading spin (the loss may have reached the call), lacks
    the closing spin, holds no event of the call, or whose events
    ``complete`` rejects says nothing certain about ``fn`` and is taken
    again (``fn`` runs again), at most ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    names = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(256):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        names = [e.name for e in evs]
        spins = [i for i, n in enumerate(names) if "spin_kernel" in n]
        if len(spins) >= 2 and spins[-1] == len(evs) - 1:
            inner = evs[spins[-2] + 1 : -1]
            if inner and (complete is None or complete(inner)):
                return inner
    raise AssertionError(f"torch.profiler traces lacked the call's events "
                         f"{tries} times; the last one held {len(names)} "
                         f"events, ending {names[-4:]}")


def device_kernels(torch, fn, tries: int = 3):
    """Names of the device kernels (and copies) one call of ``fn`` runs,
    after a warm-up call (``fenced_device_events``)."""
    fn()
    torch.cuda.synchronize()
    return [e.name for e in fenced_device_events(torch, fn, tries)]


def kernel_times(torch, fn, flush, reps: int = 10):
    """Median device milliseconds of each device kernel one call of ``fn``
    runs, by its short name (``ffn_up``, ...), from ``torch.profiler``
    records of ``reps`` calls with L2 flushed before each (the flush's
    own kernel left out)."""
    import re

    names = device_kernels(torch, fn)

    def calls():
        for _ in range(reps):
            flush.zero_()
            fn()

    evs = fenced_device_events(torch, calls, complete=lambda evs: all(
        sum(e.name == n for e in evs) == reps * names.count(n) for n in names))
    short = lambda n: re.sub(r"^.*?(\w+)[<(].*$", r"\1", n)  # noqa: E731
    return {short(n): statistics.median(e.time_range.elapsed_us() / 1e3
                                        for e in evs if e.name == n)
            for n in dict.fromkeys(names)}


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
    # the launch floor: what an event pair reads around one tiny kernel,
    # against which sub-0.01 ms kernel times are read
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(torch, lambda: one.fill_(1.0), flush=flush)
    results["launch_floor_ms"] = floor_ms
    lines.append(f"launch floor (one-element fill_): {floor_ms:.4f} ms")
    yi = dict(H=32, KV=4, hd=128, page=16, W=640 // 16)  # max_len 640
    tiny = dict(H=6, KV=3, hd=32, page=8, W=8)  # page 8, max_len 64

    # -- paged_attn: decode (B=2, S=1), one prefill chunk (B=1) and a
    # speculative verify (B=2, S=5) ----------------------------------------
    worst = 0.0
    cases = [("yi-9b", "decode", 2, 1, [583, 431], dt, yi)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [("yi-9b", "prefill", 1, 32, [448], dt, yi)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [("yi-9b", "verify", 2, 5, VERIFY_LENS, dt, yi)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [("tinylm", "decode", 2, 1, [43, 28], torch.float32, tiny),
              ("tinylm", "prefill", 1, 16, [32], torch.float32, tiny)]
    for model, label, B, S, lens, pool_dtype, shape in cases:
        args = verify_case(torch, dev, pool_dtype, None, shape) if label == "verify" \
            else paged_attn_case(torch, gen, B, S, lens, pool_dtype, dev, **shape)
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
        dt = "bf16" if pool_dtype == torch.bfloat16 else "fp32"
        if model == "yi-9b" and label in ("decode", "verify"):
            names = device_kernels(torch, lambda: ops.paged_attention(*kern))
            check(len(names) == 1, f"{what}: one call ran {names}")
            lines.append(f"paged_attn {model} {label} pool={dt}: one call = "
                         f"{len(names)} device kernel")
        ms = time_ms(torch, lambda: ops.paged_attention(*kern), flush=flush)
        plain_ms = time_ms(torch, lambda: ref.paged_attn_ref(*plain), flush=flush)
        byts, flops = paged_attn_work(args, lens)
        b_ms, b_by = bound(byts, flops, str(pool_dtype).split(".")[-1])
        lines.append(f"paged_attn {model} {label:7s} pool={dt} B={B} S={S} "
                     f"ctx={lens}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                     f"bound {b_ms:.5f} ms ({b_by})  max_abs_err {err:.3g}")
        if model == "yi-9b" and dt == "bf16":
            kind = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        at=f"{label} B={B} S={S} ctx={lens} bf16 pool")
            if label == "decode":
                results["paged_attn"] = dict(kind, library_ms=None)
            else:
                results["paged_attn"][label] = kind
    results["paged_attn"]["max_abs_err"] = worst
    results["paged_attn_quant"] = phase_kernels_quant(torch, dev, flush, gen,
                                                      lines, yi, tiny)

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
        if model == "yi-9b":
            names = device_kernels(torch, lambda: ops.griffin_stat(z))
            check(len(names) == 1, f"expert_stat {model}: one call ran {names}")
            lines.append(f"expert_stat {model}: one call = {len(names)} device kernel")
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
    results.update(phase_kernels_ffn(torch, dev, flush, gen, lines))
    return results, lines


def warm_pool(torch, kv_quant, pool_f, kvd):
    """An fp32 pool quantized page by page through the plain scatter:
    every page holds live bits under a grown scale."""
    P1, page, KV, hd = pool_f.shape
    dev = pool_f.device
    zero = torch.zeros(pool_f.shape, device=dev,
                       dtype=kv_quant.pool_torch_dtype(kvd, "float32"))
    return kv_quant.quantize_scatter_ref(
        zero, torch.zeros((P1, 1, KV, 1), device=dev),
        torch.arange(P1, device=dev).repeat_interleave(page),
        torch.arange(page, device=dev).repeat(P1),
        pool_f.reshape(-1, KV, hd), kvd)


def phase_kernels_quant(torch, dev, flush, gen, lines, yi, tiny):
    """``paged_attn`` over int8 and fp8 pools at the shapes of the fp32/bf16
    cases, from warm pools: pools and scales bit-identical to the plain
    version except the trash page, ctx within 1e-5 of it and within
    ``ERROR_BUDGET`` of the fp32-pool plain version."""
    from repro_torch.kernels import kv_quant, ops, ref

    out, worst = None, 0.0
    cases = [("yi-9b", "decode", 2, 1, [583, 431], torch.bfloat16, yi),
             ("yi-9b", "prefill", 1, 32, [448], torch.bfloat16, yi),
             ("yi-9b", "verify", 2, 5, VERIFY_LENS, torch.bfloat16, yi),
             ("tinylm", "decode", 2, 1, [43, 28], torch.float32, tiny),
             ("tinylm", "prefill", 1, 16, [32], torch.float32, tiny)]
    for kvd in ("int8", "fp8"):
        for model, label, B, S, lens, in_dtype, shape in cases:
            args = verify_case(torch, dev, torch.float32, in_dtype, shape) \
                if label == "verify" else paged_attn_case(
                    torch, gen, B, S, lens, torch.float32, dev,
                    in_dtype=in_dtype, **shape)
            q, kn, vn, pkf, pvf, bt, pos, wm = args
            (pk, sk), (pv, sv) = (warm_pool(torch, kv_quant, p, kvd)
                                  for p in (pkf, pvf))
            base = [q, kn, vn, pk, pv, bt, pos, wm]
            kern = [a.clone() for a in base] + [sk.clone(), sv.clone()]
            plain = [a.clone() for a in base] + [sk.clone(), sv.clone()]

            def call(fn, a):
                return fn(*a[:8], scale_k=a[8], scale_v=a[9], kv_dtype=kvd)

            out_k = call(ops.paged_attention, kern)
            out_r = call(ref.paged_attn_ref, plain)
            ctx_f = ref.paged_attn_ref(q, kn, vn, pkf.clone(), pvf.clone(), bt,
                                       pos, wm)[0]
            torch.cuda.synchronize()
            what = f"paged_attn {model} {label} {kvd}"
            err = (out_k[0] - out_r[0]).abs().max().item()
            check(torch.allclose(out_k[0], out_r[0], rtol=1e-5, atol=1e-5),
                  f"{what}: ctx max err {err}")
            for i, (a, b) in enumerate(zip(out_k[1:], out_r[1:])):
                check(torch.equal(kv_quant.as_bytes(a)[:-1],
                                  kv_quant.as_bytes(b)[:-1]),
                      f"{what}: {('pool_k', 'pool_v', 'scale_k', 'scale_v')[i]} differs")
            if label == "verify":  # the new rows grew some page's scale
                check(bool((out_r[3][:-1] > sk[:-1]).any()
                           or (out_r[4][:-1] > sv[:-1]).any()),
                      f"{what}: no page scale grew")
            q_err = (out_k[0] - ctx_f).abs().max().item()
            check(q_err <= kv_quant.ERROR_BUDGET[kvd],
                  f"{what}: error {q_err} vs the fp32 pools over budget "
                  f"{kv_quant.ERROR_BUDGET[kvd]}")
            worst = max(worst, err)
            byts, flops = paged_attn_work(base, lens,
                                          ((sk, sv), (out_r[3], out_r[4])))

            def reset(a):  # back to the warm pools: each timed step does
                # the first step's work, scale growth included
                return lambda: [d.copy_(o) for d, o in
                                zip((a[3], a[4], a[8], a[9]), (pk, pv, sk, sv))]

            if model == "yi-9b" and label in ("decode", "verify"):
                names = device_kernels(torch, lambda: call(ops.paged_attention, kern))
                reset(kern)()
                check(len(names) == 1, f"{what}: one call ran {names}")
                lines.append(f"paged_attn {model} {label} pool={kvd}: one call = "
                             f"{len(names)} device kernel")

            ms = time_ms(torch, lambda: call(ops.paged_attention, kern),
                         flush=flush, reset=reset(kern))
            plain_ms = time_ms(torch, lambda: call(ref.paged_attn_ref, plain),
                               flush=flush, reset=reset(plain))
            b_ms, b_by = bound(byts, flops, str(in_dtype).split(".")[-1])
            lines.append(f"paged_attn {model} {label:7s} pool={kvd} B={B} S={S} "
                         f"ctx={lens}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                         f"bound {b_ms:.5f} ms ({b_by})  max_abs_err {err:.3g}  "
                         f"vs fp32 pools {q_err:.3g}")
            if model == "yi-9b" and kvd == "int8":
                kind = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by,
                            at=f"{label} B={B} S={S} ctx={lens} int8 pool, bf16 q")
                if label == "decode":
                    out = dict(kind, library_ms=None)
                else:
                    out[label] = kind
    out["max_abs_err"] = worst
    return out


def ffn_weights(torch, gen, dev, dtype, *shapes_scales):
    return [(torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)
            for shape, scale in shapes_scales]


def compacted_ffn(torch, x, wg, w1, w2, block_ids, act: str):
    """The server's decode FF on the selected blocks (``ffn_forward`` on
    ``compact_ffn_params``, three library products) over copies compacted
    once, here: weights [F, D] neuron rows, as ``griffin_ffn`` takes them."""
    from types import SimpleNamespace

    from repro_torch.models.layers import ffn as ffn_lib

    idx = (block_ids.long()[:, None] * 128
           + torch.arange(128, device=x.device)[None, :]).reshape(-1)
    p = ffn_lib.compact_ffn_params({"wg": wg.T, "w1": w1.T, "w2": w2}, idx)
    p = {k: v.contiguous() for k, v in p.items()}
    cfg = SimpleNamespace(activation=act)
    return lambda: ffn_lib.ffn_forward(p, x[None], cfg)


def phase_kernels_ffn(torch, dev, flush, gen, lines):
    """``griffin_ffn`` at Yi-9B decode width (D=4096, F=11008, 43 of 86
    blocks of 128, B=2) in bf16 and fp32 with swiglu, bf16 over all 86
    blocks (twice the bytes: beside the 43-block time it parts a pass's
    fixed cost from its streaming rate), geglu/reglu at a small shape;
    ``glu_ffn`` on a Yi-9B prefill chunk [32,4096] x [4096,11008] in bf16
    and fp32, geglu at a small ragged shape.
    Weights ~ N(0, 1/fan_in), so outputs are O(1) and the tolerances
    (``FF_TOL``, 1e-5 for fp32 at the small shapes) are relative to that."""
    from repro_torch.kernels import griffin_ffn, ops, ref

    # every pass fits the CTAs per SM that griffin_plan counts on
    fit = []
    for M in (2, 33):
        for dtype, tma in ((torch.float32, False), (torch.bfloat16, False),
                           (torch.bfloat16, True)):
            up, down = griffin_ffn.resident_ctas(M, dtype, tma)
            want = griffin_ffn.ctas_per_sm(M)
            what = f"griffin_ffn M={M} {str(dtype).split('.')[-1]} tma={int(tma)}"
            check(min(up, down) >= want,
                  f"{what}: {up}/{down} CTAs per SM resident, plan counts {want}")
            fit.append(f"{what} {up}/{down} (plan {want})")
    lines.append("griffin_ffn CTAs per SM resident, up/down: " + ", ".join(fit))
    results = {}
    worst = 0.0
    for D, F, nb, B, dtype, act in (
            (4096, 11008, 43, 2, torch.bfloat16, "swiglu"),
            (4096, 11008, 86, 2, torch.bfloat16, "swiglu"),  # twice the bytes
            (4096, 11008, 43, 2, torch.float32, "swiglu"),
            (256, 1024, 4, 4, torch.float32, "geglu"),
            (256, 1024, 4, 4, torch.bfloat16, "reglu")):
        n_sel = nb * 128
        x, wg, w1, w2 = ffn_weights(
            torch, gen, dev, dtype, ((B, D), 1.0), ((F, D), D ** -0.5),
            ((F, D), D ** -0.5), ((F, D), n_sel ** -0.5))
        ids = torch.sort(torch.randperm(F // 128, generator=gen, device=dev)[:nb]
                         ).values.to(torch.int32)
        run = lambda: ops.griffin_ffn_decode(x, wg, w1, w2, ids,  # noqa: E731
                                             activation=act)
        got = run()
        want = ref.griffin_ffn_ref(x, wg, w1, w2, ids, 128, activation=act)
        torch.cuda.synchronize()
        tname = str(dtype).split(".")[-1]
        tol = FF_TOL[tname] if (D >= 4096 or dtype == torch.bfloat16) else 1e-5
        err = (got - want).abs().max().item()
        what = f"griffin_ffn D={D} F={F} nb={nb} B={B} {tname} {act}"
        check(torch.allclose(got, want, rtol=tol, atol=tol), f"{what}: max err {err}")
        check(torch.equal(got, run()), f"{what}: not deterministic")
        worst = max(worst, err)
        main = D == 4096 and nb == 43 and dtype == torch.bfloat16
        if main:
            names = device_kernels(torch, run)
            check(len(names) == GRIFFIN_FFN_KERNELS, f"{what}: one call ran {names}")
            lines.append(f"{what}: one call = {len(names)} device kernels")
        ms = time_ms(torch, run, flush=flush)
        plain_ms = time_ms(torch, lambda: ref.griffin_ffn_ref(
            x, wg, w1, w2, ids, 128, activation=act), flush=flush)
        byts = (x.numel() * x.element_size() + 3 * n_sel * D * x.element_size()
                + ids.numel() * 4 + B * D * 4)
        b_ms, b_by = bound(byts, 6 * B * n_sel * D, tname)
        lines.append(f"{what}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                     f"bound {b_ms:.5f} ms ({b_by})  max_abs_err {err:.3g} (tol {tol})")
        if D == 4096:
            # the kernel's passes apart, and what the server's decode FF runs
            # today: three library products on compacted copies (made
            # outside the timing; a comparison, not a library call for the
            # zero-copy function)
            passes = kernel_times(torch, run, flush)
            comp = compacted_ffn(torch, x, wg, w1, w2, ids, act)
            comp_ms = time_ms(torch, comp, flush=flush)
            lines.append(f"{what}: device time by kernel " + "  ".join(
                f"{k} {v:.4f} ms" for k, v in passes.items())
                + f"  compacted products {comp_ms:.4f} ms")
        if main:
            results["griffin_ffn"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, pass_ms=passes, compacted_ms=comp_ms,
                at=f"x [{B},{D}] bf16, {nb} of {F // 128} blocks")
    results["griffin_ffn"]["max_abs_err"] = worst

    worst = 0.0
    for S, D, F, dtype, act in ((32, 4096, 11008, torch.bfloat16, "swiglu"),
                                (32, 4096, 11008, torch.float32, "swiglu"),
                                (5, 96, 1000, torch.float32, "geglu")):
        x, wg, w1, w2 = ffn_weights(
            torch, gen, dev, dtype, ((S, D), 1.0), ((D, F), D ** -0.5),
            ((D, F), D ** -0.5), ((F, D), F ** -0.5))
        run = lambda: ops.glu_ffn_forward(x, wg, w1, w2, activation=act)  # noqa: E731
        got = run()
        want = ref.glu_ffn_ref(x, wg, w1, w2, activation=act)
        torch.cuda.synchronize()
        tname = str(dtype).split(".")[-1]
        tol = FF_TOL[tname] if (D >= 4096 or dtype == torch.bfloat16) else 1e-5
        err = (got - want).abs().max().item()
        what = f"glu_ffn [{S},{D}]x[{D},{F}] {tname} {act}"
        check(torch.allclose(got, want, rtol=tol, atol=tol), f"{what}: max err {err}")
        check(torch.equal(got, run()), f"{what}: not deterministic")
        worst = max(worst, err)
        if D == 4096 and dtype == torch.bfloat16:
            names = device_kernels(torch, run)
            check(len(names) == GLU_FFN_KERNELS, f"{what}: one call ran {names}")
            lines.append(f"{what}: one call = {len(names)} device kernels")
        ms = time_ms(torch, run, flush=flush)
        plain_ms = time_ms(torch, lambda: ref.glu_ffn_ref(
            x, wg, w1, w2, activation=act), flush=flush)
        byts = x.numel() * x.element_size() + 3 * D * F * x.element_size() + S * D * 4
        b_ms, b_by = bound(byts, 6 * S * D * F, tname)
        lines.append(f"{what}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                     f"bound {b_ms:.5f} ms ({b_by})  max_abs_err {err:.3g} (tol {tol})")
        if D == 4096 and dtype == torch.bfloat16:
            results["glu_ffn"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, at=f"x [{S},{D}] bf16, F={F}")
    results["glu_ffn"]["max_abs_err"] = worst
    return results


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


#: kernel -> (module in repro_torch.kernels, its launch counter); the
#: attention kernels' speculative verify calls and other prefill calls
#: (S > 1) are also counted apart
COUNTERS = {"paged_attn": ("paged_attn", "launches"),
            "paged_attn_quant": ("paged_attn", "launches_quant"),
            "paged_attn_prefill": ("paged_attn", "prefill_launches"),
            "paged_attn_quant_prefill": ("paged_attn", "prefill_launches_quant"),
            "paged_attn_verify": ("paged_attn", "verify_launches"),
            "paged_attn_quant_verify": ("paged_attn", "verify_launches_quant"),
            "expert_stat": ("expert_stat", "launches"),
            "paged_gather": ("paged_gather", "launches"),
            "griffin_ffn": ("griffin_ffn", "launches"),
            "glu_ffn": ("glu_ffn", "launches")}


def _counter_module(name):
    import importlib

    return importlib.import_module(f"repro_torch.kernels.{COUNTERS[name][0]}")


def launches():
    return {k: getattr(_counter_module(k), attr) for k, (_, attr) in COUNTERS.items()}


def reset_launches() -> None:
    for k, (_, attr) in COUNTERS.items():
        setattr(_counter_module(k), attr, 0)


def attn_kinds(counts):
    """Attention launches by kind (both pool formats): decode, prefill,
    verify."""
    pre = counts["paged_attn_prefill"] + counts["paged_attn_quant_prefill"]
    ver = counts["paged_attn_verify"] + counts["paged_attn_quant_verify"]
    return dict(decode=counts["paged_attn"] + counts["paged_attn_quant"] - pre - ver,
                prefill=pre, verify=ver)


def serve(server, prompts):
    for i, (p, n) in enumerate(prompts):
        server.submit(p, n, rid=i)
    return server.drain()


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def tinylm_setup(np):
    """tinylm, its parameters (one draw on the CPU: generators on two
    devices draw differently; scaled so that greedy streams vary), the 4
    requests (two share a 16-token prefix) and the server's sizes."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder

    cfg = get_config("tinylm")
    rng = np.random.default_rng(3)
    shared = rng.integers(0, cfg.vocab_size, 16).astype(np.int32)
    prompts = [(np.concatenate([shared, rng.integers(0, cfg.vocab_size, n)
                                .astype(np.int32)]), 12) for n in (5, 14)]
    prompts += [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 12)
                for n in (11, 27)]
    kw = dict(page_size=8, num_pages=24, n_slots=2, prefill_chunk=16, max_len=64)
    host = decoder.init_params(cfg, seed=0, device="cpu")
    scale_matrices(host, 2.0)
    return cfg, host, prompts, kw


def phase_tinylm(torch, np, dev):
    """fused == gather == CPU plain token streams, with fp32, int8 and fp8
    pools; returns the launches summed over the card runs."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.serving.server import PagedServer

    cfg, host, prompts, kw = tinylm_setup(np)
    total, streams = {}, {}
    attn = {"fp32": "paged_attn", "int8": "paged_attn_quant",
            "fp8": "paged_attn_quant"}
    for kvd in ("fp32", "int8", "fp8"):
        outs, counts = {}, {}
        for device, backend in (("cuda", "fused"), ("cuda", "gather"),
                                ("cpu", "gather")):
            params = to_device(host, device)
            srv = PagedServer(cfg, params, gcfg=GriffinConfig(sparsity=0.5),
                              kernel_backend=backend, device=device,
                              kv_dtype=kvd, **kw)
            reset_launches()
            outs[(device, backend)] = serve(srv, prompts)
            counts[(device, backend)] = launches()
        fused, gather, cpu = outs[("cuda", "fused")], outs[("cuda", "gather")], \
            outs[("cpu", "gather")]
        check(fused == gather, f"tinylm {kvd}: fused {fused} != gather {gather}")
        check(fused == cpu, f"tinylm {kvd}: card {fused} != CPU plain versions {cpu}")
        check(len({t for s in fused.values() for t in s}) > 4,
              f"tinylm {kvd}: degenerate streams {fused}")
        cf, cg = counts[("cuda", "fused")], counts[("cuda", "gather")]
        other = "paged_attn_quant" if attn[kvd] == "paged_attn" else "paged_attn"
        check(cf[attn[kvd]] > 0 and cf["expert_stat"] > 0 and cf["paged_gather"] == 0
              and cf[other] == 0, f"tinylm {kvd} fused launches {cf}")
        check(cg["paged_gather"] > 0 and cg["expert_stat"] > 0
              and cg["paged_attn"] == cg["paged_attn_quant"] == 0,
              f"tinylm {kvd} gather launches {cg}")
        check(sum(counts[("cpu", "gather")].values()) == 0,
              f"tinylm {kvd}: CPU run launched a kernel")
        add_counts(total, cf)
        add_counts(total, cg)
        streams[kvd] = fused
    return total, streams


def record_margins(torch, np, srv):
    """Top-2 logit margin of every token a server commits through its
    ``_step_model`` (a dense or vanilla server), by request."""
    margins, last = {}, {}
    step_model = srv._step_model
    finish_decode = srv.sched.finish_decode_token
    finish_prefill = srv.sched.finish_prefill_chunk

    def margin(row):
        top = torch.topk(row.float(), 2).values
        return float(top[0] - top[1])

    def step(bt, toks, pos, mask, pruned, collect=False):
        out = step_model(bt, toks, pos, mask, pruned, collect)
        for slot in np.nonzero(mask.any(axis=1))[0]:
            last[int(slot)] = out[0][slot, int(mask[slot].sum()) - 1]
        return out

    def fin_decode(req, tok):
        margins.setdefault(req.rid, []).append(margin(last[req.slot]))
        return finish_decode(req, tok)

    def fin_prefill(work, first_token):
        if first_token is not None:
            margins.setdefault(work.req.rid, []).append(margin(last[0]))
        return finish_prefill(work, first_token)

    srv._step_model = step
    srv.sched.finish_decode_token = fin_decode
    srv.sched.finish_prefill_chunk = fin_prefill
    return margins


def phase_spec_tinylm(torch, np, dev):
    """Speculative serving on phase 3's tinylm and requests, fp32 pools
    (TF32 off), then int8, then fp8: ``spec_k=3`` fused on the card gives
    the same token streams as ``spec_impl="per_token"``, the ``gather``
    backend and the port on the CPU (plain versions), and with fp32 pools
    the same as the dense (``gcfg=None``) server.  With quantized pools a
    draft row may grow its page's scale, which the dense verify keeps, as
    in the reference's spec server (``tests/test_torch_spec.py`` holds the
    port's CPU streams to it), so the match with dense is reported.  On a
    mismatch the dense server's top-2 logit margin at the first differing
    token is printed before the phase fails.  Returns the launches summed
    over the card runs, and per pool format the fused run's speculative
    counters."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.serving.server import PagedServer

    cfg, host, prompts, kw = tinylm_setup(np)
    # name, device, backend, speculative, extra server arguments
    runs = (("fused", dev, "fused", True, {}),
            ("per_token", dev, "fused", True, {"spec_impl": "per_token"}),
            ("dense", dev, "fused", False, {}),
            ("gather", dev, "gather", True, {}),
            ("cpu", "cpu", "gather", True, {}))
    total, out = {}, {}
    for kvd in ("fp32", "int8", "fp8"):
        streams, counts, margins = {}, {}, {}
        for name, device, backend, spec, extra in runs:
            srv = PagedServer(cfg, to_device(host, device),
                              gcfg=GriffinConfig(sparsity=0.5) if spec else None,
                              kernel_backend=backend, device=device,
                              kv_dtype=kvd, spec_k=3 if spec else 0, **extra, **kw)
            if not spec:
                margins = record_margins(torch, np, srv)
            reset_launches()
            streams[name] = serve(srv, prompts)
            counts[name] = launches()
            m = srv.metrics.summary()
            check(m["spec_rounds"] > 0 if spec else m["spec_rounds"] == 0,
                  f"tinylm spec {kvd} {name}: {m['spec_rounds']} spec rounds")
            if name == "fused":
                out[kvd] = {k: m[k] for k in ("spec_rounds", "acceptance_rate",
                                              "tokens_per_verify")}
        # fp32: every run commits the dense stream.  Quantized, a draft
        # row can grow its page's scale, which the dense verify keeps (as
        # the reference's spec server does), so the spec runs are held to
        # each other and to the CPU, and their match with dense reported
        want = streams["dense"] if kvd == "fp32" else streams["cpu"]
        for name, got in streams.items():
            if name == "dense" and kvd != "fp32":
                continue
            for rid in want:
                if got[rid] != want[rid]:
                    i = next(i for i, (a, b) in enumerate(zip(got[rid], want[rid]))
                             if a != b)
                    raise AssertionError(
                        f"tinylm spec {kvd}: {name} rid {rid} {got[rid]} != "
                        f"{want[rid]} at token {i}; dense top-2 logit margin "
                        f"there {margins[rid][i]:.3g}")
        dense = streams["dense"]
        out[kvd]["token_match_vs_dense"] = match_rate(streams["fused"], dense)
        check(len({t for s_ in dense.values() for t in s_}) > 4,
              f"tinylm spec {kvd}: degenerate streams {dense}")
        kinds = {n: attn_kinds(c) for n, c in counts.items()}
        check(kinds["fused"]["verify"] > 0 and kinds["per_token"]["verify"] > 0
              and kinds["dense"]["verify"] == 0 and counts["fused"]["paged_gather"] == 0,
              f"tinylm spec {kvd} launches {counts}")
        check(counts["gather"]["paged_gather"] > 0
              and sum(kinds["gather"].values()) == 0,
              f"tinylm spec {kvd} gather launches {counts['gather']}")
        check(sum(counts["cpu"].values()) == 0,
              f"tinylm spec {kvd}: CPU run launched a kernel")
        for name in ("fused", "per_token", "dense", "gather"):
            add_counts(total, counts[name])
        out[kvd]["rid0"] = dense[0]
    return total, out


YI_PROMPT_LENS = (200, 350, 480, 600)


def yi9b_model(torch, np, dev):
    """Yi-9B at full width and depth, bf16, random weights from seed 0,
    and the 4 requests phases 4 and 5 serve."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder

    cfg = get_config("yi-9b")  # full width and depth, no cut
    t0 = time.perf_counter()
    params = decoder.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    n_params = sum(v.numel() for lp in params["layers"] for g in lp.values()
                   for v in g.values()) + params["embed"]["table"].numel() \
        + params["head"]["w"].numel()
    rng = np.random.default_rng(1)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 32)
               for n in YI_PROMPT_LENS]
    return cfg, params, prompts, dict(layers=cfg.num_layers, params=n_params,
                                      init_s=t_init)


def serve_yi9b(torch, np, dev, cfg, params, prompts, kv_dtype: str,
               profile: bool = False, griffin: bool = True, spec_k: int = 0):
    """``PagedServer`` (GRIFFIN 0.5, or dense with ``griffin=False``;
    speculative rounds of up to ``spec_k`` drafts, fused and adaptive, when
    ``spec_k`` is set; ``kernel_backend="auto"``) over the 4 requests;
    returns the numbers and the full token streams.  Every logit the
    server reads must be finite.  Each tick is timed on the host clock up
    to a ``synchronize``: the median decode tick (no prefill chunk, a
    one-token decode) and spec round (no prefill chunk, a verify) are
    reported.  The server is dropped before returning."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.serving.server import PagedServer

    what = f"yi-9b {kv_dtype}" + (" dense" if not griffin else "") \
        + (f" spec_k={spec_k}" if spec_k else "")
    torch.cuda.reset_peak_memory_stats()
    srv = PagedServer(cfg, params,
                      gcfg=GriffinConfig(sparsity=0.5) if griffin else None,
                      page_size=16, num_pages=256, n_slots=2, prefill_chunk=32,
                      max_len=640, kernel_backend="auto", device=dev,
                      kv_dtype=kv_dtype, spec_k=spec_k)
    check(srv.backend == "fused", f"auto resolved to {srv.backend}")
    step_model, draft_verify = srv._step_model, srv._draft_verify

    def checked(*a, **k):
        out = step_model(*a, **k)
        check(bool(torch.isfinite(out[0]).all()), f"{what}: non-finite logits")
        return out

    def checked_round(*a, **k):
        drafts, vlogits = draft_verify(*a, **k)
        check(bool(torch.isfinite(vlogits).all()),
              f"{what}: non-finite verify logits")
        return drafts, vlogits

    srv._step_model, srv._draft_verify = checked, checked_round
    for i, (p, n) in enumerate(prompts):
        srv.submit(p, n, rid=i)
    reset_launches()
    ticks = []
    t0 = time.perf_counter()
    while True:
        before = launches()
        t_tick = time.perf_counter()
        more = srv.step()
        torch.cuda.synchronize()
        t_tick = time.perf_counter() - t_tick
        after = launches()
        ticks.append(({k: after[k] - before[k] for k in after}, t_tick))
        if not more:
            break
    wall = time.perf_counter() - t0
    counts = launches()
    out = {rid: r.generated for rid, r in srv.sched.finished.items()}
    check(sorted(out) == [0, 1, 2, 3], f"{what} finished {sorted(out)}")
    for rid, toks in out.items():
        check(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
              f"{what} rid {rid}: {toks}")
    attn = "paged_attn_quant" if kv_dtype in ("int8", "fp8") else "paged_attn"
    kinds = attn_kinds(counts)
    check(counts[attn] > 0 and (counts["expert_stat"] > 0) == griffin
          and (kinds["verify"] > 0) == bool(spec_k), f"{what} launches {counts}")
    tick_kinds = [(attn_kinds(t), w) for t, w in ticks]
    decode_ticks = [(k, w) for k, w in tick_kinds
                    if k["decode"] and not k["prefill"] and not k["verify"]]
    spec_ticks = [w for k, w in tick_kinds if k["verify"] and not k["prefill"]]
    m = srv.metrics.summary()
    res = dict(
        kv_dtype=kv_dtype, pool_dtype=str(srv.pools[0]["k"].dtype), wall_s=wall,
        tokens_per_s=m["tokens_per_sec"], ttft_p50_s=m["ttft_p50_s"],
        tpot_p50_s=m["tpot_p50_s"], steps=m["steps"],
        prefill_chunks=m["prefill_chunks"], preemptions=m["preemptions"],
        attn_bytes_per_token=m["attn_bytes_per_token"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts, attn_launches_by_kind=kinds,
        attn_calls_per_decode_tick=min((k["decode"] for k, _ in decode_ticks),
                                       default=0),
        decode_ticks=len(decode_ticks),
        decode_tick_wall_ms_p50=statistics.median(w for _, w in decode_ticks) * 1e3
        if decode_ticks else None,
        generated={rid: toks[:8] for rid, toks in out.items()},
    )
    if spec_k:
        res.update({k: m[k] for k in ("spec_rounds", "acceptance_rate",
                                      "tokens_per_verify", "draft_k_mean",
                                      "spec_capped_rounds")})
        res.update(spec_round_ticks=len(spec_ticks),
                   spec_round_wall_ms_p50=statistics.median(spec_ticks) * 1e3
                   if spec_ticks else None,
                   sync_free_round=sync_free_round(torch, cfg, params, srv))
    if profile:
        res["decode_tick_profile"] = profile_decode_tick(
            torch, np, srv, cfg, np.random.default_rng(2))
    del srv, step_model, draft_verify
    torch.cuda.empty_cache()
    return res, out


def sync_free_round(torch, cfg, params, srv):
    """One ``decoder.draft_verify_paged`` call at the served shape (2
    slots, ``spec_k`` drafts, contexts 500 and 300 over a 40-page table,
    the server's compacted slot weights) under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
    sync: the fused round has none between its first draft step and its
    verify logits.  Inputs are made on the card before; the server's pools
    take the writes (it has drained)."""
    from repro_torch.models import decoder

    dev, W, K = srv.device, srv.pcfg.max_pages_per_request, srv.spec_k
    bt = torch.arange(2 * W, dtype=torch.int32, device=dev).reshape(2, W)
    tok = torch.zeros((2, 1), dtype=torch.int32, device=dev)
    pos = torch.tensor([500, 300], dtype=torch.int32, device=dev)
    k_r = torch.tensor([K, K // 2], dtype=torch.int32, device=dev)
    live = torch.ones(2, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        drafts, vlogits, _ = decoder.draft_verify_paged(
            params, cfg, srv.pools, bt, tok, pos, k_r, live, srv.pruned_slots,
            num_steps=K, spec_k=K, backend=srv.backend, kv_dtype=srv.kv_dtype)
        enqueue_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    check(tuple(vlogits.shape) == (2, K + 1, cfg.vocab_size)
          and bool(torch.isfinite(vlogits).all()), "sync-free round: bad logits")
    return dict(enqueue_ms=enqueue_s * 1e3,
                drafts=drafts.tolist())


def match_rate(a, b) -> float:
    """Share of positions where two sets of token streams agree."""
    same = total = 0
    for rid in a:
        same += sum(x == y for x, y in zip(a[rid], b[rid]))
        total += max(len(a[rid]), len(b[rid]))
    return same / total


def phase_ffn_entry_points(torch, dev, cfg, params):
    """The FF kernels through their entry points on every FF block of the
    served model: per layer, ``ops.glu_ffn_forward`` on a 32-token chunk
    against the dense ``ffn_forward``, then the chunk's statistic ->
    ``select_block_ids`` (half the blocks) -> ``ops.griffin_ffn_decode``
    on two decode rows against the compacted ``ffn_forward``.  The pruned
    kernel reads neuron rows, so each layer's Wg/W1 are laid out [F, D]
    first (a one-time copy per layer, not timed).  Returns the launches
    and the worst errors."""
    from repro_torch.core.selector import select_block_ids, select_blocks
    from repro_torch.kernels import ops
    from repro_torch.models.layers import ffn as ffn_lib

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    F = cfg.d_ff
    tol = FF_TOL[cfg.dtype]
    err_glu = err_grf = 0.0
    reset_launches()
    for li, lp in enumerate(params["layers"]):
        p = lp["ffn"]
        x = torch.randn(32, cfg.d_model, generator=gen, device=dev).to(p["w1"].dtype)
        y = ops.glu_ffn_forward(x, p["wg"], p["w1"], p["w2"], activation=cfg.activation)
        y_ref, st = ffn_lib.ffn_forward(p, x[None], cfg, collect_stats=True)
        e = (y - y_ref[0].float()).abs().max().item()
        check(torch.allclose(y, y_ref[0].float(), rtol=tol, atol=tol),
              f"glu_ffn layer {li}: max err {e}")
        err_glu = max(err_glu, e)
        s = st["s_sq"].sum(0).sqrt()
        bids = select_block_ids(s, F // 2, 128)
        idx = select_blocks(s, F // 2, 128)
        wg_rows, w1_rows = p["wg"].T.contiguous(), p["w1"].T.contiguous()
        xd = torch.randn(2, cfg.d_model, generator=gen, device=dev).to(x.dtype)
        y = ops.griffin_ffn_decode(xd, wg_rows, w1_rows, p["w2"], bids,
                                   activation=cfg.activation)
        y_ref, _ = ffn_lib.ffn_forward(ffn_lib.compact_ffn_params(p, idx),
                                       xd[None], cfg)
        e = (y - y_ref[0].float()).abs().max().item()
        check(torch.allclose(y, y_ref[0].float(), rtol=tol, atol=tol),
              f"griffin_ffn layer {li}: max err {e}")
        err_grf = max(err_grf, e)
        del wg_rows, w1_rows
    torch.cuda.synchronize()
    counts = launches()
    n = len(params["layers"])
    check(counts["glu_ffn"] == n and counts["griffin_ffn"] == n,
          f"FF entry points launches {counts}")
    return counts, dict(glu_ffn_max_err=err_glu, griffin_ffn_max_err=err_grf,
                        blocks=F // 128 // 2, of_blocks=F // 128)


def profile_decode_tick(torch, np, srv, cfg, rng):
    """Device time by kernel over decode ticks (speculative rounds on a
    spec server) of two fresh requests (``torch.profiler``), after their
    prefill and first decode.  The ticks are fenced as ``device_kernels``
    fences a call, and taken again (the next 4 ticks) when a trace lacks
    the call's events or a record of any attention launch; the requests
    generate enough tokens for three tries."""
    n_ticks, tries = 4, 3
    per_tick = srv.spec_k + 1  # most tokens a tick commits
    for i, n in enumerate((583, 431)):
        srv.submit(rng.integers(0, cfg.vocab_size, n).astype(np.int32),
                   min(2 + n_ticks * tries * per_tick + 2,
                       srv.pcfg.max_request_len - n), rid=100 + i)
    sched = srv.sched
    while sched.queue or sched.prefilling is not None \
            or not all(len(r.generated) >= 2 for r in sched.decoding):
        srv.step()
    torch.cuda.synchronize()
    walls, attn_calls = [], []

    def ticks():
        before = launches()
        t0 = time.perf_counter()
        for _ in range(n_ticks):
            srv.step()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        after = launches()
        kinds = attn_kinds({k: after[k] - before[k] for k in after})
        attn_calls.append(kinds["decode"] + kinds["verify"])

    # a trace is complete when it holds a record of every attention launch
    # the ticks counted
    evs = fenced_device_events(
        torch, ticks, tries, complete=lambda evs: attn_calls[-1] == sum(
            "paged_attn_kernel" in e.name for e in evs))
    wall = walls[-1]
    by_name = {}
    for e in evs:
        ms, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    rows = [(k, ms / n_ticks, count // n_ticks) for k, (ms, count) in by_name.items()]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    attn = [r for r in rows if "paged_attn" in r[0] or "kv_quant_scatter" in r[0]]
    srv.drain()
    return dict(tick_wall_ms=wall / n_ticks * 1e3, device_busy_ms=busy,
                attention_ms=sum(r[1] for r in attn),
                attention=[dict(kernel=k[:90], ms=ms, per_tick=c) for k, ms, c in attn],
                top=[dict(kernel=k[:90], ms=ms, per_tick=c) for k, ms, c in rows[:12]])


# ---------------------------------------------------------------------------
# phase 8: the serving edge (launcher, HTTP/SSE frontend, load generator)
# ---------------------------------------------------------------------------

def launcher(argv):
    """``repro_torch.launch.serve.main(argv)`` with its printed lines
    captured: (drained streams, text)."""
    import contextlib
    import io

    from repro_torch.launch import serve as serve_lib

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = serve_lib.main(argv)
    return out, buf.getvalue()


def phase_launcher(torch, np, tmp: Path):
    """8a: phase 3's tinylm weights, written as a checkpoint in the
    reference's layout, served through ``launch.serve.main`` on the card
    and with ``--device cpu``: GRIFFIN 0.5 with int8 pools, ``--spec-k 3``,
    a trace, a metrics snapshot and flocking telemetry every 2 ticks; the
    dense model on the gather backend; ``--tier 0.5``.  Card streams must
    equal the CPU's, the trace must validate, the snapshot parse and
    ``flocking:`` be printed.  Returns the card runs' launches and a
    summary line per run."""
    from repro_torch import bridge
    from repro_torch.checkpoint import checkpointer
    from repro_torch.obs.export import validate_chrome_trace

    cfg, host, _, _ = tinylm_setup(np)
    ckpt = tmp / "ckpt"
    checkpointer.save(str(ckpt), 1, {"params": bridge.params_to_jax(host, cfg)})
    trace, snap = tmp / "trace.json", tmp / "metrics.json"
    base = ["--arch", "tinylm", "--requests", "8", "--ckpt-dir", str(ckpt)]
    runs = {"griffin_int8_spec3_obs": ["--kv-dtype", "int8", "--spec-k", "3",
                                       "--trace-out", str(trace),
                                       "--metrics-snapshot", str(snap),
                                       "--flocking-telemetry", "2"],
            "dense_gather": ["--no-griffin", "--kernel-backend", "gather"],
            "tier_0.5": ["--tier", "0.5"]}
    total, lines = {}, {}
    for name, flags in runs.items():
        reset_launches()
        card, text = launcher(base + flags + ["--device", "cuda"])
        counts = launches()
        check("[ckpt] loaded" in text and "[device] cuda" in text,
              f"launcher {name}: {text}")
        if "--trace-out" in flags:
            check("  flocking: jaccard=" in text, f"launcher {name}: {text}")
            errors = validate_chrome_trace(json.loads(trace.read_text()))
            check(not errors, f"launcher {name}: trace errors {errors[:3]}")
            check(json.loads(snap.read_text())["summary"]["requests_finished"] == 8,
                  f"launcher {name}: snapshot {snap.read_text()[:200]}")
        cpu, _ = launcher(base + flags + ["--device", "cpu"])
        check(card == cpu, f"launcher {name}: card {card} != CPU {cpu}")
        check(len({t for s_ in card.values() for t in s_}) > 4,
              f"launcher {name}: degenerate streams {card}")
        kinds = attn_kinds(counts)
        if name == "dense_gather":
            ok = counts["paged_gather"] > 0 and counts["expert_stat"] == 0 \
                and sum(kinds.values()) == 0
        else:
            ok = counts["expert_stat"] > 0 and kinds["decode"] > 0 \
                and counts["paged_gather"] == 0 \
                and (kinds["verify"] > 0) == ("--spec-k" in flags) \
                and (counts["paged_attn_quant"] > 0) == ("int8" in flags)
        check(ok, f"launcher {name} launches {counts}")
        add_counts(total, counts)
        lines[name] = [ln.strip() for ln in text.splitlines()
                       if "paged: served" in ln or "flocking:" in ln
                       or "spec:" in ln]
    return total, lines


#: phases 4, 7b and 8's Yi-9B server
YI_SERVER = dict(page_size=16, num_pages=256, n_slots=2, prefill_chunk=32,
                 max_len=640, kernel_backend="auto")

#: TTFT deadline (s) of phase 8b's requests: at ~60 ms a tick, a 600-token
#: prompt takes ~19 chunks, so the class defaults would shed
FRONTEND_DEADLINE_S = 60.0


def parse_sse(raw: bytes):
    """HTTP response -> (status line, [(event or None, data), ...])."""
    head, _, body = raw.partition(b"\r\n\r\n")
    status = head.split(b"\r\n")[0].decode()
    frames = []
    for chunk in body.decode().split("\n\n"):
        if not chunk.strip():
            continue
        event, data = None, None
        for line in chunk.splitlines():
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
        frames.append((event, data))
    return status, frames


def http_post(path: str, obj) -> bytes:
    body = json.dumps(obj).encode()
    return (f"POST {path} HTTP/1.1\r\nContent-Length: {len(body)}\r\n"
            f"\r\n").encode() + body


async def http_call(asyncio, port: int, raw: bytes, cut: int = 0) -> bytes:
    """One request over a socket; reads to EOF, or hangs up after ``cut``
    SSE token frames."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(raw)
    await writer.drain()
    data = bytearray()
    while True:
        chunk = await reader.read(65536)
        if not chunk:
            break
        data += chunk
        if cut and data.count(b'data: {"token"') >= cut:
            break
    writer.close()
    try:
        await writer.wait_closed()
    except ConnectionError:
        pass
    return bytes(data)


def owners(alloc):
    """Request ids that still hold pages (prefix-cache holders excluded)."""
    return sorted(o for o in alloc.holders_snapshot() if isinstance(o, int))


def phase_frontend(torch, np, dev, cfg, params, prompts):
    """8b: Yi-9B (phase 4's model) behind ``ServingFrontend`` and
    ``asyncio.start_server`` on a free 127.0.0.1 port, flocking telemetry
    every 4 ticks: 4 ``POST /v1/generate`` requests (phase 4's prompts,
    32 new tokens, two ``interactive`` and two ``batch``) and one more
    whose client hangs up after 4 tokens, concurrently, plus ``/healthz``
    and ``/metrics``.  Checks: the hung-up request is ``cancelled`` and
    holds no page; ``/metrics`` validates; the pools are bit-identical
    around the first probe that probes a request.  Returns the server,
    its frontend (stopped), the SSE streams by prompt index and the numbers; the
    streams are held to a fresh server's ``drain()`` by the caller."""
    import asyncio

    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.kernels import kv_quant
    from repro_torch.obs.registry import validate_prometheus_text
    from repro_torch.serving.frontend import CANCELLED, FINISHED, ServingFrontend
    from repro_torch.serving.server import PagedServer

    srv = PagedServer(cfg, params, gcfg=GriffinConfig(sparsity=0.5),
                      flocking_every=4, device=dev, **YI_SERVER)
    check(srv.backend == "fused", f"auto resolved to {srv.backend}")
    fe = ServingFrontend(srv)
    step, probe = srv.step, srv._run_flocking_probe
    ticks, state = [], {"probe": False, "pools_identical": None}

    def timed_step():
        state["probe"] = False
        t0 = time.perf_counter()
        more = step()
        torch.cuda.synchronize()
        ticks.append((time.perf_counter() - t0, state["probe"]))
        return more

    def timed_probe(reqs):
        t0 = time.perf_counter()
        probe(reqs)
        torch.cuda.synchronize()
        probe_ms.append((time.perf_counter() - t0) * 1e3)

    def checked_probe(reqs):
        state["probe"] = True
        live = any(r.compacted and r.generated for r in reqs)
        if not live or state["pools_identical"] is not None:
            return timed_probe(reqs)
        before = [{k: kv_quant.as_bytes(v).clone() for k, v in pool.items()}
                  for pool in srv.pools]
        timed_probe(reqs)
        state["pools_identical"] = all(
            torch.equal(b[k], kv_quant.as_bytes(pool[k]))
            for b, pool in zip(before, srv.pools) for k in b)
        del before

    # the monitor's share of a probe: the statistics' copy to the host and
    # the Jaccard / angular arithmetic, after the probe step has finished
    probe_ms, monitor_ms = [], []
    on_probe = srv.flocking.on_probe

    def timed_on_probe(rows, stats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = on_probe(rows, stats)
        monitor_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    srv.step, srv._run_flocking_probe = timed_step, checked_probe
    srv.flocking.on_probe = timed_on_probe
    slos = ("interactive", "batch", "interactive", "batch")
    bodies = [http_post("/v1/generate", {
        "prompt": p.tolist(), "max_new": n, "slo": slo,
        "deadline_s": FRONTEND_DEADLINE_S}) for (p, n), slo in zip(prompts, slos)]
    cut_prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, 64)
    cut_body = http_post("/v1/generate", {
        "prompt": cut_prompt.tolist(), "max_new": 32, "slo": "standard",
        "deadline_s": FRONTEND_DEADLINE_S})

    async def run():
        server = await asyncio.start_server(fe.handle_connection, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        runner = asyncio.ensure_future(fe.run())
        try:
            health = await http_call(asyncio, port, b"GET /healthz HTTP/1.1\r\n\r\n")
            outs = await asyncio.gather(
                *(http_call(asyncio, port, b) for b in bodies),
                http_call(asyncio, port, cut_body, cut=4))
            t_end = time.perf_counter() + 60
            while fe.has_work and time.perf_counter() < t_end:
                await asyncio.sleep(0.01)  # the hang-up lands at a tick
            metrics = await http_call(asyncio, port, b"GET /metrics HTTP/1.1\r\n\r\n")
        finally:
            fe.stop()
            await runner
            server.close()
            await server.wait_closed()
        return health, outs, metrics

    t0 = time.perf_counter()
    health, outs, metrics = asyncio.run(run())
    wall = time.perf_counter() - t0
    srv.step, srv._run_flocking_probe = step, probe
    srv.flocking.on_probe = on_probe
    check(health.startswith(b"HTTP/1.1 200") and b'"ok": true' in health,
          f"/healthz: {health[:200]}")
    streams, rid_of = {}, {}
    for i, raw in enumerate(outs[:4]):
        status, frames = parse_sse(raw)
        check(status == "HTTP/1.1 200 OK" and frames[0][0] == "accepted"
              and frames[-1][0] == "done", f"SSE {i}: {raw[:300]}")
        rid_of[i] = frames[0][1]["rid"]
        streams[i] = [d["token"] for _, d in frames[1:-1]]
        check(fe.handles[rid_of[i]].state == FINISHED, f"SSE {i} not finished")
    _, cut_frames = parse_sse(outs[4])
    cut = fe.handles[cut_frames[0][1]["rid"]]
    check(cut.state == CANCELLED and 4 <= len(cut.tokens) < 32,
          f"hung-up request: {cut.state}, {len(cut.tokens)} tokens")
    check(srv.metrics.cancelled_aborts == 1, "cancel not counted")
    srv.sched.alloc.check()
    check(owners(srv.sched.alloc) == [], f"pages held: {owners(srv.sched.alloc)}")
    check(metrics.startswith(b"HTTP/1.1 200"), f"/metrics: {metrics[:200]}")
    errors = validate_prometheus_text(metrics.partition(b"\r\n\r\n")[2].decode())
    check(not errors, f"/metrics: {errors[:3]}")
    check(state["pools_identical"] is True,
          f"pools around a probe: {state['pools_identical']}")
    m, s = srv.metrics.summary(), fe.summary()
    gauges = {}
    for g in srv.metrics.registry:
        if g.name in ("flocking_jaccard", "flocking_angular"):
            gauges.setdefault(g.name, []).append(g.value)
    check(len(gauges.get("flocking_jaccard", [])) == cfg.num_layers,
          f"flocking gauges {len(gauges.get('flocking_jaccard', []))}")
    plain = [w for w, p in ticks if not p]
    probed = [w for w, p in ticks if p]
    res = dict(
        wall_s=wall, ttft_p50_s=s["ttft_p50_s"], ttft_p99_s=s["ttft_p99_s"],
        tokens_per_s=m["tokens_per_sec"], completed=s["completed"],
        cancelled=s["cancelled"], cancel_latency_mean_s=m["cancel_latency_mean_s"],
        ticks=len(ticks), probe_ticks=len(probed),
        tick_wall_ms_p50=statistics.median(plain) * 1e3,
        probe_tick_wall_ms_p50=statistics.median(probed) * 1e3,
        probe_ms_p50=statistics.median(probe_ms),
        probe_monitor_ms_p50=statistics.median(monitor_ms),
        flocking_probes=srv.flocking.probes.value,
        jaccard_layer_mean=float(np.mean(gauges["flocking_jaccard"])),
        angular_layer_mean=float(np.mean(gauges["flocking_angular"])),
        pools_identical_around_probe=state["pools_identical"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    return srv, fe, streams, res


def phase_loadgen(torch, np, srv, fe, cfg):
    """8c: the closed-loop load generator on the real clock over 8b's
    frontend and server (prefix cache kept; the engine's prefix and COW
    counters are read as differences over the run): 6 chat
    sessions of at most 3 turns, 2 Zipf-shared system prompts of 256
    tokens, ``max_new`` capped at 32, TTFT deadlines 5 s (interactive) and
    10 s (standard).  Checks: every session ends, no request holds a page
    afterwards, and with the prefix cache flushed the pool is empty."""
    from repro_torch.serving.loadgen import chat_sessions, run_closed_loop

    m0 = srv.metrics
    before = (m0.prefix_lookups, m0.prefix_hits, m0.saved_prefill_tokens,
              m0.cow_copies, m0.preemptions)
    sessions = chat_sessions(6, rate=4.0, seed=0, vocab=cfg.vocab_size,
                             n_system=2, system_len=256, max_turns=3,
                             gen_cap=32, deadlines={"interactive": 5.0,
                                                    "standard": 10.0})
    t0 = time.perf_counter()
    res = run_closed_loop(fe, sessions, clock=fe.clock)
    wall = time.perf_counter() - t0
    check(all(h.done for h in fe.handles.values()), "a turn never ended")
    last = {}
    for t in res.turns:
        last[t.sid] = t
    ended = sum(1 for sc in sessions if sc.sid in last and (
        last[sc.sid].state != "finished"
        or last[sc.sid].turn == len(sc.turns) - 1))
    check(ended + res.truncated_sessions == len(sessions),
          f"sessions ended {ended} + truncated {res.truncated_sessions}")
    srv.sched.alloc.check()
    check(owners(srv.sched.alloc) == [], f"pages held: {owners(srv.sched.alloc)}")
    srv.sched.flush_prefix()
    check(srv.sched.alloc.num_in_use == 0,
          f"{srv.sched.alloc.num_in_use} pages in use after the flush")
    m, s = srv.metrics, res.summary()
    lookups, hits, saved, cow, pre = (
        a - b for a, b in zip((m.prefix_lookups, m.prefix_hits,
                               m.saved_prefill_tokens, m.cow_copies,
                               m.preemptions), before))
    return dict(wall_s=wall, turns=s["turns"], finished=s["finished"],
                goodput_tokens_per_s=s["goodput_tokens_per_sec"],
                shed_rate=s["shed_rate"], slo_met_rate=s["slo_met_rate"],
                ttft_p50_s=s["ttft_p50_s"], ttft_p99_s=s["ttft_p99_s"],
                prefix_hit_rate=hits / lookups if lookups else 0.0,
                saved_prefill_tokens=saved, cow_copies=cow, preemptions=pre,
                truncated_sessions=res.truncated_sessions)


def phase_serving_edge(torch, np, dev, cfg, params, prompts, yi_streams):
    """Phase 8: 8b and 8c on one Yi-9B server and frontend, then 8b's SSE streams held
    to a fresh server's ``drain()`` (the first server freed before)."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.serving.server import PagedServer

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    srv, fe, streams, fe_res = phase_frontend(torch, np, dev, cfg, params,
                                              prompts)
    fe_counts = launches()
    reset_launches()
    lg = phase_loadgen(torch, np, srv, fe, cfg)
    lg_counts = launches()
    del srv, fe
    gc.collect()
    torch.cuda.empty_cache()
    oracle_srv = PagedServer(cfg, params, gcfg=GriffinConfig(sparsity=0.5),
                             device=dev, **YI_SERVER)
    reset_launches()
    oracle = serve(oracle_srv, prompts)
    drain_counts = launches()
    del oracle_srv
    gc.collect()
    torch.cuda.empty_cache()
    for i in streams:
        check(streams[i] == oracle[i],
              f"SSE stream {i} {streams[i]} != drain() {oracle[i]}")
    fe_res["token_match_vs_phase4"] = match_rate(oracle, yi_streams)
    for name, counts in (("frontend", fe_counts), ("loadgen", lg_counts),
                         ("drain", drain_counts)):
        kinds = attn_kinds(counts)
        check(kinds["decode"] > 0 and kinds["prefill"] > 0
              and counts["expert_stat"] > 0, f"phase 8 {name} launches {counts}")
    fe_res["launches"], lg["launches"] = fe_counts, lg_counts
    return fe_res, lg, drain_counts


# ---------------------------------------------------------------------------
# phase 9: the paper's contiguous path (GenerationEngine, evaluation)
# ---------------------------------------------------------------------------

#: 9a's engines: name -> (config overrides, GRIFFIN config or None)
ENGINE_VARIANTS = {"dense": ({}, None),
                   "topk": ({}, dict(sparsity=0.5)),
                   "blocks": ({}, dict(sparsity=0.5, mode="blocks", block_size=128)),
                   "int8": (dict(kv_cache_int8=True), dict(sparsity=0.5))}
#: 9a's deterministic evaluation methods, and the relative tolerance of
#: their card numbers against the CPU's (fp32, TF32 off: sums in another
#: order move the mean NLL by ~1e-6)
EVAL_METHODS = ("full", "griffin", "griffin_batched", "magnitude", "wanda",
                "blocks")
EVAL_RTOL = 1e-4
#: 9b: prompts, prompt length, new tokens; the PPL protocol's prompt and
#: generation partitions and its methods
YI_ENGINE = dict(B=2, S=512, steps=64)
YI_PPL = dict(P=448, G=64, methods=("full", "griffin", "magnitude", "wanda"))


def on_both(torch, dev, card, host, total, what, fn):
    """fn(device, params) on the card, then the CPU: (card result, CPU
    result, card launches); the CPU run must launch nothing, the card
    run's launches are added to ``total``."""
    out, counts = [], []
    for d, p in ((dev, card), (torch.device("cpu"), host)):
        reset_launches()
        out.append(fn(d, p))
        counts.append(launches())
    check(sum(counts[1].values()) == 0, f"{what}: CPU run launched {counts[1]}")
    add_counts(total, counts[0])
    return out[0], out[1], counts[0]


def only(counts, **want) -> bool:
    """Every counted kernel launched exactly as ``want`` says (0 if not
    named)."""
    return all(counts[k] == want.get(k, 0) for k in counts)


def phase_engine_tinylm(torch, np, dev, tmp: Path):
    """9a, phase 3's tinylm weights (fp32, TF32 off), every result held to
    the same call on the CPU: ``GenerationEngine.generate`` greedy tokens
    (dense, GRIFFIN 0.5 ``topk`` and ``blocks``, the int8 cache); the
    evaluation protocols for every deterministic method within
    ``EVAL_RTOL``; a ``derive_profile`` profile, written to JSON and
    served through ``launch.serve.main --tier 0.5 --sparsity-profile``.
    ``expert_stat`` must launch once per FF layer on every prefill with
    statistics.  Returns the card runs' launches and the results."""
    from repro_torch import bridge
    from repro_torch.analysis.profile import derive_profile
    from repro_torch.checkpoint import checkpointer
    from repro_torch.core import evaluate
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.models import decoder
    from repro_torch.serving.engine import GenerationEngine

    cfg, host, _, _ = tinylm_setup(np)
    card = to_device(host, dev)
    n_ff = len(decoder.extract_ffn_tree(host, cfg))
    rng = np.random.default_rng(9)
    prompts = rng.integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    seqs = rng.integers(0, cfg.vocab_size, (3, 32)).astype(np.int32)
    total, res = {}, {}

    def both(fn):
        return on_both(torch, dev, card, host, total, "9a", fn)

    for name, (over, g) in ENGINE_VARIANTS.items():
        c = cfg.replace(**over)
        gcfg = None if g is None else GriffinConfig(**g)
        got, want, counts = both(lambda d, p: GenerationEngine(
            c, p, gcfg, max_len=48, device=d).generate(prompts, 16).cpu())
        check(torch.equal(got, want), f"9a engine {name}: card {got} != CPU {want}")
        check(len(torch.unique(want)) > 4, f"9a engine {name}: degenerate {want}")
        check(only(counts, expert_stat=n_ff if gcfg else 0),
              f"9a engine {name} launches {counts}")
        res[f"engine_{name}"] = want[0, :8].tolist()

    for method in EVAL_METHODS:
        got, want, counts = both(lambda d, p: (
            evaluate.generation_ppl(p, cfg, seqs, 24, method),
            evaluate.classification_sim(p, cfg, seqs, method)))
        (ppl_c, cls_c), (ppl_h, cls_h) = got, want
        rel = max(abs(ppl_c - ppl_h) / ppl_h,
                  abs(cls_c["nll"] - cls_h["nll"]) / abs(cls_h["nll"]))
        check(rel <= EVAL_RTOL, f"9a {method}: card ppl {ppl_c} nll {cls_c} "
              f"vs CPU {ppl_h} {cls_h}: relative {rel:.3g}")
        check(cls_c["agree_full"] == cls_h["agree_full"]
              and cls_c["acc"] == cls_h["acc"], f"9a {method}: {cls_c} vs {cls_h}")
        # one prompt pass with statistics per protocol
        check(only(counts, expert_stat=2 * n_ff), f"9a {method} launches {counts}")
        res[f"eval_{method}"] = dict(ppl=ppl_c, **cls_c, rel_vs_cpu=rel)

    got, want, counts = both(lambda d, p: derive_profile(cfg, p, seqs[:2]))
    check([q for q, _ in got.weights] == [q for q, _ in want.weights],
          f"9a profile paths {got.weights} vs {want.weights}")
    diff = max(abs(a - b) for (_, wa), (_, wb) in zip(got.weights, want.weights)
               for a, b in zip(wa, wb))
    check(diff <= 1e-4 and only(counts, expert_stat=2 * n_ff),
          f"9a profile: weights differ by {diff}, launches {counts}")
    path = tmp / "profile.json"
    got.save(path)
    ckpt = tmp / "ckpt"
    checkpointer.save(str(ckpt), 1, {"params": bridge.params_to_jax(host, cfg)})
    base = ["--arch", "tinylm", "--requests", "4", "--ckpt-dir", str(ckpt),
            "--tier", "0.5", "--sparsity-profile", str(path)]
    (out_c, text), (out_h, _), counts = both(
        lambda d, p: launcher(base + ["--device", d.type]))
    check(out_c == out_h, f"9a profiled launcher: card {out_c} != CPU {out_h}")
    check(f"[profile] {path}" in text and counts["expert_stat"] > 0,
          f"9a profiled launcher: {text} launches {counts}")
    res["profile"] = dict(weights=dict(got.weights), max_diff_vs_cpu=diff,
                          rid0=out_c[0][:8])
    return total, res


def profile_engine(torch, eng, prompts, n_steps: int = 4, strict: bool = True):
    """Device time by kernel of one ``GenerationEngine`` prefill (with
    GRIFFIN's statistics and selection) and of ``n_steps`` decode steps on
    the compacted FF (``torch.profiler``, fenced as ``device_kernels``
    fences a call), beside their host-clock wall.  ``strict``: the
    prefill trace is taken again when it lacks an ``expert_stat`` record
    of any layer; otherwise the trace is kept and ``expert_stat_records``
    says how many it holds (a trace short of ``n_stat`` lost records)."""
    from repro_torch.models import decoder

    B, S = prompts.shape
    state, walls = {}, {"prefill": [], "decode": []}

    def prefill():
        t0 = time.perf_counter()
        _, aux = eng.prefill(prompts)
        state["pruned"] = eng.select_and_compact(aux.stats)
        state["cache"] = decoder.fill_cache_from_prefill(
            eng.cfg, decoder.init_cache(eng.cfg, B, eng.max_len, prompts.device),
            aux.kv)
        torch.cuda.synchronize()
        walls["prefill"].append(time.perf_counter() - t0)

    def decode():
        tok = prompts[:, -1:]
        t0 = time.perf_counter()
        for i in range(n_steps):
            logits, _ = eng.decode(state["cache"], state["pruned"], tok, S + i)
            tok = torch.argmax(logits[:, 0], dim=-1)[:, None]
        torch.cuda.synchronize()
        walls["decode"].append((time.perf_counter() - t0) / n_steps)

    out = {}
    def n_stat(evs):
        return sum("expert_stat" in e.name for e in evs)

    full = (lambda evs: n_stat(evs) == eng.cfg.num_layers) if strict else None
    for name, fn, per, complete in (("prefill", prefill, 1, full),
                                    ("decode_step", decode, n_steps, None)):
        # traces of a whole prefill (~6,000 device records) have come back
        # without some records three times running: take up to 8
        evs = fenced_device_events(torch, fn, 8, complete=complete)
        by_name = {}
        for e in evs:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
        rows = sorted(((k, ms / per, c // per) for k, (ms, c) in by_name.items()),
                      key=lambda r: -r[1])
        wall = walls["prefill" if name == "prefill" else "decode"][-1] * 1e3
        out[name] = dict(wall_ms=wall, device_busy_ms=sum(r[1] for r in rows),
                         device_records=sum(r[2] for r in rows),
                         expert_stat_records=n_stat(evs) // per,
                         top=[dict(kernel=k[:90], ms=ms, count=c)
                              for k, ms, c in rows[:10]])
    return out


def engine_runs(torch, dev, cfg, params, prompts, steps: int, variants,
                n_stat: int, tag: str, profile: bool = False,
                profile_kw=None):
    """``GenerationEngine`` over ``prompts`` [B, S] (on the card) and
    ``steps`` new tokens for each ``(name, gcfg)`` of ``variants``:
    prefill, GRIFFIN's selection and every decode step timed on the host
    clock after a ``synchronize``, each engine after an untimed warm-up
    call; every decode logit finite; ``expert_stat`` launched ``n_stat``
    times per GRIFFIN prefill and nothing else launched.  ``profile``
    adds ``profile_engine``'s breakdown of the ``griffin`` variant
    (``profile_kw``: its options).
    Returns (launches, numbers by variant, token streams by variant)."""
    from repro_torch.serving.engine import GenerationEngine

    B, S = prompts.shape
    total, res, streams = {}, {}, {}
    for name, gcfg in variants:
        eng = GenerationEngine(cfg, params, gcfg, max_len=S + steps, device=dev)
        eng.generate(prompts, 2)  # first calls at these shapes, untimed
        times = {"prefill": [], "select": [], "decode": []}

        def timed(fn, key, finite=False):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                times[key].append(time.perf_counter() - t0)
                if finite:
                    check(bool(torch.isfinite(out[0]).all()),
                          f"{tag} {name}: non-finite logits")
                return out
            return run

        eng.prefill = timed(eng.prefill, "prefill", finite=True)
        eng.select_and_compact = timed(eng.select_and_compact, "select")
        eng.decode = timed(eng.decode, "decode", finite=True)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        out = eng.generate(prompts, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = launches()
        add_counts(total, counts)
        got_stat = counts["expert_stat"]
        check(got_stat == (n_stat if gcfg else 0)
              and sum(counts.values()) == got_stat, f"{tag} {name} launches {counts}")
        check(tuple(out.shape) == (B, steps)
              and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              f"{tag} {name}: tokens {out}")
        streams[name] = out.cpu()
        dec = times["decode"]
        res[name] = dict(
            prefill_ms=times["prefill"][0] * 1e3,
            select_compact_ms=times["select"][0] * 1e3 if times["select"] else None,
            decode_tokens_per_s=B * len(dec) / sum(dec),
            tpot_p50_ms=statistics.median(dec) * 1e3,
            generate_wall_s=wall, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            expert_stat_per_prefill=got_stat, tokens=out[:, :8].tolist())
        if profile and name == "griffin":
            del eng.prefill, eng.select_and_compact, eng.decode  # untimed
            res["griffin_profile"] = profile_engine(torch, eng, prompts,
                                                    **(profile_kw or {}))
        del eng
    return total, res, streams


def phase_engine_yi9b(torch, np, dev, cfg, params, profile: bool = False):
    """9b, Yi-9B at full size (bf16, random weights from seed 0):
    ``engine_runs`` over B=2 prompts of 512 tokens and 64 new tokens,
    dense and with GRIFFIN 0.5 ``topk`` (``expert_stat`` launched once per
    FF layer of a GRIFFIN prefill); then ``evaluate.generation_ppl`` at
    P=448, G=64 for full, griffin, magnitude and wanda: every value
    finite.  ``profile`` adds ``profile_engine``'s breakdown of the
    GRIFFIN engine.  Returns the launches of both parts and the numbers."""
    from repro_torch.core import evaluate
    from repro_torch.core.griffin import GriffinConfig

    B, S, steps = YI_ENGINE["B"], YI_ENGINE["S"], YI_ENGINE["steps"]
    rng = np.random.default_rng(5)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                               .astype(np.int32)).to(dev)
    total, res, streams = engine_runs(
        torch, dev, cfg, params, prompts, steps,
        (("dense", None), ("griffin", GriffinConfig(sparsity=0.5))),
        cfg.num_layers, "9b", profile)
    res["token_match_griffin_vs_dense"] = float(
        (streams["griffin"] == streams["dense"]).float().mean())
    gc.collect()
    torch.cuda.empty_cache()

    P, G = YI_PPL["P"], YI_PPL["G"]
    seqs = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, P + G))
                            .astype(np.int32)).to(dev)
    res["ppl"] = {}
    for method in YI_PPL["methods"]:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ppl = evaluate.generation_ppl(params, cfg, seqs, P, method)
        wall = time.perf_counter() - t0
        counts = launches()
        add_counts(total, counts)
        check(np.isfinite(ppl) and counts["expert_stat"] == cfg.num_layers,
              f"9b generation_ppl {method}: {ppl}, launches {counts}")
        res["ppl"][method] = dict(ppl=ppl, wall_s=wall,
                                  peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        gc.collect()
        torch.cuda.empty_cache()
    return total, res


def engine_shape_expert_stat(torch, dev, F: int, dtypes=None):
    """``expert_stat`` at the engine's whole-prompt shape [2, 512, F]
    (``dtypes``: fp32 and bf16 unless given) against its plain version
    under phase 2's tolerance, each timed beside its bound and its plain
    version (the launches here count toward no path)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    B, S = YI_ENGINE["B"], YI_ENGINE["S"]
    out = {}
    for dtype in dtypes or (torch.float32, torch.bfloat16):
        z = torch.randn(B, S, F, generator=gen, device=dev).to(dtype)
        got, want = ops.griffin_stat(z), ref.expert_stat_ref(z)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        what = f"expert_stat [{B},{S},{F}] {dtype}"
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-5), f"{what}: max err {err}")
        check(torch.equal(got, ops.griffin_stat(z)), f"{what}: not deterministic")
        ms = time_ms(torch, lambda: ops.griffin_stat(z), flush=flush)
        plain_ms = time_ms(torch, lambda: ref.expert_stat_ref(z), flush=flush)
        b_ms, b_by = bound(z.numel() * z.element_size() + B * F * 4, 3 * z.numel())
        out["bf16" if dtype == torch.bfloat16 else "fp32"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            max_abs_err=err, at=f"z [{B},{S},{F}]")
    del flush
    return out


# ---------------------------------------------------------------------------
# phase 10: the MoE and MLA families (GenerationEngine, ContinuousBatcher,
# the launcher's slot-batcher fallback)
# ---------------------------------------------------------------------------

#: the archs of phase 10
FAMILIES = ("moonshot-v1-16b-a3b", "deepseek-v3-671b")
#: 10b/10c engines: prompts, prompt length, new tokens
FAMILY_ENGINE = dict(B=2, S=512, steps=32)
#: 10b's batcher: prompt lengths, new tokens each, slots
FAMILY_BATCHER = dict(lens=(200, 350, 480, 600), new=16, slots=2)
#: FF widths of phase 10's GRIFFIN prefills (Moonshot's shared experts and
#: dense layer, DeepSeek-V3's shared expert and dense layers), for phase 2's
#: ``expert_stat`` rows at the engine's [2, 512, F] bf16 shape
MOE_STAT_WIDTHS = (2816, 11264, 2048, 18432)


def phase_families_smoke(torch, np, dev):
    """10a, the smoke configs of both families (fp32, TF32 off, weights
    drawn on the CPU from seed 0 and copied to the card), every result
    held to the same call on the CPU: ``GenerationEngine`` greedy tokens
    dense and with GRIFFIN 0.5; a ``ContinuousBatcher`` of 2 slots over 4
    requests of mixed lengths with GRIFFIN 0.5; ``launch.serve.main``
    through its slot-batcher fallback.  ``expert_stat`` launches once per
    prunable FF block (dense layer or shared experts) of every prefill
    with statistics, and nothing else launches.  Returns the card runs'
    launches and the results."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.models import decoder
    from repro_torch.serving.engine import ContinuousBatcher, GenerationEngine

    total, res = {}, {}
    rng = np.random.default_rng(10)
    for arch in FAMILIES:
        cfg = get_config(arch, smoke=True)
        host = decoder.init_params(cfg, seed=0, device="cpu")
        card = to_device(host, dev)
        n_ff = len(decoder.extract_ffn_tree(host, cfg))

        def both(what, fn):
            return on_both(torch, dev, card, host, total, f"10a {arch} {what}", fn)

        prompts = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
        for name, g in (("dense", None), ("griffin", dict(sparsity=0.5))):
            gcfg = None if g is None else GriffinConfig(**g)
            got, want, counts = both(f"engine {name}", lambda d, p: GenerationEngine(
                cfg, p, gcfg, max_len=48, device=d).generate(prompts, 16).cpu())
            check(torch.equal(got, want), f"10a {arch} engine {name}: card {got} "
                  f"!= CPU {want}")
            check(len(torch.unique(want)) > 4, f"10a {arch} engine {name}: "
                  f"degenerate {want}")
            check(only(counts, expert_stat=n_ff if gcfg else 0),
                  f"10a {arch} engine {name} launches {counts}")
            res[f"{arch} engine_{name}"] = want[0, :8].tolist()

        reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
                for n, m in ((6, 3), (17, 6), (11, 4), (25, 5))]

        def batch(d, p):
            cb = ContinuousBatcher(cfg, p, n_slots=2, max_len=48,
                                   gcfg=GriffinConfig(sparsity=0.5), device=d)
            for rid, (prompt, m) in enumerate(reqs):
                cb.submit(prompt, m, rid)
            return cb.run()

        got, want, counts = both("batcher", batch)
        check(got == want, f"10a {arch} batcher: card {got} != CPU {want}")
        check({k: len(v) for k, v in got.items()} == {i: m for i, (_, m) in
                                                      enumerate(reqs)},
              f"10a {arch} batcher lengths {got}")
        check(only(counts, expert_stat=n_ff * len(reqs)),
              f"10a {arch} batcher launches {counts}")
        res[f"{arch} batcher"] = got[0]

        argv = ["--arch", arch, "--requests", "4", "--max-len", "64"]
        (out_c, text), (out_h, _), counts = both("launcher", lambda d, p: launcher(
            argv + ["--device", d.type]))
        check(out_c == out_h, f"10a {arch} launcher: card {out_c} != CPU {out_h}")
        check("slots: served 4 requests" in text and counts["expert_stat"] > 0,
              f"10a {arch} launcher: {text} launches {counts}")
        res[f"{arch} launcher"] = [ln for ln in text.splitlines() if "slots:" in ln]
    return total, res


def family_model(torch, dev, arch: str, **over):
    """``arch``'s full config (``over`` cuts it), bf16, random weights
    from seed 0 drawn on the card."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder

    cfg = get_config(arch).replace(**over)
    t0 = time.perf_counter()
    params = decoder.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0

    def numel(tree):
        if isinstance(tree, dict):
            return sum(numel(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(numel(v) for v in tree)
        return tree.numel()

    return cfg, params, dict(layers=cfg.num_layers, params=numel(params),
                             init_s=t_init,
                             weights_gb=torch.cuda.memory_allocated() / 1e9)


def phase_family_full(torch, np, dev, cfg, params, tag: str, batcher: bool,
                      profile: bool = False):
    """10b / 10c: ``engine_runs`` over B=2 prompts of 512 tokens and 32 new
    tokens, dense, GRIFFIN 0.5 and GRIFFIN 0.0 (``expert_stat`` once per
    prunable FF block of a GRIFFIN prefill).  GRIFFIN 0.0 must give the
    dense stream token for token, and its compaction (k = F) every
    column in order.  ``batcher`` adds a ``ContinuousBatcher`` of 2 slots
    serving 4 requests of 200/350/480/600 prompt tokens and 16 new
    tokens with GRIFFIN 0.5.  ``profile`` adds ``profile_engine``'s
    breakdown of the GRIFFIN 0.5 engine.  Returns the launches and the
    numbers."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.models import decoder
    from repro_torch.serving.engine import ContinuousBatcher, GenerationEngine

    B, S, steps = FAMILY_ENGINE["B"], FAMILY_ENGINE["S"], FAMILY_ENGINE["steps"]
    rng = np.random.default_rng(5)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                               .astype(np.int32)).to(dev)
    n_ff = len(decoder.extract_ffn_tree(params, cfg))
    total, res, streams = engine_runs(
        torch, dev, cfg, params, prompts, steps,
        (("dense", None), ("griffin", GriffinConfig(sparsity=0.5)),
         ("griffin0", GriffinConfig(sparsity=0.0))), n_ff, tag, profile,
        # a Moonshot prefill is ~9,000 device records: its traces have
        # come back short of records in every try, so keep them
        dict(n_steps=2, strict=False))
    check(torch.equal(streams["griffin0"], streams["dense"]),
          f"{tag}: GRIFFIN 0.0 {streams['griffin0']} != dense {streams['dense']}")
    res["token_match_griffin_vs_dense"] = float(
        (streams["griffin"] == streams["dense"]).float().mean())
    eng = GenerationEngine(cfg, params, GriffinConfig(sparsity=0.0),
                           max_len=S + steps, device=dev)
    _, aux = eng.prefill(prompts)
    full = decoder.extract_ffn_tree(params, cfg)
    for li, ffn in eng.select_and_compact(aux.stats).items():
        check(all(torch.equal(ffn[k], full[li][k]) for k in full[li]),
              f"{tag}: layer {li} compacted at k = F is not its FF block")
    del eng, aux, full
    gc.collect()
    torch.cuda.empty_cache()
    if not batcher:
        return total, res

    lens, new = FAMILY_BATCHER["lens"], FAMILY_BATCHER["new"]
    reqs = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]
    cb = ContinuousBatcher(cfg, params, n_slots=FAMILY_BATCHER["slots"],
                           max_len=max(lens) + new + 8,
                           gcfg=GriffinConfig(sparsity=0.5), device=dev)
    for rid, prompt in enumerate(reqs):
        cb.submit(prompt, new, rid)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = cb.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    add_counts(total, counts)
    check(only(counts, expert_stat=n_ff * len(reqs)),
          f"{tag} batcher launches {counts}")
    check(all(len(out[i]) == new and all(0 <= t < cfg.vocab_size for t in out[i])
              for i in range(len(reqs))), f"{tag} batcher: streams {out}")
    n_tok = sum(len(v) for v in out.values())
    res["batcher"] = dict(requests=len(reqs), tokens=n_tok, wall_s=wall,
                          tokens_per_s=n_tok / wall,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                          expert_stat=counts["expert_stat"], rid0=out[0][:8])
    return total, res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile Yi-9B decode ticks (phases 4, 5 and "
                    "7b's dense server), spec rounds (7b) and the GRIFFIN "
                    "engines' prefill and decode steps (9b, 10b, 10c) with "
                    "torch.profiler; the attention kernels' share is named "
                    "apart")
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
    # expert_stat at phase 10's GRIFFIN prefill widths, bf16
    moe_stat = {F: engine_shape_expert_stat(torch, dev, F, (torch.bfloat16,))["bf16"]
                for F in MOE_STAT_WIDTHS}
    for r in moe_stat.values():
        lines.append(f"expert_stat {r['at']} bf16 (phase 10's widths): kernel "
                     f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
                     f"{r['bound_ms']:.5f} ms ({r['bound_by']})  max_abs_err "
                     f"{r['max_abs_err']:.3g}")
    kernels["expert_stat"]["moe_engine"] = list(moe_stat.values())
    print(f"phase 2 kernels vs plain versions ({card}):")
    for line in lines:
        print("  " + line)

    t0 = time.perf_counter()
    tiny_counts, streams = phase_tinylm(torch, np, dev)
    print(f"phase 3 tinylm fused == gather == CPU plain, fp32/int8/fp8 pools: "
          f"{time.perf_counter() - t0:.1f} s, launches {tiny_counts}, rid 0 "
          + ", ".join(f"{k} {v[0]}" for k, v in streams.items()))

    t0 = time.perf_counter()
    cfg, params, prompts, model = yi9b_model(torch, np, dev)
    yi, yi_streams = serve_yi9b(torch, np, dev, cfg, params, prompts, "fp32",
                                args.profile)
    print(f"phase 4 yi-9b ({card}): {time.perf_counter() - t0:.1f} s total, "
          f"{model['params'] / 1e9:.2f}B params, init {model['init_s']:.1f} s")
    keys = ("pool_dtype", "wall_s", "tokens_per_s", "ttft_p50_s", "tpot_p50_s",
            "steps", "prefill_chunks", "preemptions", "attn_bytes_per_token",
            "peak_mem_gb", "launches", "attn_calls_per_decode_tick")
    for k in keys:
        print(f"  {k}: {yi[k]}")
    if "decode_tick_profile" in yi:
        print("  decode tick profile: " + json.dumps(yi["decode_tick_profile"]))

    quant = {}
    for kvd in ("int8", "fp8"):
        t0 = time.perf_counter()
        res, out = serve_yi9b(torch, np, dev, cfg, params, prompts, kvd,
                              args.profile)
        res["token_match_vs_phase4"] = match_rate(out, yi_streams)
        res["attn_bytes_per_token_vs_phase4"] = \
            res["attn_bytes_per_token"] / yi["attn_bytes_per_token"]
        quant[kvd] = res
        print(f"phase 5 yi-9b {kvd} pools ({card}): "
              f"{time.perf_counter() - t0:.1f} s total")
        for k in keys + ("attn_bytes_per_token_vs_phase4",
                         "token_match_vs_phase4"):
            print(f"  {k}: {res[k]}")
        if "decode_tick_profile" in res:
            print("  decode tick profile: " + json.dumps(res["decode_tick_profile"]))

    if args.profile:
        # phase 4 again after phase 5, so that bf16 / int8 / fp8 / bf16 runs
        # bracket any drift of the host-bound numbers within the call
        again, _ = serve_yi9b(torch, np, dev, cfg, params, prompts, "fp32")
        print("phase 5 bracket: yi-9b bf16 pools again: "
              + ", ".join(f"{k} {again[k]}" for k in
                          ("tokens_per_s", "ttft_p50_s", "tpot_p50_s")))

    t0 = time.perf_counter()
    ff_counts, ff = phase_ffn_entry_points(torch, dev, cfg, params)
    print(f"phase 6 yi-9b FF entry points, {cfg.num_layers} layers "
          f"({card}): {time.perf_counter() - t0:.1f} s, launches "
          f"glu_ffn {ff_counts['glu_ffn']} griffin_ffn {ff_counts['griffin_ffn']}, "
          f"{ff}")

    t0 = time.perf_counter()
    spec_tiny_counts, spec_tiny = phase_spec_tinylm(torch, np, dev)
    print(f"phase 7a tinylm spec_k=3 fused == per_token == gather == CPU plain "
          f"(== dense at fp32), fp32/int8/fp8 pools: "
          f"{time.perf_counter() - t0:.1f} s, "
          f"launches {spec_tiny_counts}, {spec_tiny}")
    t0 = time.perf_counter()
    spec_dense, dense_out = serve_yi9b(torch, np, dev, cfg, params, prompts,
                                       "fp32", args.profile, griffin=False)
    spec, spec_out = serve_yi9b(torch, np, dev, cfg, params, prompts, "fp32",
                                args.profile, spec_k=4)
    spec["token_match_vs_dense"] = match_rate(spec_out, dense_out)
    print(f"phase 7b yi-9b GRIFFIN 0.5 drafts, spec_k=4 fused, adaptive, bf16 "
          f"pools, beside a dense server ({card}): "
          f"{time.perf_counter() - t0:.1f} s total")
    spec_keys = ("tokens_per_s", "ttft_p50_s", "tpot_p50_s", "peak_mem_gb",
                 "attn_launches_by_kind", "decode_ticks", "decode_tick_wall_ms_p50")
    for k in spec_keys:
        print(f"  dense {k}: {spec_dense[k]}")
    for k in spec_keys + ("spec_rounds", "acceptance_rate", "tokens_per_verify",
                          "draft_k_mean", "spec_capped_rounds", "spec_round_ticks",
                          "spec_round_wall_ms_p50", "token_match_vs_dense",
                          "sync_free_round"):
        print(f"  spec {k}: {spec[k]}")
    for name, r in (("dense", spec_dense), ("spec", spec)):
        if "decode_tick_profile" in r:
            print(f"  {name} tick profile: " + json.dumps(r["decode_tick_profile"]))

    t8 = t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        launch_counts, launch_lines = phase_launcher(torch, np, Path(tmp))
    print(f"phase 8a launch.serve.main tinylm card == --device cpu "
          f"(GRIFFIN int8 spec_k=3 + trace + snapshot + flocking; dense "
          f"gather; tier 0.5): {time.perf_counter() - t0:.1f} s, launches "
          f"{launch_counts}")
    for name, lines_ in launch_lines.items():
        print(f"  {name}: " + " | ".join(lines_))
    t0 = time.perf_counter()
    fe_res, lg_res, drain_counts = phase_serving_edge(
        torch, np, dev, cfg, params, prompts, yi_streams)
    print(f"phase 8b yi-9b HTTP/SSE frontend, 4 requests + 1 hung up, "
          f"flocking every 4 ticks, SSE == drain() ({card}):")
    for k, v in fe_res.items():
        print(f"  {k}: {v}")
    print(f"phase 8c yi-9b loadgen, 6 sessions on the real clock ({card}):")
    for k, v in lg_res.items():
        print(f"  {k}: {v}")
    print(f"phase 8 total: {time.perf_counter() - t8:.1f} s (8b-8c "
          f"{time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        eng_tiny_counts, eng_tiny = phase_engine_tinylm(torch, np, dev, Path(tmp))
    print(f"phase 9a tinylm GenerationEngine (dense/topk/blocks/int8), "
          f"evaluation ({'/'.join(EVAL_METHODS)}) and a derived profile "
          f"served at tier 0.5, card == CPU: {time.perf_counter() - t0:.1f} s, "
          f"launches {eng_tiny_counts}")
    for k, v in eng_tiny.items():
        print(f"  {k}: {v}")
    t0 = time.perf_counter()
    eng_yi_counts, eng_yi = phase_engine_yi9b(torch, np, dev, cfg, params,
                                              args.profile)
    del params
    stat_engine = engine_shape_expert_stat(torch, dev, cfg.d_ff)
    print(f"phase 9b yi-9b GenerationEngine B={YI_ENGINE['B']} prompt "
          f"{YI_ENGINE['S']} + {YI_ENGINE['steps']} new, generation_ppl "
          f"P={YI_PPL['P']} G={YI_PPL['G']} ({card}): "
          f"{time.perf_counter() - t0:.1f} s, launches {eng_yi_counts}")
    for k, v in eng_yi.items():
        print(f"  {k}: {v}")
    for dt, r in stat_engine.items():
        print(f"  expert_stat {r['at']} {dt}: kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})  launch floor {kernels['launch_floor_ms']:.4f} ms"
              f"  max_abs_err {r['max_abs_err']:.3g}")
    kernels["expert_stat"]["engine"] = stat_engine["bf16"]

    gc.collect()
    torch.cuda.empty_cache()
    t10 = t0 = time.perf_counter()
    fam_smoke_counts, fam_smoke = phase_families_smoke(torch, np, dev)
    print(f"phase 10a moonshot/deepseek-v3 smoke configs, GenerationEngine "
          f"(dense/GRIFFIN 0.5), ContinuousBatcher and launch.serve slot "
          f"fallback, card == CPU: {time.perf_counter() - t0:.1f} s, launches "
          f"{fam_smoke_counts}")
    for k, v in fam_smoke.items():
        print(f"  {k}: {v}")
    family = {}
    for arch, tag, over, batcher in (
            ("moonshot-v1-16b-a3b", "10b", {}, True),
            ("deepseek-v3-671b", "10c", dict(num_layers=4, mtp_depth=0), False)):
        t0 = time.perf_counter()
        before_gb = torch.cuda.memory_allocated() / 1e9
        fcfg, fparams, fmodel = family_model(torch, dev, arch, **over)
        counts, res = phase_family_full(torch, np, dev, fcfg, fparams, tag, batcher,
                                        args.profile)
        del fparams
        gc.collect()
        torch.cuda.empty_cache()
        family[tag] = dict(arch=arch, model=fmodel, launches=counts, **res)
        print(f"{tag} {arch} {fcfg.num_layers} layers, "
              f"{fmodel['params'] / 1e9:.2f}B params ({fmodel['weights_gb']:.1f} GB "
              f"on the card, {before_gb:.2f} GB before the draw), init "
              f"{fmodel['init_s']:.1f} s; GenerationEngine B={FAMILY_ENGINE['B']} "
              f"prompt {FAMILY_ENGINE['S']} + {FAMILY_ENGINE['steps']} new "
              f"({card}): {time.perf_counter() - t0:.1f} s, launches {counts}")
        for k, v in res.items():
            print(f"  {k}: {v}")
    print(f"phase 10 total: {time.perf_counter() - t10:.1f} s")

    # launches on each kernel's main path: the serving runs for the
    # attention, statistic and gather kernels, phase 6 for the FF kernels,
    # phase 9's engines, protocols and profiled launcher for the statistic
    paths = {"tinylm": tiny_counts, "yi9b": yi["launches"],
             "yi9b_int8": quant["int8"]["launches"],
             "yi9b_fp8": quant["fp8"]["launches"], "ffn_entry_points": ff_counts,
             "spec_tinylm": spec_tiny_counts, "yi9b_dense": spec_dense["launches"],
             "yi9b_spec": spec["launches"], "launcher_tinylm": launch_counts,
             "frontend_yi9b": fe_res["launches"], "loadgen_yi9b": lg_res["launches"],
             "drain_yi9b": drain_counts, "engine_tinylm": eng_tiny_counts,
             "engine_yi9b": eng_yi_counts, "families_smoke": fam_smoke_counts,
             "moonshot": family["10b"]["launches"],
             "deepseek_v3": family["10c"]["launches"]}
    sources = {
        "paged_attn": ("src/repro_torch/csrc/paged_attn.cu",
                       "src/repro/kernels/paged_attn.py:340"),
        "paged_attn_quant": ("src/repro_torch/csrc/paged_attn.cu",
                             "src/repro/kernels/paged_attn.py:340"),
        "expert_stat": ("src/repro_torch/csrc/expert_stat.cu",
                        "src/repro/kernels/expert_stat.py:47"),
        "paged_gather": ("src/repro_torch/csrc/paged_gather.cu",
                         "src/repro/kernels/paged_gather.py:52"),
        "griffin_ffn": ("src/repro_torch/csrc/griffin_ffn.cu",
                        "src/repro/kernels/griffin_ffn.py:83"),
        "glu_ffn": ("src/repro_torch/csrc/glu_ffn.cu",
                    "src/repro/kernels/glu_ffn.py:57"),
    }
    entries = []
    for name, (src, replaces) in sources.items():
        r = kernels[name]
        by_path = {p: c[name] for p, c in paths.items() if c.get(name)}
        n = sum(by_path.values())
        check(n > 0, f"{name} was never launched on the main path")
        entry = {"name": name, "route": "cuda", "source": src,
                 "replaces": replaces, "launches": n,
                 "launches_by_path": by_path,
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                 "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                 "at": r["at"]}
        entry.update({k: r[k] for k in ("pass_ms", "compacted_ms") if k in r})
        if "engine" in r:  # expert_stat at GenerationEngine's prompt shape
            entry.update({f"engine_{k}": v for k, v in r["engine"].items()})
            entry["moe_engine"] = r["moe_engine"]  # and at phase 10's widths
        if "prefill" in r:  # attention: decode (the fields above), prefill
            # and speculative verify
            pre = sum(c.get(name + "_prefill", 0) for c in paths.values())
            ver = sum(c.get(name + "_verify", 0) for c in paths.values())
            entry.update(launches_decode=n - pre - ver, launches_prefill=pre,
                         launches_verify=ver)
            for kind in ("prefill", "verify"):
                p = r[kind]
                entry.update({f"{kind}_{k}": p[k] for k in
                              ("ms", "plain_ms", "bound_ms", "bound_by", "at")})
        entries.append(entry)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": entries,
             "launch_floor_ms": kernels["launch_floor_ms"], "model": model, "yi9b": yi,
             "yi9b_quant": quant, "ffn_entry_points": ff,
             "spec_tinylm": spec_tiny, "yi9b_spec": spec, "yi9b_dense": spec_dense,
             "launcher": launch_lines, "frontend": fe_res, "loadgen": lg_res,
             "engine_tinylm": eng_tiny, "engine_yi9b": eng_yi,
             "expert_stat_engine_shape": stat_engine,
             "families_smoke": fam_smoke, "families": family,
             "tinylm_launches": tiny_counts, "lines": lines}, indent=1,
            default=str))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
