#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py [--profile] [--out chiprun_out/chip_smoke.json]

Phases (any failure raises and the script exits non-zero):

1. build the hand-written kernels from ``src/repro_torch/csrc``;
2. hold each kernel against its plain PyTorch version on the card at
   Yi-9B shapes (H=32, KV=4, hd=128, page 16, table width 40 as phases
   4-5 serve; decode S=1 and prefill chunk S=32 with fp32, bf16, int8
   and fp8 pools, the quantized ones timed from warm pools each call;
   ``expert_stat`` on
   [1,32,11008] bf16; ``griffin_ffn`` D=4096, F=11008, 43 of 86 blocks,
   B=2; ``glu_ffn`` [32,4096] x [4096,11008]) and at the tinylm shapes
   phase 3 gives them (H=6, KV=3, hd=32, page 8, table width 8, fp32):
   ctx and statistics within rtol=atol=1e-5, pools and scales
   bit-identical except the trash page, quantized ctx within
   ``kv_quant.ERROR_BUDGET`` of the fp32-pool plain version, gathers
   exact, FF outputs within 2e-2 (bf16) / 1e-4 (fp32 at Yi-9B width) /
   1e-5 (fp32, small); each timed with CUDA events (median) beside its
   bound and its plain version's time; ``torch.profiler`` shows that one
   ``ops.paged_attention`` call at the Yi-9B decode shape is one device
   kernel for each of fp32/bf16/int8/fp8 pools;
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
   ``ffn_forward``.

The second-to-last line is a JSON object listing the kernels (for
``paged_attn`` and ``paged_attn_quant`` the main fields are the Yi-9B
decode case; ``prefill_*`` give the prefill chunk's time and bound, and
``launches_decode`` / ``launches_prefill`` split the launches by kind);
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device, or
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

#: tolerances of the FF kernels against their plain versions: bf16 as the
#: reference's kernel tests (the plain version rounds g, h and z to bf16,
#: the kernel z only); fp32 sums of 4096 and 5504+ products in another
#: order at Yi-9B width
FF_TOL = {"bfloat16": 2e-2, "float32": 1e-4}


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


def device_kernels(torch, fn, tries: int = 3):
    """Names of the device kernels (and copies) one call of ``fn`` runs,
    from ``torch.profiler`` after a warm-up call.

    The call is fenced in the trace by a GPU spin on each side, and the
    names are those between the two fences.  CUPTI hands the profiler its
    device records asynchronously and now and then a trace comes back
    without them; a trace that lacks either fence is such a trace, says
    nothing about ``fn``, and is taken again, at most ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names = []
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
        names = [e.name for e in evs]
        fences = [i for i, n in enumerate(names) if "spin_kernel" in n]
        if len(fences) == 2:
            return names[fences[0] + 1:fences[1]]
    raise AssertionError(f"torch.profiler traces lacked the two GPU-spin "
                         f"fences {tries} times; the last one held {names}")


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
    yi = dict(H=32, KV=4, hd=128, page=16, W=640 // 16)  # max_len 640
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
        dt = "bf16" if pool_dtype == torch.bfloat16 else "fp32"
        if model == "yi-9b" and label == "decode":
            names = device_kernels(torch, lambda: ops.paged_attention(*kern))
            check(len(names) == 1, f"{what}: one call ran {names}")
            lines.append(f"paged_attn {model} decode pool={dt}: one call = "
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
                results["paged_attn"]["prefill"] = kind
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
             ("tinylm", "decode", 2, 1, [43, 28], torch.float32, tiny),
             ("tinylm", "prefill", 1, 16, [32], torch.float32, tiny)]
    for kvd in ("int8", "fp8"):
        for model, label, B, S, lens, in_dtype, shape in cases:
            args = paged_attn_case(torch, gen, B, S, lens, torch.float32, dev,
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

            if model == "yi-9b" and label == "decode":
                names = device_kernels(torch, lambda: call(ops.paged_attention, kern))
                reset(kern)()
                check(len(names) == 1, f"{what}: one call ran {names}")
                lines.append(f"paged_attn {model} decode pool={kvd}: one call = "
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
                    out["prefill"] = kind
    out["max_abs_err"] = worst
    return out


def ffn_weights(torch, gen, dev, dtype, *shapes_scales):
    return [(torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)
            for shape, scale in shapes_scales]


def phase_kernels_ffn(torch, dev, flush, gen, lines):
    """``griffin_ffn`` at Yi-9B decode width (D=4096, F=11008, 43 of 86
    blocks of 128, B=2) in bf16 and fp32 with swiglu, geglu/reglu at a
    small shape; ``glu_ffn`` on a Yi-9B prefill chunk [32,4096] x
    [4096,11008] in bf16 and fp32, geglu at a small ragged shape.
    Weights ~ N(0, 1/fan_in), so outputs are O(1) and the tolerances
    (``FF_TOL``, 1e-5 for fp32 at the small shapes) are relative to that."""
    from repro_torch.kernels import ops, ref

    results = {}
    worst = 0.0
    for D, F, nb, B, dtype, act in (
            (4096, 11008, 43, 2, torch.bfloat16, "swiglu"),
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
        ms = time_ms(torch, run, flush=flush)
        plain_ms = time_ms(torch, lambda: ref.griffin_ffn_ref(
            x, wg, w1, w2, ids, 128, activation=act), flush=flush)
        byts = (x.numel() * x.element_size() + 3 * n_sel * D * x.element_size()
                + ids.numel() * 4 + B * D * 4)
        b_ms, b_by = bound(byts, 6 * B * n_sel * D, tname)
        lines.append(f"{what}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                     f"bound {b_ms:.5f} ms ({b_by})  max_abs_err {err:.3g} (tol {tol})")
        if D == 4096 and dtype == torch.bfloat16:
            results["griffin_ffn"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, at=f"x [{B},{D}] bf16, {nb} of {F // 128} blocks")
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
#: attention kernels' prefill calls (S > 1) are also counted apart
COUNTERS = {"paged_attn": ("paged_attn", "launches"),
            "paged_attn_quant": ("paged_attn", "launches_quant"),
            "paged_attn_prefill": ("paged_attn", "prefill_launches"),
            "paged_attn_quant_prefill": ("paged_attn", "prefill_launches_quant"),
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


def serve(server, prompts):
    for i, (p, n) in enumerate(prompts):
        server.submit(p, n, rid=i)
    return server.drain()


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v
    return total


def phase_tinylm(torch, np, dev):
    """fused == gather == CPU plain token streams, with fp32, int8 and fp8
    pools; returns the launches summed over the card runs."""
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
               profile: bool = False):
    """``PagedServer`` (GRIFFIN 0.5, ``kernel_backend="auto"``) over the 4
    requests; returns the numbers and the full token streams.  The server
    is dropped before returning."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.serving.server import PagedServer

    torch.cuda.reset_peak_memory_stats()
    srv = PagedServer(cfg, params, gcfg=GriffinConfig(sparsity=0.5),
                      page_size=16, num_pages=256, n_slots=2, prefill_chunk=32,
                      max_len=640, kernel_backend="auto", device=dev,
                      kv_dtype=kv_dtype)
    check(srv.backend == "fused", f"auto resolved to {srv.backend}")
    step_model = srv._step_model

    def checked(*a, **k):
        out = step_model(*a, **k)
        check(bool(torch.isfinite(out[0]).all()), f"yi-9b {kv_dtype}: non-finite logits")
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
    check(sorted(out) == [0, 1, 2, 3], f"yi-9b {kv_dtype} finished {sorted(out)}")
    for rid, toks in out.items():
        check(len(toks) == 32 and all(0 <= t < cfg.vocab_size for t in toks),
              f"yi-9b {kv_dtype} rid {rid}: {toks}")
    attn = "paged_attn_quant" if kv_dtype in ("int8", "fp8") else "paged_attn"
    check(counts[attn] > 0 and counts["expert_stat"] > 0,
          f"yi-9b {kv_dtype} launches {counts}")
    decode_ticks = [t for t in ticks if t["expert_stat"] == 0 and t[attn]]
    m = srv.metrics.summary()
    res = dict(
        kv_dtype=kv_dtype, pool_dtype=str(srv.pools[0]["k"].dtype), wall_s=wall,
        tokens_per_s=m["tokens_per_sec"], ttft_p50_s=m["ttft_p50_s"],
        tpot_p50_s=m["tpot_p50_s"], steps=m["steps"],
        prefill_chunks=m["prefill_chunks"], preemptions=m["preemptions"],
        attn_bytes_per_token=m["attn_bytes_per_token"],
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts,
        attn_calls_per_decode_tick=min((t[attn] for t in decode_ticks), default=0),
        generated={rid: toks[:8] for rid, toks in out.items()},
    )
    if profile:
        res["decode_tick_profile"] = profile_decode_tick(
            torch, np, srv, cfg, np.random.default_rng(2))
    del srv, step_model
    torch.cuda.empty_cache()
    return res, out


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
    attn = [r for r in rows if "paged_attn" in r[0] or "kv_quant_scatter" in r[0]]
    srv.drain()
    return dict(tick_wall_ms=wall / n_ticks * 1e3, device_busy_ms=busy,
                attention_ms=sum(r[1] for r in attn),
                attention=[dict(kernel=k[:90], ms=ms, per_tick=c) for k, ms, c in attn],
                top=[dict(kernel=k[:90], ms=ms, per_tick=c) for k, ms, c in rows[:12]])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile Yi-9B decode ticks (phases 4 and 5) "
                    "with torch.profiler; the attention kernels' share is "
                    "named apart")
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
    del params

    # launches on each kernel's main path: the serving runs for the
    # attention, statistic and gather kernels, phase 6 for the FF kernels
    paths = {"tinylm": tiny_counts, "yi9b": yi["launches"],
             "yi9b_int8": quant["int8"]["launches"],
             "yi9b_fp8": quant["fp8"]["launches"], "ffn_entry_points": ff_counts}
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
        if "prefill" in r:  # attention: decode (the fields above) and prefill
            pre = sum(c.get(name + "_prefill", 0) for c in paths.values())
            p = r["prefill"]
            entry.update(launches_decode=n - pre, launches_prefill=pre,
                         prefill_ms=p["ms"], prefill_plain_ms=p["plain_ms"],
                         prefill_bound_ms=p["bound_ms"],
                         prefill_bound_by=p["bound_by"], prefill_at=p["at"])
        entries.append(entry)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "kernels": entries, "model": model, "yi9b": yi,
             "yi9b_quant": quant, "ffn_entry_points": ff,
             "tinylm_launches": tiny_counts, "lines": lines}, indent=1,
            default=str))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
