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
   ``GenerationEngine`` over 2 prompts of 512 tokens and 32 new tokens,
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
   widths F = 2816, 11264, 2048, 18432;
11. the recurrent families, after phase 10's models are freed: (a) the
   smoke RecurrentGemma-9B (RG-LRU, RG-LRU, local attention with a
   16-token window, GeGLU FF blocks) and Mamba2-1.3B (SSD, no FF) configs,
   fp32, matrices scaled by 2 so that greedy streams vary, every result
   equal to the same call on the CPU as in 10a (the prompts wrap the
   hybrid's ring); (b) RecurrentGemma-9B whole (38 layers, 8.58 B
   parameters, bf16, random weights from seed 0, matrices scaled by 2 as
   in 11a): the engine runs of 10b
   (dense, GRIFFIN 0.5 and 0.0, 38 ``expert_stat`` launches per GRIFFIN
   prefill) and a ``ContinuousBatcher`` of 2 slots over 4 requests of
   200/350/480/2100 prompt tokens and 16 new tokens (the last wraps the
   2048-token ring); (c) Mamba2-1.3B whole (48 layers, scaled the same):
   the dense engine run and the same batcher, with no kernel launched.  Phase 2 adds
   ``expert_stat`` at [2, 512, 12288] bf16, RecurrentGemma-9B's width,
   and says whether its time sits nearer F=11264's or 18432's;
12. the last four families, after phase 11's models are freed, each
   model freed before the next loads: (a) the smoke Gemma-3-27B (5 local
   layers with a 16-token window, one global), Command-R+, LLaVA-NeXT-34B
   and HuBERT-XLarge configs, fp32, matrices scaled by 2, every result
   equal to the same call on the CPU: Gemma-3 and Command-R+ through
   ``PagedServer`` fused and gather over prompts longer than the window,
   LLaVA's ``build_prefill_step`` over 8 patch embeddings and text then
   ``build_decode_step``, HuBERT's ``forward`` over frames and its
   per-layer flocking scores, ``launch.serve.main`` on all four;
   (b) Gemma-3-27B whole (62 layers, bf16): ``PagedServer`` with one slot
   and GRIFFIN 0.5 (one compacted copy: half its FF weights), then dense, over
   prompts of 700 and 1,300 tokens (the second crosses the 1024 window)
   and 32 new tokens; (c) Command-R+ at full width, cut to 8 layers: the
   same with 2 slots over phase 4's request lengths; (d) LLaVA-NeXT-34B
   at full width, cut to 30 layers: ``build_prefill_step`` at B=1 over
   2,880 patch embeddings and 256 text tokens and 32 decode steps, dense
   and GRIFFIN 0.5 (30 ``expert_stat`` launches at S=3,136), then the
   launcher's text-only ``ContinuousBatcher`` of 2 slots over
   200/350/480-token prompts; (e) HuBERT-XLarge whole: ``forward`` over
   [2, 1500, 1280] frames with statistics (48 ``expert_stat`` launches),
   wall, device time and busy time, and the per-layer flocking scores.
   Phase 2 adds ``paged_attn`` at Gemma-3's shape (H=32, KV=16, window
   1024, decode and a 32-row chunk past 1,100 cached tokens) and
   Command-R+'s (H=96, KV=8: a group of 12), and ``expert_stat`` at
   [1,32,21504], [1,32,33792], [1,3136,20480] and [2,1500,5120] bf16;
13. training, after phase 12's models are freed; no kernel launches while
   a model trains: (a) each reference arch's smoke config and tinylm
   (fp32, init drawn on the CPU): a backward on the card gives every
   gradient the loss reads, finite; 3 ``build_train_step`` AdamW steps
   on one fixed batch (tinylm also 8-bit Adam and ``accum_steps=2``), on
   the card and on the CPU: losses and parameters within
   ``TRAIN_CARD_TOL``, the loss falling on both; (b) tinylm trained with
   the reference's recipe (AdamW, ``warmup_cosine(3e-3, 25, 500)``,
   ``SyntheticCorpus`` batches of 16 x 256, 500 steps, fp32) through
   ``training/loop.train`` into a checkpoint directory: its losses at
   steps 0, 100, ..., 499 beside the reference's (``TINY_REF_LOSSES``;
   step 499 within ``TINY_LOSS_RTOL``); a second run preempted at step
   250 and resumed from its checkpoint ends within ``TINY_RESUME_ATOL``
   of the first; the checkpoint served by ``python -m
   repro_torch.launch.serve --arch tinylm --ckpt-dir``; ``generation_ppl``
   of full, GRIFFIN 0.5 and magnitude on 8 held-out 192-token sequences
   (prompt 128), printed; (c) Yi-9B whole (bf16, remat, 8-bit Adam):
   ``abstract_train_state``'s bytes, a backward's gradients present and
   finite, 4 steps on one fixed batch of 2 x 512 tokens with a finite,
   falling loss, the step's wall, a fifth step's device busy time
   (``torch.profiler``), peak memory, and its bounds: 8 N T bf16
   operations (remat runs the forward twice) and the optimizer's bytes;
   (d) the reference's examples (``repro_torch.examples``) on the card
   from (b)'s model, copied to where ``trained_tiny`` finds it (nothing
   retrains): ``quickstart`` as ``python -m``, ``serve_batched`` (its
   streams == the CPU's), ``flocking_analysis --emit-profile`` (the
   profile within ``EXAMPLE_PROFILE_TOL`` of the CPU's, served by
   ``launch.serve --tier 0.5 --sparsity-profile``), ``train_lm`` 3 steps
   into a checkpoint.
14. tensor-parallel paged serving (``distributed/tp.py``), one process per
   rank (``launch.mesh.run_ranks``), after phase 13's models are freed:
   (a) ``expert_stat_row_sq`` and ``expert_stat_from_norm`` (the
   statistic's two steps around the row norms' all-reduce) against their
   plain versions at Yi-9B TP=2 shapes (``TP_STAT_SHAPES``), and the
   composed path against the single launch at full F; ``paged_attn`` at
   the ranks' local head counts (16 Q / 2 KV, and 1 KV head); (b)
   tinylm-tp in fp32 at TP=2 and TP=4, all ranks on the card over gloo,
   over the reference's sharded-serving trace: streams equal on every
   rank, to one rank on the card and to the CPU (all with
   ``GriffinConfig(tp_shards=N)``), per-rank pool bytes total / N; (c)
   one NCCL rank equals the plain server; (d) Yi-9B at ``TP_YI_LAYERS``
   of its 48 layers, bf16, TP=2
   over gloo on the card through phase 4's prompts (``TP_YI_NEW`` new
   tokens each) beside one rank with the same selection math: streams equal across ranks, the first
   (dense) prefill chunk's logits and gathered statistics within
   ``TP_LOGIT_TOL`` / ``TP_STAT_TOL``; then, the ranks selecting from
   the one rank's statistic, the first decode step's logits within
   ``TP_LOGIT_TOL`` and the streams equal up to a token whose one-rank
   top-2 margin is within twice that step's gap; per-rank parameter, pool
   and compacted-FF bytes, the match rate and decode tick walls beside
   phase 4's (prefill chunks of ``TP_YI_CHUNK``); then the same ranks
   behind the mesh frontend (``serving/relay.py``): rank 0 serves phase
   8b's four concurrent ``POST /v1/generate`` on a free 127.0.0.1 port
   and relays each tick to rank 1, each request selecting as in the
   drain: the SSE streams == the drain's, the ranks' streams, aborts and
   free pages equal; tick walls, TTFT and peak memory a rank.
15. sharded training on the ``(data, model)`` training mesh
   (``distributed/tp.py::TrainTP``), one process per rank, all on the
   card over gloo, TF32 off, after phase 14's models are freed; no kernel
   launches: (a) the tier-1 tests' setups (the reference's
   ``prog_train_mesh.py`` yi config and tinylm, AdamW 1e-2, 3 steps, at
   (2, 2) with FSDP): card ranks == one rank on the card == CPU (losses
   within ``MESH_LOSS_TOL``, parameters within ``MESH_CARD_TOL``); (b)
   routed EP (Moonshot's smoke config) and 2-D EP (DeepSeek-V3's, with
   ``moe_group_limit=1``) on the MoE block, card ranks == CPU ranks
   (``MESH_MOE_TOL``); (c) the int8 error-feedback all-reduce on 4 data
   ranks (the reference's 20-step check), and an elastic run: one step
   at (2, 2), a checkpoint, re-meshed to (1, 2), one more step, its loss
   and parameters == one rank resumed from the same checkpoint; (d)
   Yi-9B at full width, 4 of its 48 layers, bf16, remat, at (2, 2) under
   ``policy_for``'s rules (FSDP), AdamW, 2 steps on one 4 x 512 batch,
   beside one rank: the first loss and every leaf's gradient within
   ``MESH_FULL_LOSS_TOL`` / ``MESH_FULL_GRAD_TOL``, which mutants without
   the backward all-reduce before the column-split projections and
   without the forward one after the row-split projections must fail
   each run; the loss falling; per-rank parameter and optimizer bytes by
   kind of leaf; step walls, all-reduces and bytes a step; (e)
   Moonshot-v1-16B-A3B at full width, 2 layers, routed EP at (1, 2)
   beside one rank: the same, the routed experts held in norm
   (``MESH_ROUTED_GRAD_TOL``) with the routing assignments that moved
   counted, mutants without the dispatch's backward all-reduce and
   without the combine's sum, expert bytes half a rank; (f) the MoE
   dispatch over several global chunks with assignments dropped, at
   Moonshot's full width (``MOE_CHUNKS``): without EP on (c)'s 4 data
   ranks and routed EP in (a)'s (2, 2) spawn, within ``MOE_CHUNK_TOL``
   of one rank's ``moe_forward`` at the reference's grouping, which the
   old per-row grouping must miss.
16. the dry-run and Yi-9B's serving cells (``launch/cells.py``,
   ``launch/dryrun.py``, ``analysis/``): (a) ``python -m
   repro_torch.launch.dryrun --all`` at one and two pods and DeepSeek-V3
   with ``--moe-group-limit 1`` at both, and ``--seq-parallel`` at one pod
   over the train and prefill cells of Yi-9B, Mamba2, RecurrentGemma and
   DeepSeek-V3, subprocesses started after the build on host cores of
   their own (``DRYRUN_CORES``; the measured phases keep the others),
   read after phase 17:
   every supported cell ``ok``
   (DeepSeek-V3's six without a group limit among them;
   ``DRYRUN_NOT_PORTED`` is empty), one line per cell (per-rank bytes,
   dominant term, bound); (b) Yi-9B at ``CELL_LAYERS`` of its 48
   layers, bf16, GRIFFIN 0.5, its
   prefill cell (2 x 4,096, cut from 32 x 32,768) and decode cell (4
   sequences over a 32,768-token cache at pos 32,767, cut from 128, on
   the prefill's compacted FF) at (1, 1), built by ``cells.build_cell``
   and ``materialize``: median wall of 5 (CUDA events), device busy
   share, peak memory beside the dry-run's input bytes, the analytic
   bound, model-FLOPs share and roofline fraction; logits, selection and
   compacted FF == ``GenerationEngine``'s on the same weights, cache and
   prompts (``CELL_ENGINE_TOL``); (c) the same cells at (2, 2), four
   gloo ranks on the one card: prefill and decode logits within
   ``TP_LOGIT_TOL`` of (b)'s, the selection (b)'s up to near-ties
   (``CELL_TIE_GAPS``, s-bar within ``TP_STAT_TOL``), each rank's recorded collectives equal to the dry
   mesh's for that rank and cell, decode run twice (the cache's
   ``kv_seq`` split under ``policy_for``'s rules, its ``head_dim`` split
   under the fallback with the KV heads off ``model``), and
   ``CELL_MUTANTS`` (the log-sum-exp merge without rescaling, the
   ``head_dim`` partial scores unsummed) each beyond ``TP_LOGIT_TOL``;
   launches the two-step ``expert_stat``.
17. the production mesh whole (all ranks on the card over gloo, each
   beside the same cells or step at (1, 1)): (a) smoke setups at (2, 2)
   (Mamba2, RecurrentGemma and the int8 cache at (1, 2)) on the card
   against one rank on the card, itself against one rank on the CPU
   (inputs drawn on the CPU): DeepSeek-V3 with its experts over
   (data, model) and no group limit (capacity 0.5: assignments drop),
   a train step from the mesh's init (its losses and synced gradient
   blocks) and its prefill and decode cells; Yi-9B's sequence-parallel
   train step (the same) and prefill cell; the SSM and
   RG-LRU mixers split over model; tinylm's int8 cache over head_dim,
   every write's codes equal to the whole head's; (b) DeepSeek-V3 at full
   width, 4 layers, no MTP, bf16, prefill and decode cells at (2, 2)
   against (1, 1) (``TP_LOGIT_TOL``; the routed experts' output in norm,
   ``MESH_MOE_OUT_TOL``), each rank's peak during its init beside its
   block bytes, mutants ``WHOLE_MUTANTS['17b']`` (the MoE block run again
   on its inputs); (c) Mamba2-1.3B (fp32, and bf16 held against the fp32
   (1, 1) cells within ``WHOLE_BF16_RATIO`` times the bf16 (1, 1) cells'
   distance from them) and RecurrentGemma-9B (bf16) whole at (1, 2),
   per-rank input bytes beside the dry-run's, the local-norm mutant on
   the fp32 decode cell; (d) Yi-9B's decode cell with an
   int8 cache over head_dim at (2, 2): codes to the bit, scales within
   ``WHOLE_SCALE_TOL`` of the whole head's quantization; (e) Yi-9B
   sequence-parallel: the prefill cell at (1, 2) against 16b's, 15d's
   train step at (2, 2) against its one rank, the mutant without the
   reduce-scatter.

The second-to-last line is a JSON object listing the kernels (for
``paged_attn`` and ``paged_attn_quant`` the main fields are the Yi-9B
decode case; ``prefill_*`` and ``verify_*`` give the prefill chunk's and
the verify call's time and bound, and ``launches_decode`` /
``launches_prefill`` / ``launches_verify`` split the launches by kind;
``griffin_ffn`` adds ``pass_ms``, its passes' device times, and
``compacted_ms``, the compacted products' time; ``expert_stat`` adds
``engine_*``, its numbers at phase 9b's prompt shape, ``moe_engine``,
its numbers at phase 10's widths, ``recurrent_engine``, at phase 11's,
and ``frontend_engine``, at phase 12's shapes; ``paged_attn`` adds
``gemma3_*`` and ``cmdr_*``, its phase 12 shapes, and ``yi9b_tp2_*`` /
``kv1_*``, phase 14's local head counts, and ``yi9b_one_prefill128``,
14d's one rank at its prefill chunk; ``expert_stat_row_sq`` and
``expert_stat_from_norm`` list all of 14a's shapes under ``cases``); the
last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import io
import json
import os
import shutil
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent


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
    over the peak rate for the inputs' type, whichever is larger (the H100
    SXM datasheet's rates, ``repro_torch/analysis/roofline.py``)."""
    from repro_torch.analysis import roofline

    t_b = bytes_ / roofline.HBM_BW * 1e3
    t_o = flops / roofline.peak_flops(dtype) * 1e3
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


def paged_attn_work(args, lens, scales=None, window: int = 0):
    """(bytes, operations) the step must at least move and do: read the
    cached K/V rows, the queries, the new rows, the table, positions and
    mask once; write the context and the new rows that exist once.  With
    a sliding ``window`` only the cached rows some query of the step sees
    are read, and a query attends at most ``window`` keys.

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
    seen = [n - max(0, n + 1 - window) if window else n for n in lens]
    byts = (sum(seen) * KV * hd * 2 * isz                   # cached K/V rows
            + (q.numel() + kn.numel() + vn.numel()) * q.element_size()
            + bt.numel() * 4 + pos.numel() * 4 + wm.numel()
            + B * S * H * hd * 4                            # ctx (fp32)
            + moved)
    # causal: query s of a request attends n + s + 1 keys; QK^T and PV
    flops = sum(4 * H * hd * min(n + s + 1, window or n + s + 1)
                for n in lens for s in range(S))
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


def device_breakdown(evs, n: int = 6):
    """Device busy time, record count and the ``n`` kernels (by short
    name) with the most device time, from ``fenced_device_events``."""
    import re

    by = {}
    for e in evs:
        name = re.sub(r"^.*?(\w+)[<(].*$", r"\1", e.name)[:60]
        by[name] = by.get(name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
    return dict(busy_ms=sum(by.values()), records=len(evs),
                top_ms=[(k, round(v, 3)) for k, v in top])


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
    # phase 12's paged models: Gemma-3-27B's local layers (window 1024,
    # 12b's one-slot table) and Command-R+'s group of 12 (12c's tables)
    gemma = dict(H=32, KV=16, hd=128, page=16, W=GEMMA_MAX_LEN // 16,
                 window=GEMMA_WINDOW)
    cmdr = dict(H=96, KV=8, hd=128, page=16, W=640 // 16)

    # -- paged_attn: decode (B=2, S=1), one prefill chunk (B=1) and a
    # speculative verify (B=2, S=5) ----------------------------------------
    worst = 0.0
    phase12 = {}
    gen12 = torch.Generator(device=dev)
    gen12.manual_seed(12)
    cases = [("yi-9b", "decode", 2, 1, [583, 431], dt, yi)
             for dt in (torch.float32, torch.bfloat16)]
    cases += [("yi-9b", "prefill", 1, 32, [448], dt, yi)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [("yi-9b", "verify", 2, 5, VERIFY_LENS, dt, yi)
              for dt in (torch.float32, torch.bfloat16)]
    cases += [("tinylm", "decode", 2, 1, [43, 28], torch.float32, tiny),
              ("tinylm", "prefill", 1, 16, [32], torch.float32, tiny)]
    # past 1,100 cached tokens, so whole pages fall below the window; the
    # chunk's rows straddle the window's lower edge
    cases += [("gemma3", "decode", 1, 1, [1331], torch.bfloat16, gemma),
              ("gemma3", "prefill", 1, 32, [1120], torch.bfloat16, gemma),
              ("cmdr", "decode", 2, 1, [583, 431], torch.bfloat16, cmdr),
              ("cmdr", "prefill", 1, 32, [448], torch.bfloat16, cmdr)]
    for model, label, B, S, lens, pool_dtype, shape in cases:
        shape = dict(shape)
        win = shape.pop("window", 0)
        # phase 12's cases draw from a generator of their own (the other
        # cases keep the draws they had before)
        g = gen12 if model in ("gemma3", "cmdr") else gen
        args = verify_case(torch, dev, pool_dtype, None, shape) if label == "verify" \
            else paged_attn_case(torch, g, B, S, lens, pool_dtype, dev, **shape)
        kern = [a.clone() for a in args]
        plain = [a.clone() for a in args]
        ctx_k, pk_k, pv_k = ops.paged_attention(*kern, window=win)
        ctx_r, pk_r, pv_r = ref.paged_attn_ref(*plain, window=win)
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
        ms = time_ms(torch, lambda: ops.paged_attention(*kern, window=win),
                     flush=flush)
        plain_ms = time_ms(torch, lambda: ref.paged_attn_ref(*plain, window=win),
                           flush=flush)
        byts, flops = paged_attn_work(args, lens, window=win)
        b_ms, b_by = bound(byts, flops, str(pool_dtype).split(".")[-1])
        at = f"{label} B={B} S={S} ctx={lens} H={shape['H']} KV={shape['KV']}" \
            + (f" window={win}" if win else "") + f" {dt} pool"
        lines.append(f"paged_attn {model} {label:7s} pool={dt} B={B} S={S} "
                     f"ctx={lens}" + (f" window={win}" if win else "")
                     + f": kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                     f"bound {b_ms:.5f} ms ({b_by})  max_abs_err {err:.3g}")
        if model in ("gemma3", "cmdr"):
            phase12[f"{model}_{label}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                max_abs_err=err, at=at)
        if model == "yi-9b" and dt == "bf16":
            kind = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                        at=f"{label} B={B} S={S} ctx={lens} bf16 pool")
            if label == "decode":
                results["paged_attn"] = dict(kind, library_ms=None)
            else:
                results["paged_attn"][label] = kind
    results["paged_attn"]["max_abs_err"] = worst
    results["paged_attn"]["phase12"] = phase12
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
    """Every layer's projection matrices times ``s`` (not the RG-LRU gate
    blocks ``w_a`` / ``w_i``)."""
    for lp in params["layers"]:
        for group in ("mixer", "ffn"):
            for k, v in lp.get(group, {}).items():
                if k.startswith("w") and k not in ("w_a", "w_i"):
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


def serve_paged(torch, np, dev, cfg, params, prompts, kv_dtype: str,
               profile: bool = False, griffin: bool = True, spec_k: int = 0,
               name: str = "yi-9b", n_slots: int = 2, max_len: int = 640,
               num_pages: int = 256):
    """``PagedServer`` (GRIFFIN 0.5, or dense with ``griffin=False``;
    speculative rounds of up to ``spec_k`` drafts, fused and adaptive, when
    ``spec_k`` is set; ``kernel_backend="auto"``; pages of 16, chunks of
    32, ``n_slots`` slots) over ``prompts``, the 4 Yi-9B requests unless
    another model's are given; returns the numbers and the full token
    streams.  Every logit the server reads must be finite.  Each tick is
    timed on the host clock up to a ``synchronize``: the median decode
    tick (no prefill chunk, a one-token decode) and spec round (no
    prefill chunk, a verify) are reported.  The server is dropped before
    returning."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.serving.server import PagedServer

    what = f"{name} {kv_dtype}" + (" dense" if not griffin else "") \
        + (f" spec_k={spec_k}" if spec_k else "")
    torch.cuda.reset_peak_memory_stats()
    srv = PagedServer(cfg, params,
                      gcfg=GriffinConfig(sparsity=0.5) if griffin else None,
                      page_size=16, num_pages=num_pages, n_slots=n_slots,
                      prefill_chunk=32, max_len=max_len, kernel_backend="auto",
                      device=dev, kv_dtype=kv_dtype, spec_k=spec_k)
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
    compacted_gb = None  # allocated once the first request has compacted
    t0 = time.perf_counter()
    while True:
        before = launches()
        t_tick = time.perf_counter()
        more = srv.step()
        torch.cuda.synchronize()
        t_tick = time.perf_counter() - t_tick
        after = launches()
        ticks.append(({k: after[k] - before[k] for k in after}, t_tick))
        if compacted_gb is None and srv._compacted:
            compacted_gb = torch.cuda.memory_allocated() / 1e9
        if not more:
            break
    wall = time.perf_counter() - t0
    counts = launches()
    out = {rid: r.generated for rid, r in srv.sched.finished.items()}
    check(sorted(out) == list(range(len(prompts))), f"{what} finished {sorted(out)}")
    for rid, toks in out.items():
        check(len(toks) == prompts[rid][1]
              and all(0 <= t < cfg.vocab_size for t in toks),
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
        allocated_after_first_compaction_gb=compacted_gb,
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
YI_ENGINE = dict(B=2, S=512, steps=32)
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
    says how many it holds (a trace short of ``n_stat`` lost records).
    An engine without GRIFFIN decodes on the dense FF.  Each traced try
    of the decode steps starts from the cache the last one left: KV slots
    are rewritten, recurrent states move on, which changes no step's
    work."""
    from repro_torch.models import decoder

    B, S = prompts.shape
    state, walls = {}, {"prefill": [], "decode": []}

    def prefill():
        t0 = time.perf_counter()
        _, aux = eng.prefill(prompts)
        state["pruned"] = eng.select_and_compact(aux.stats) if eng.gcfg else None
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
                profile_kw=None, profiled: str = "griffin"):
    """``GenerationEngine`` over ``prompts`` [B, S] (on the card) and
    ``steps`` new tokens for each ``(name, gcfg)`` of ``variants``:
    prefill, GRIFFIN's selection and every decode step timed on the host
    clock after a ``synchronize``, each engine after an untimed warm-up
    call; every decode logit finite; ``expert_stat`` launched ``n_stat``
    times per GRIFFIN prefill and nothing else launched.  ``profile``
    adds ``profile_engine``'s breakdown of the ``profiled`` variant
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
        if profile and name == profiled:
            del eng.prefill, eng.select_and_compact, eng.decode  # untimed
            res[f"{name}_profile"] = profile_engine(torch, eng, prompts,
                                                    **(profile_kw or {}))
        del eng
    return total, res, streams


def phase_engine_yi9b(torch, np, dev, cfg, params, profile: bool = False):
    """9b, Yi-9B at full size (bf16, random weights from seed 0):
    ``engine_runs`` over B=2 prompts of 512 tokens and 32 new tokens,
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


def engine_shape_expert_stat(torch, dev, F: int, dtypes=None, B=None, S=None):
    """``expert_stat`` at [B, S, F], by default the engine's whole-prompt
    shape [2, 512, F] (``dtypes``: fp32 and bf16 unless given), against
    its plain version under phase 2's tolerance, each timed beside its
    bound and its plain version (the launches here count toward no
    path)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    B, S = B or YI_ENGINE["B"], S or YI_ENGINE["S"]
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

# ---------------------------------------------------------------------------
# phase 11: the recurrent families (Mamba2 SSD, the RG-LRU hybrid) through
# the same engines and fallback (phase 10's functions)
# ---------------------------------------------------------------------------

#: the archs of phase 11
RECURRENT = ("recurrentgemma-9b", "mamba2-1.3b")
#: 11b/11c's batcher prompt lengths: the last wraps RecurrentGemma's
#: 2048-token local-attention ring at full width
RECURRENT_BATCHER_LENS = (200, 350, 480, 2100)
#: RecurrentGemma-9B's FF width, for phase 2's ``expert_stat`` row at the
#: engine's [2, 512, F] bf16 shape
RECURRENT_STAT_WIDTH = 12288


def phase_families_smoke(torch, np, dev, archs=FAMILIES, tag="10a", scale=None):
    """10a / 11a, the smoke configs of ``archs`` (fp32, TF32 off, weights
    drawn on the CPU from seed 0, their matrices times ``scale`` if
    given, and copied to the card), every result held to the same call
    on the CPU: ``GenerationEngine`` greedy tokens dense and with GRIFFIN
    0.5; a ``ContinuousBatcher`` of 2 slots over 4 requests of mixed
    lengths with GRIFFIN 0.5; ``launch.serve.main`` through its
    slot-batcher fallback.  ``expert_stat`` launches once per prunable FF
    block (dense layer, shared experts, a hybrid block's GeGLU) of every
    prefill with statistics, and nothing else launches (an arch without
    an FF block runs GRIFFIN-free and launches nothing).  Returns the
    card runs' launches and the results."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.models import decoder
    from repro_torch.serving.engine import ContinuousBatcher, GenerationEngine

    total, res = {}, {}
    rng = np.random.default_rng(10)
    for arch in archs:
        cfg = get_config(arch, smoke=True)
        host = decoder.init_params(cfg, seed=0, device="cpu")
        if scale is not None:
            scale_matrices(host, scale)
        card = to_device(host, dev)
        n_ff = len(decoder.extract_ffn_tree(host, cfg))

        def both(what, fn):
            return on_both(torch, dev, card, host, total, f"{tag} {arch} {what}", fn)

        prompts = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
        for name, g in (("dense", None), ("griffin", dict(sparsity=0.5))):
            gcfg = None if g is None else GriffinConfig(**g)
            got, want, counts = both(f"engine {name}", lambda d, p: GenerationEngine(
                cfg, p, gcfg, max_len=48, device=d).generate(prompts, 16).cpu())
            check(torch.equal(got, want), f"{tag} {arch} engine {name}: card {got} "
                  f"!= CPU {want}")
            check(len(torch.unique(want)) > 4, f"{tag} {arch} engine {name}: "
                  f"degenerate {want}")
            check(only(counts, expert_stat=n_ff if gcfg else 0),
                  f"{tag} {arch} engine {name} launches {counts}")
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
        check(got == want, f"{tag} {arch} batcher: card {got} != CPU {want}")
        check({k: len(v) for k, v in got.items()} == {i: m for i, (_, m) in
                                                      enumerate(reqs)},
              f"{tag} {arch} batcher lengths {got}")
        check(only(counts, expert_stat=n_ff * len(reqs)),
              f"{tag} {arch} batcher launches {counts}")
        res[f"{arch} batcher"] = got[0]

        argv = ["--arch", arch, "--requests", "4", "--max-len", "64"]
        (out_c, text), (out_h, _), counts = both("launcher", lambda d, p: launcher(
            argv + ["--device", d.type]))
        check(out_c == out_h, f"{tag} {arch} launcher: card {out_c} != CPU {out_h}")
        check("slots: served 4 requests" in text
              and (counts["expert_stat"] > 0) == (n_ff > 0),
              f"{tag} {arch} launcher: {text} launches {counts}")
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


def phase_family_full(torch, np, dev, cfg, params, tag: str, batcher_lens=None,
                      profile: bool = False):
    """10b / 10c / 11b / 11c: ``engine_runs`` over B=2 prompts of 512
    tokens and 32 new tokens, dense, GRIFFIN 0.5 and GRIFFIN 0.0
    (``expert_stat`` once per prunable FF block of a GRIFFIN prefill).
    GRIFFIN 0.0 must give the dense stream token for token, and its
    compaction (k = F) every column in order.  A model without an FF
    block (Mamba2) runs dense only and launches nothing.  ``batcher_lens``
    adds a ``ContinuousBatcher`` of 2 slots serving one request of each
    prompt length with 16 new tokens and GRIFFIN 0.5.  ``profile`` adds
    ``profile_engine``'s breakdown of the GRIFFIN 0.5 engine (of the
    dense one without GRIFFIN).  Returns the launches and the numbers."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.models import decoder

    B, S, steps = FAMILY_ENGINE["B"], FAMILY_ENGINE["S"], FAMILY_ENGINE["steps"]
    rng = np.random.default_rng(5)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                               .astype(np.int32)).to(dev)
    n_ff = len(decoder.extract_ffn_tree(params, cfg))
    griffin = cfg.griffin and n_ff > 0
    variants = (("dense", None), ("griffin", GriffinConfig(sparsity=0.5)),
                ("griffin0", GriffinConfig(sparsity=0.0))) if griffin \
        else (("dense", None),)
    total, res, streams = engine_runs(
        torch, dev, cfg, params, prompts, steps, variants, n_ff, tag, profile,
        # a Moonshot prefill is ~9,000 device records: its traces have
        # come back short of records in every try, so keep them
        dict(n_steps=2, strict=False), profiled="griffin" if griffin else "dense")
    if griffin:
        check_griffin_zero(torch, dev, cfg, params, prompts, steps, streams, res, tag)
    return batcher_run(torch, np, dev, cfg, params, rng, n_ff, batcher_lens,
                       total, res, tag)


def check_griffin_zero(torch, dev, cfg, params, prompts, steps, streams, res, tag):
    """GRIFFIN 0.0 gives the dense stream, and its compaction (k = F)
    keeps every column of every prunable FF block in order."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.models import decoder
    from repro_torch.serving.engine import GenerationEngine

    S = prompts.shape[1]
    check(torch.equal(streams["griffin0"], streams["dense"]),
          f"{tag}: GRIFFIN 0.0 {streams['griffin0']} != dense {streams['dense']}")
    res["token_match_griffin_vs_dense"] = float(
        (streams["griffin"] == streams["dense"]).float().mean())
    # how much the equality above says: one distinct token is a stream
    # that repeats itself
    res["distinct_tokens_dense"] = len(torch.unique(streams["dense"]))
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


def batcher_run(torch, np, dev, cfg, params, rng, n_ff, lens, total, res, tag):
    """A ``ContinuousBatcher`` of 2 slots over one request of each prompt
    length in ``lens`` (none when ``lens`` is None), 16 new tokens each,
    GRIFFIN 0.5 (dropped by a model without an FF block): tokens/s, peak
    memory, ``expert_stat`` once per prunable FF block of each insert
    and nothing else launched.  Returns (launches, numbers)."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.serving.engine import ContinuousBatcher

    if lens is None:
        return total, res
    new = FAMILY_BATCHER["new"]
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


# ---------------------------------------------------------------------------
# phase 12: the last four families: Gemma-3-27B and Command-R+ through
# PagedServer, LLaVA-NeXT-34B's image + text prefill, HuBERT-XLarge's
# encoder
# ---------------------------------------------------------------------------

#: the archs of phase 12
FRONTENDS = ("gemma3-27b", "command-r-plus-104b", "llava-next-34b", "hubert-xlarge")
#: Gemma-3-27B's local-attention window, and 12b's server: pages of 16 up
#: to the longest request (1,300 prompt + 32 new tokens)
GEMMA_WINDOW = 1024
GEMMA_MAX_LEN = 1344
#: 12b's prompt lengths: the second crosses the window
GEMMA_LENS = (700, 1300)
#: 12d: patch embeddings (LLaVA-NeXT's anyres: 576 + 4 tiles of 576), text
#: tokens and new tokens of the prefix prefill; the batcher's prompt lengths
LLAVA_PREFILL = dict(P=2880, T=256, G=32)
LLAVA_BATCHER_LENS = RECURRENT_BATCHER_LENS[:3]
#: 12e: two clips of 30 s of audio at HuBERT's 50 frames/s
HUBERT_FRAMES = dict(B=2, S=1500)
#: phase 12's statistic shapes [B, S, F], for phase 2's ``expert_stat``
#: rows: a Gemma-3 and a Command-R+ prefill chunk, the LLaVA prompt of 12d
#: and HuBERT's clips
FRONTEND_STAT_SHAPES = ((1, 32, 21504), (1, 32, 33792), (1, 3136, 20480),
                        (2, 1500, 5120))


def phase_frontends_smoke(torch, np, dev):
    """12a, the smoke configs of the four (fp32, TF32 off, weights drawn
    on the CPU from seed 0, projection matrices times 2 so that greedy
    streams vary, and copied to the card), every result held to the same
    call on the CPU: Gemma-3 (window 16) and Command-R+ through
    ``PagedServer``, fused and gather, over prompts longer than the window
    (``expert_stat`` once per FF layer and prefill chunk); LLaVA's
    ``build_prefill_step`` over 8 patch embeddings and 12 text tokens,
    then ``build_decode_step`` on the compacted FF (one ``expert_stat``
    launch per FF layer, in the prefill); HuBERT's ``forward`` over frames
    with statistics (one launch per FF layer) and its per-layer flocking
    scores; ``launch.serve.main`` on all four.  Returns the card runs'
    launches and the results."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import flocking
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.models import decoder
    from repro_torch.serving import steps
    from repro_torch.serving.server import PagedServer

    total, res = {}, {}
    rng = np.random.default_rng(12)
    for arch in FRONTENDS:
        cfg = get_config(arch, smoke=True)
        host = decoder.init_params(cfg, seed=0, device="cpu")
        scale_matrices(host, 2.0)
        card = to_device(host, dev)
        n_ff = len(decoder.extract_ffn_tree(host, cfg))

        def both(what, fn):
            return on_both(torch, dev, card, host, total, f"12a {arch} {what}", fn)

        if decoder.supports_paged(cfg):
            prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 8)
                       for n in (20, 37, 29)]
            kw = dict(page_size=8, num_pages=48, n_slots=2, prefill_chunk=16,
                      max_len=64)
            for backend in ("fused", "gather"):
                def run(d, p):
                    srv = PagedServer(cfg, p, gcfg=GriffinConfig(sparsity=0.5),
                                      kernel_backend=backend if d.type == "cuda"
                                      else "gather", device=d, **kw)
                    return serve(srv, prompts), srv.metrics.summary()["prefill_chunks"]

                (got, chunks), (want, _), counts = both(f"paged {backend}", run)
                what = f"12a {arch} {backend}"
                check(got == want, f"{what}: card {got} != CPU {want}")
                check(len({t for v in got.values() for t in v}) > 4,
                      f"{what}: degenerate {got}")
                attn = "paged_attn" if backend == "fused" else "paged_gather"
                check(counts[attn] > 0 and counts["expert_stat"] == n_ff * chunks
                      and all(counts[k] == 0 for k in counts
                              if k not in (attn, "paged_attn_prefill", "expert_stat")),
                      f"{what} launches {counts} ({chunks} chunks)")
                res[f"{arch} paged_{backend}"] = got[0]
        elif cfg.family == "vlm":
            P, T, G = cfg.num_prefix_embeddings, 12, 6
            toks = rng.integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
            pre = rng.standard_normal((2, P, cfg.d_model)).astype(np.float32)

            def run(d, p):
                out = steps.build_prefill_step(cfg, GriffinConfig(sparsity=0.5))(
                    p, torch.from_numpy(toks).to(d), torch.from_numpy(pre).to(d))
                cache = decoder.fill_cache_from_prefill(
                    cfg, decoder.init_cache(cfg, 2, P + T + G, d), out["kv"])
                step = steps.build_decode_step(cfg, True)
                tok = out["last_logits"].argmax(-1)[:, None].to(torch.int32)
                gen = [tok]
                for t in range(G):
                    logits, cache = step(p, cache, out["pruned"], tok, P + T + t)
                    tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
                    gen.append(tok)
                return torch.cat(gen, 1).cpu(), out["last_logits"].cpu()

            (got, lg_c), (want, lg_h), counts = both("prefill+decode", run)
            check(torch.equal(got, want), f"12a {arch}: card {got} != CPU {want}")
            check(torch.allclose(lg_c, lg_h, rtol=EVAL_RTOL, atol=EVAL_RTOL),
                  f"12a {arch}: last logits differ by "
                  f"{(lg_c - lg_h).abs().max().item()}")
            check(only(counts, expert_stat=n_ff), f"12a {arch} launches {counts}")
            res[f"{arch} prefix_prefill_decode"] = got[0].tolist()
        else:
            frames = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)

            def run(d, p):
                h, aux = decoder.forward(p, cfg, None, torch.from_numpy(frames).to(d),
                                         collect_stats=True, want_z=True,
                                         logits_mode="none")
                return h.cpu(), [[flocking.flocking_score(st["z"][b]) for b in range(2)]
                                 for _, st in sorted(aux.stats.items())]

            (h_c, sc_c), (h_h, sc_h), counts = both("encoder", run)
            check(torch.allclose(h_c, h_h, rtol=EVAL_RTOL, atol=EVAL_RTOL),
                  f"12a {arch}: hidden states differ by {(h_c - h_h).abs().max().item()}")
            check(np.isfinite(sc_c).all() and np.allclose(sc_c, sc_h, rtol=0, atol=1e-6),
                  f"12a {arch}: flocking scores card {sc_c} != CPU {sc_h}")
            check(only(counts, expert_stat=n_ff), f"12a {arch} launches {counts}")
            res[f"{arch} flocking"] = sc_c

        argv = ["--arch", arch, "--requests", "2", "--max-len", "64"]
        (out_c, text), (out_h, _), counts = both("launcher", lambda d, p: launcher(
            argv + ["--device", d.type]))
        served = "paged: served 2 requests" if decoder.supports_paged(cfg) \
            else "slots: served 2 requests"
        check(out_c == out_h, f"12a {arch} launcher: card {out_c} != CPU {out_h}")
        check(served in text and (counts["expert_stat"] > 0) == cfg.griffin,
              f"12a {arch} launcher: {text} launches {counts}")
        res[f"{arch} launcher"] = [ln for ln in text.splitlines() if "served" in ln]
    return total, res


def free(torch):
    gc.collect()
    torch.cuda.empty_cache()


def phase_paged_family(torch, np, dev, arch: str, lens, n_slots: int,
                       max_len: int, profile: bool = False, **over):
    """12b / 12c: ``arch`` at full width (``over`` cuts its depth), bf16,
    random weights from seed 0 drawn on the card, matrices scaled by 2
    (as phase 11's), through ``serve_paged``'s
    ``PagedServer`` with GRIFFIN 0.5 and then dense on the same weights,
    over one request of each prompt length in ``lens`` with 32 new tokens:
    ``expert_stat`` once per FF layer and prefill chunk of the GRIFFIN
    server, none in the dense one.  Returns the launches and numbers."""
    from repro_torch.models import decoder

    cfg, params, model = family_model(torch, dev, arch, **over)
    # at the init's scale every greedy stream repeats one token
    scale_matrices(params, 2.0)
    rng = np.random.default_rng(13)
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), 32) for n in lens]
    n_ff = len(decoder.extract_ffn_tree(params, cfg))
    kw = dict(name=f"{arch} ({cfg.num_layers} layers)", n_slots=n_slots,
              max_len=max_len, num_pages=2 * max_len // 16)
    total, res = {}, dict(model=model)
    streams = {}
    for name, griffin in (("griffin", True), ("dense", False)):
        r, streams[name] = serve_paged(torch, np, dev, cfg, params, prompts, "fp32",
                                      profile, griffin=griffin, **kw)
        want = n_ff * r["prefill_chunks"] if griffin else 0
        check(r["launches"]["expert_stat"] == want,
              f"{arch} {name}: expert_stat {r['launches']['expert_stat']} != {want}")
        add_counts(total, r["launches"])
        res[name] = r
    res["griffin"]["expert_stat_per_request"] = [n_ff * -(-n // 32) for n in lens]
    res["token_match_griffin_vs_dense"] = match_rate(streams["griffin"], streams["dense"])
    # how much the match says: a stream of one distinct token repeats itself
    res["distinct_tokens_per_request"] = {
        name: [len(set(v)) for _, v in sorted(st.items())] for name, st in streams.items()}
    del params
    free(torch)
    return total, res


def phase_llava(torch, np, dev, profile: bool = False):
    """12d: LLaVA-NeXT-34B at full width, cut to 30 layers, bf16, random
    weights from seed 0: ``build_prefill_step`` at B=1 over 2,880 random
    patch embeddings and 256 text tokens, then 32 ``build_decode_step``
    steps over a contiguous cache of P + T + G, dense and with GRIFFIN 0.5
    (30 ``expert_stat`` launches at [1, 3136, 20480], in the prefill, and
    nothing else launched); then the launcher's text-only fallback, a
    ``ContinuousBatcher`` of 2 slots over 200/350/480-token prompts.
    ``profile`` adds ``device_breakdown`` of a dense prefill.  Returns the
    launches and numbers."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.models import decoder
    from repro_torch.serving import steps

    cfg, params, model = family_model(torch, dev, "llava-next-34b", num_layers=30)
    n_ff = len(decoder.extract_ffn_tree(params, cfg))
    P, T, G = LLAVA_PREFILL["P"], LLAVA_PREFILL["T"], LLAVA_PREFILL["G"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    pre = torch.randn(1, P, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)
    toks = torch.randint(0, cfg.vocab_size, (1, T), generator=gen, device=dev,
                         dtype=torch.int32)
    total, res, streams = {}, dict(model=model), {}
    for name, gcfg in (("dense", None), ("griffin", GriffinConfig(sparsity=0.5))):
        prefill = steps.build_prefill_step(cfg, gcfg)
        decode = steps.build_decode_step(cfg, gcfg is not None)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = prefill(params, toks, pre)
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        prefill_counts = launches()
        check(only(prefill_counts, expert_stat=n_ff if gcfg else 0),
              f"12d {name} prefill launches {prefill_counts}")
        after_prefill_gb = torch.cuda.memory_allocated() / 1e9
        cache = decoder.fill_cache_from_prefill(
            cfg, decoder.init_cache(cfg, 1, P + T + G, dev), out.pop("kv"))
        tok = out["last_logits"].argmax(-1)[:, None].to(torch.int32)
        gen_toks, tpot = [tok], []
        for t in range(G):
            t1 = time.perf_counter()
            logits, cache = decode(params, cache, out["pruned"], tok, P + T + t)
            tok = logits[:, 0].argmax(-1)[:, None].to(torch.int32)
            torch.cuda.synchronize()
            tpot.append(time.perf_counter() - t1)
            check(bool(torch.isfinite(logits).all()), f"12d {name}: non-finite logits")
            gen_toks.append(tok)
        counts = launches()
        check(counts == prefill_counts, f"12d {name}: decode launched "
              f"{ {k: counts[k] - prefill_counts[k] for k in counts} }")
        add_counts(total, counts)
        streams[name] = torch.cat(gen_toks, 1)
        res[name] = dict(prompt=P + T, prefill_ms=prefill_s * 1e3,
                         tpot_p50_ms=statistics.median(tpot) * 1e3,
                         decode_tokens_per_s=G / sum(tpot),
                         allocated_after_prefill_gb=after_prefill_gb,
                         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                         expert_stat=counts["expert_stat"],
                         tokens=streams[name][0, :8].tolist())
        del out, cache, logits
        free(torch)
    res["token_match_griffin_vs_dense"] = float(
        (streams["griffin"] == streams["dense"]).float().mean())
    if profile:
        dense = steps.build_prefill_step(cfg, None)
        res["dense_prefill_profile"] = device_breakdown(
            fenced_device_events(torch, lambda: dense(params, toks, pre)))
        free(torch)
    total, res = batcher_run(torch, np, dev, cfg, params, np.random.default_rng(15),
                             n_ff, LLAVA_BATCHER_LENS, total, res, "12d")
    del params
    free(torch)
    return total, res


def phase_hubert(torch, np, dev):
    """12e: HuBERT-XLarge whole, bf16, random weights from seed 0:
    ``forward`` over [2, 1500, 1280] random frames with statistics and
    activations (48 ``expert_stat`` launches at [2, 1500, 5120], nothing
    else), timed on the host clock and by CUDA events, its device busy
    time and heaviest kernels from ``torch.profiler``; then
    ``flocking_score`` of every layer's
    activations per clip (finite).  Returns the launches and numbers."""
    from repro_torch.core import flocking
    from repro_torch.models import decoder

    cfg, params, model = family_model(torch, dev, "hubert-xlarge")
    B, S = HUBERT_FRAMES["B"], HUBERT_FRAMES["S"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(16)
    frames = torch.randn(B, S, cfg.d_model, generator=gen, device=dev).to(torch.bfloat16)

    def fwd():
        return decoder.forward(params, cfg, None, frames, collect_stats=True,
                               want_z=True, logits_mode="none")

    fwd()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    ev0.record()
    h, aux = fwd()
    ev1.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    check(only(counts, expert_stat=cfg.num_layers), f"12e launches {counts}")
    check(tuple(h.shape) == (B, S, cfg.d_model) and bool(torch.isfinite(h).all()),
          f"12e hidden states {tuple(h.shape)} not finite")
    peak = torch.cuda.max_memory_allocated() / 1e9
    t0 = time.perf_counter()
    scores = [[flocking.flocking_score(aux.stats[li]["z"][b]) for b in range(B)]
              for li in range(cfg.num_layers)]
    flock_s = time.perf_counter() - t0
    check(np.isfinite(scores).all(), f"12e flocking scores {scores}")
    prof = device_breakdown(fenced_device_events(torch, fwd))
    res = dict(model=model, frames=[B, S], forward_wall_ms=wall * 1e3,
               forward_event_ms=ev0.elapsed_time(ev1),
               forward_busy_ms=prof.pop("busy_ms"), forward_profile=prof,
               peak_mem_gb=peak, expert_stat=counts["expert_stat"],
               flocking_wall_s=flock_s,
               flocking_by_layer=[round(float(np.mean(s)), 4) for s in scores])
    del params, h, aux
    free(torch)
    return counts, res


# ---------------------------------------------------------------------------
# phase 13: training on the card (decoder.loss_fn and its backward, the
# optimizers, the train step, the loop, checkpoints, the launcher)
# ---------------------------------------------------------------------------

#: 13a: (optimizer, accum_steps) runs of every smoke arch; tinylm adds 8-bit
#: Adam and two microbatches
TRAIN_SMOKE_RUNS = (("adamw", 1),)
TRAIN_TINY_RUNS = (("adamw", 1), ("adam8bit", 1), ("adamw", 2))
TRAIN_SMOKE_LR = 1e-3
#: card against CPU after 3 steps: losses within ``rtol``; parameters within
#: ``rtol``/``atol`` except at most a share ``few`` of all elements, each
#: within ``few_atol``: three steps of about lr each.  Adam's first
#: updates are lr * g / (|g| + eps), so an element whose gradient is a few
#: ulps from 0 on either device moves by another share of lr, a leaf whose
#: gradient is 0 but for rounding (an encoder's key bias) moves at random,
#: and 8-bit Adam adds moment codes that round apart (8-bit tinylm: one
#: element 1.04e-3 apart, one lr and a bit, on the H100).  MoE dispatch
#: gradients are summed by atomics on the card, so nothing here is held
#: bit for bit.
TRAIN_CARD_TOL = dict(rtol=1e-4, atol=1e-5, few=5e-3, few_atol=3 * TRAIN_SMOKE_LR)

#: 13b: the reference's recipe for the trained tinylm
#: (``benchmarks/common.py::trained_tiny``)
TINY_RECIPE = dict(peak_lr=3e-3, warmup=25, steps=500, batch=16, seq=256,
                   preempt_at=250)
#: the JAX package's losses under that recipe at these steps
#: (``scripts/reference_tinylm_curve.py``: ``repro.training.loop.train``,
#: ``PRNGKey(0)`` init, on a CPU).  The port draws another init, so the
#: curves agree only in their trend; step 499's loss is held within
#: ``TINY_LOSS_RTOL``.
TINY_REF_LOSSES = {0: 8.213449478149414, 100: 2.3450851440429688,
                   200: 2.302034854888916, 300: 2.2390644550323486,
                   400: 2.2318639755249023, 499: 2.1899240016937256}
TINY_LOSS_RTOL = 0.03
#: a resumed run's final parameters against the uninterrupted run's (both
#: on the card, deterministic algorithms on)
TINY_RESUME_ATOL = 1e-5
#: held-out sequences (``benchmarks/common.py::eval_sequences`` and
#: ``benchmarks/run.py``'s Table 2: 8 x 192 tokens, prompt 128)
TINY_EVAL = dict(n=8, length=192, P=128, seed=123,
                 methods=("full", "griffin", "magnitude"))

#: 13c: Yi-9B whole, 8-bit Adam, one fixed batch
YI_TRAIN = dict(B=2, S=512, steps=4, lr=1e-4)


def train_batch(np, cfg, seed: int, B: int = 2, S: int = 48):
    """``tests/test_archs_smoke.py``'s batch shapes, from numpy."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encoder":
        return {"prefix_emb": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
                "targets": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        P = cfg.num_prefix_embeddings
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, S - P)).astype(np.int32),
                "prefix_emb": rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}


def tree_tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_tensors(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in tree_tensors(v)]
    return [tree]


def trees_close(torch, a, b, rtol, atol, few, few_atol):
    """(ok, worst abs difference, share of all elements outside
    ``rtol``/``atol``) of two trees of tensors, leaf for leaf."""
    worst, off, n = 0.0, 0, 0
    for x, y in zip(tree_tensors(a), tree_tensors(b)):
        x, y = x.detach().float().cpu(), y.detach().float().cpu()
        d = (x - y).abs()
        worst = max(worst, float(d.max()) if d.numel() else 0.0)
        off += int((d > atol + rtol * y.abs()).sum())
        n += d.numel()
    share = off / max(n, 1)
    return worst <= max(atol, few_atol) and share <= few, worst, share


def grads_read(tree, cfg):
    """The leaves of a ``value_and_grad`` tree the loss read: all but an
    encoder's token table (its frames come in as ``prefix_emb``)."""
    skip = cfg.family == "encoder"
    out = []
    for k, v in tree.items():
        if skip and k == "embed":
            continue
        out.extend(tree_tensors(v))
    return out


def phase_train_smoke(torch, np, dev):
    """13a: each reference arch's smoke config and tinylm (fp32, init drawn
    on the CPU): 3 ``build_train_step`` steps on one fixed batch, on the
    card and on the CPU; losses and parameters within ``TRAIN_CARD_TOL``,
    the loss falling on both, every gradient of a backward on the card
    present and finite, and no kernel launched while training."""
    from repro_torch.configs.registry import ASSIGNED_ARCHS, get_config
    from repro_torch.models import decoder
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_step as ts

    res = {}
    total = {}
    for arch in list(ASSIGNED_ARCHS) + ["tinylm"]:
        cfg = get_config(arch, smoke=arch != "tinylm")
        host_batch = {k: torch.from_numpy(v) for k, v in
                      train_batch(np, cfg, 0, B=4 if arch == "tinylm" else 2).items()}
        # a backward on the card: every gradient the loss reads is there
        params = to_device(decoder.init_params(cfg, 0, "cpu"), dev)
        reset_launches()
        _, _, grads = ts.value_and_grad(decoder.loss_fn, params,
                                        to_device(host_batch, dev), cfg)
        counts = launches()
        check(sum(counts.values()) == 0, f"13a {arch} backward launched {counts}")
        read = grads_read(grads, cfg)
        check(all(g is not None for g in read), f"13a {arch}: a gradient is None")
        check(bool(torch.stack([torch.isfinite(g).all() for g in read]).all()),
              f"13a {arch}: a gradient is not finite")
        del params, grads
        for name, accum in (TRAIN_TINY_RUNS if arch == "tinylm" else TRAIN_SMOKE_RUNS):
            out = []
            for d in (dev, torch.device("cpu")):
                opt = opt_lib.get_optimizer(name, TRAIN_SMOKE_LR)
                state = to_device(ts.init_train_state(cfg, opt, 0, "cpu"), d)
                step = ts.build_train_step(cfg, opt, accum_steps=accum)
                batch = to_device(host_batch, d)
                reset_launches()
                t0 = time.perf_counter()
                losses = []
                for _ in range(3):
                    state, m = step(state, batch)
                    losses.append(float(m["loss"]))
                out.append((state, losses, time.perf_counter() - t0, launches()))
            (cs, cl, cw, cc), (hs, hl, hw, hc) = out
            check(sum(cc.values()) == 0, f"13a {arch} {name}: training launched {cc}")
            add_counts(total, cc)
            tol = TRAIN_CARD_TOL
            check(all(abs(a - b) <= tol["rtol"] * abs(b) for a, b in zip(cl, hl)),
                  f"13a {arch} {name} accum {accum}: losses card {cl} cpu {hl}")
            check(cl[-1] < cl[0] and hl[-1] < hl[0],
                  f"13a {arch} {name}: loss did not fall, card {cl} cpu {hl}")
            ok, worst, share = trees_close(torch, cs["params"], hs["params"], **tol)
            check(ok, f"13a {arch} {name} accum {accum}: parameters card vs cpu "
                  f"worst {worst:.3g}, share outside tol {share:.3g}")
            res[f"{arch} {name} accum {accum}"] = dict(
                losses_card=[round(x, 6) for x in cl], losses_cpu=[round(x, 6) for x in hl],
                param_worst_abs=worst, param_share_outside_tol=share,
                card_s=round(cw, 3), cpu_s=round(hw, 3))
    return total, res


def numel_bytes(tree):
    ts_ = tree_tensors(tree)
    return sum(t.numel() for t in ts_), sum(t.numel() * t.element_size() for t in ts_)


def phase_train_tinylm(torch, np, dev, tmp: Path):
    """13b: tinylm trained on the card with the reference's recipe through
    ``training/loop.train`` into a checkpoint directory; a second run
    preempted at ``preempt_at`` and resumed from its checkpoint ends where
    the first ends; the checkpoint served by ``python -m
    repro_torch.launch.serve``; ``generation_ppl`` of full, GRIFFIN 0.5
    and magnitude on held-out sequences."""
    from repro_torch import bridge
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.core import evaluate
    from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus
    from repro_torch.runtime.preemption import PreemptionGuard
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.loop import train
    from repro_torch.training.schedule import warmup_cosine

    cfg = get_config("tinylm")
    r = TINY_RECIPE

    def run(ckpt_dir, start=0, guard=None, preempt_at=None):
        loader = ShardedLoader(SyntheticCorpus(vocab=cfg.vocab_size, seed=0),
                               batch=r["batch"], seq_len=r["seq"], seed=1,
                               start_step=start)

        def batches():
            for i, b in enumerate(loader, start + 1):
                if i == preempt_at:  # step preempt_at - 1 runs, then exits
                    guard.simulate()
                yield b

        mgr = CheckpointManager(str(ckpt_dir), interval=100, keep=2)
        opt = opt_lib.adamw(warmup_cosine(r["peak_lr"], r["warmup"], r["steps"]))
        lines = []
        try:
            out = train(cfg, opt, batches(), r["steps"], ckpt=mgr, guard=guard,
                        log_every=100, log_fn=lines.append, device=dev)
        finally:
            loader.close()
        return out, lines, mgr

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        reset_launches()
        t0 = time.perf_counter()
        full, lines, mgr = run(tmp / "full")
        wall = time.perf_counter() - t0
        if mgr.latest_step() != r["steps"]:  # as trained_tiny keeps the last
            mgr.save(r["steps"], bridge.train_state_to_jax(full.state, cfg), force=True)
            mgr.wait()
        check(sum(launches().values()) == 0, f"13b training launched {launches()}")
        guard = PreemptionGuard(install_handlers=False)
        first, _, _ = run(tmp / "resumed", guard=guard, preempt_at=r["preempt_at"])
        check(first.preempted and first.steps_done == r["preempt_at"],
              f"13b preempted run did {first.steps_done} steps")
        resumed, resume_lines, _ = run(tmp / "resumed", start=r["preempt_at"])
    finally:
        torch.use_deterministic_algorithms(False)
    check(resumed.steps_done == r["steps"] - r["preempt_at"]
          and int(resumed.state["step"]) == r["steps"],
          f"13b resumed run: {resumed.steps_done} steps to {int(resumed.state['step'])}")
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tree_tensors(resumed.state["params"]), tree_tensors(full.state["params"])))
    check(diff <= TINY_RESUME_ATOL, f"13b resumed run ends {diff:.3g} from the clean run")
    losses = full.losses
    check(all(np.isfinite(losses)), "13b loss not finite")
    curve = {s: (round(losses[s], 4), round(ref, 4)) for s, ref in TINY_REF_LOSSES.items()}
    last = r["steps"] - 1
    rel = abs(losses[last] - TINY_REF_LOSSES[last]) / TINY_REF_LOSSES[last]
    check(rel <= TINY_LOSS_RTOL, f"13b step {last} loss {losses[last]:.4f} vs "
          f"reference {TINY_REF_LOSSES[last]:.4f} (rel {rel:.3g})")

    # the checkpoint, served by the port's launcher in a process of its own
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "tinylm",
         "--ckpt-dir", str(tmp / "full"), "--requests", "4"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=300)
    serve_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"13b launch.serve exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    check(f"[ckpt] loaded {tmp / 'full'} (step {r['steps']})" in proc.stdout,
          f"13b launch.serve did not load the checkpoint: {proc.stdout[-2000:]}")
    served = [ln for ln in proc.stdout.splitlines() if "served" in ln or "ttft" in ln]

    # the card's first numbers from trained weights: printed, not claimed
    e = TINY_EVAL
    corpus = SyntheticCorpus(vocab=cfg.vocab_size, seed=0)
    seqs = torch.from_numpy(np.stack([corpus.sample(e["length"], seed=e["seed"] + 7919 * i)
                                      for i in range(e["n"])])).to(dev)
    ppl = {m: evaluate.generation_ppl(full.state["params"], cfg, seqs, e["P"], m, 0.5)
           for m in e["methods"]}
    check(all(np.isfinite(v) for v in ppl.values()), f"13b ppl {ppl}")
    return dict(train_wall_s=round(wall, 2), step_ms_mean=round(wall / r["steps"] * 1e3, 3),
                loss_by_step_card_vs_reference=curve, loss_rel_diff_last_step=rel,
                log=lines, preempted_at=r["preempt_at"], resume_log=resume_lines[:1],
                resumed_max_abs_diff=diff, served=served, serve_s=round(serve_s, 1),
                generation_ppl=ppl)


#: 13d: the profile the flocking example derives on the card against the
#: CPU's (fp32, TF32 off), weight by weight
EXAMPLE_PROFILE_TOL = 1e-5


def phase_examples(torch, np, dev, tmp: Path):
    """13d: the four examples (``repro_torch.examples``) on the card from
    13b's trained tinylm, its checkpoint copied to where
    ``common.trained_tiny`` finds it (training there fails the phase):
    ``quickstart`` as ``python -m`` in a process of its own, the others
    through their ``main``; ``serve_batched``'s streams equal the CPU's,
    the profile ``flocking_analysis --emit-profile`` derives is within
    ``EXAMPLE_PROFILE_TOL`` of the CPU's and ``launch.serve --tier 0.5
    --sparsity-profile`` serves it, ``train_lm`` runs 3 steps into a
    checkpoint.  Returns the launches on the card and the numbers."""
    from repro_torch.core.griffin import SparsityProfile
    from repro_torch.examples import common, flocking_analysis, serve_batched, train_lm
    from repro_torch.launch import serve

    saved = common.ARTIFACTS, common.train

    def no_training(*a, **kw):
        raise AssertionError("13d: trained_tiny trained instead of loading 13b's model")

    common.ARTIFACTS, common.train = tmp / "artifacts", no_training
    res, out = {}, io.StringIO()
    try:
        cache = common.ckpt_dir("tinylm", TINY_RECIPE["steps"])
        shutil.copytree(tmp / "full", cache)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.examples.quickstart"], cwd=tmp,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=300)
        check(proc.returncode == 0 and "token agreement" in proc.stdout,
              f"13d quickstart exited {proc.returncode}: {proc.stderr[-2000:]}")
        check(" loss " not in proc.stdout, "13d quickstart trained instead of "
              f"loading 13b's model: {proc.stdout[:500]}")
        res["quickstart"] = [ln for ln in proc.stdout.splitlines() if "agreement" in ln]
        res["quickstart_s"] = round(time.perf_counter() - t0, 1)
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            card = serve_batched.main([])
            fl = flocking_analysis.main(["--emit-profile", str(tmp / "profile_card.json")])
            streams = serve.main(["--arch", "tinylm", "--requests", "2", "--tier", "0.5",
                                  "--sparsity-profile", str(tmp / "profile_card.json"),
                                  "--ckpt-dir", str(cache)])
            tl = train_lm.main(["--steps", "3", "--ckpt-dir", str(tmp / "train_lm")])
        counts = launches()
        res["card_s"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            host = serve_batched.main(["--device", "cpu"])
            flocking_analysis.main(["--device", "cpu", "--emit-profile",
                                    str(tmp / "profile_cpu.json")])
        res["cpu_s"] = round(time.perf_counter() - t0, 1)
    finally:
        common.ARTIFACTS, common.train = saved
    text = out.getvalue().splitlines()
    check(card == host, "13d serve_batched: card streams != the CPU's")
    a = SparsityProfile.load(tmp / "profile_card.json").weights
    b = SparsityProfile.load(tmp / "profile_cpu.json").weights
    check([p for p, _ in a] == [p for p, _ in b], f"13d profile paths {a} vs {b}")
    gap = max(abs(x - y) for (_, u), (_, v) in zip(a, b) for x, y in zip(u, v))
    check(gap <= EXAMPLE_PROFILE_TOL, f"13d profile card vs CPU: {gap}")
    check(sorted(streams) == [0, 1] and all(streams.values()), f"13d served {streams}")
    check(tl.steps_done == 3 and all(np.isfinite(tl.losses))
          and (tmp / "train_lm").is_dir(), f"13d train_lm: {tl.steps_done} steps")
    check(counts["paged_attn"] > 0 and counts["expert_stat"] > 0,
          f"13d launches {counts}")
    res.update(
        serve_batched=[ln for ln in text if "served 10 requests" in ln or "ttft" in ln],
        serve_batched_tokens=sum(len(v) for v in card.values()),
        flocking_layer_scores=[[round(x, 3) for x in sc] for sc in fl["scores"]],
        flocking_intra_inter=(round(fl["intra"], 3), round(fl["inter"], 3)),
        profile_card_vs_cpu=gap,
        served_profile=[ln for ln in text if "[profile]" in ln or "paged: served" in ln],
        train_lm_losses=[round(x, 4) for x in tl.losses])
    return counts, res


def phase_train_yi9b(torch, np, dev):
    """13c: Yi-9B whole (bf16, ``remat`` as its config has it), 8-bit Adam,
    ``accum_steps=1``: ``abstract_train_state``'s bytes, then
    ``YI_TRAIN['steps']`` steps on one fixed batch (a backward first, whose
    gradients are held present and finite), each timed on the host clock,
    then one more step traced for its device busy time; peak memory and
    the step's bounds (8 N T bf16 operations with remat's second forward;
    the optimizer's bytes)."""
    from repro_torch.analysis import roofline
    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_step as ts

    cfg = get_config("yi-9b")
    check(cfg.remat, "13c yi-9b's config trains with remat")
    opt = opt_lib.adam8bit(YI_TRAIN["lr"])
    abstract = ts.abstract_train_state(cfg, opt)
    n_params, p_bytes = numel_bytes(abstract["params"])
    _, o_bytes = numel_bytes(abstract["opt"])
    _, o32_bytes = numel_bytes(ts.abstract_train_state(cfg, opt_lib.adamw(1e-4))["opt"])
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = ts.init_train_state(cfg, opt, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9
    B, S = YI_TRAIN["B"], YI_TRAIN["S"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device=dev)}

    reset_launches()
    _, _, grads = ts.value_and_grad(decoder.loss_fn, state["params"], batch, cfg)
    read = grads_read(grads, cfg)
    check(all(g is not None for g in read), "13c a gradient is None")
    check(bool(torch.stack([torch.isfinite(g).all() for g in read]).all()),
          "13c a gradient is not finite")
    del grads, read
    step = ts.build_train_step(cfg, opt)
    losses, walls = [], []
    for _ in range(YI_TRAIN["steps"]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    counts = launches()
    check(sum(counts.values()) == 0, f"13c training launched {counts}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"13c losses {losses}: not finite or not falling")

    def traced():  # one more step
        nonlocal state, m
        state, m = step(state, batch)

    prof = device_breakdown(fenced_device_events(torch, traced), n=8)
    busy = prof.pop("busy_ms")
    wall_ms = statistics.median(walls[1:]) * 1e3
    T = B * S
    flops = 8 * n_params * T
    opt_bytes = n_params * (2 + 2 + 1 + 1 + 2 + 1 + 1)  # p, g, m, v in; p, m, v out
    compute_ms, bytes_ms = (flops / roofline.peak_flops("bfloat16") * 1e3,
                            opt_bytes / roofline.HBM_BW * 1e3)
    del state, batch
    free(torch)
    return counts, dict(
        layers=cfg.num_layers, params=n_params, tokens_per_step=T,
        abstract_params_gb=p_bytes / 1e9, abstract_opt_gb=o_bytes / 1e9,
        abstract_opt_adamw_gb=o32_bytes / 1e9, state_on_card_gb=state_gb,
        init_s=round(init_s, 2), losses=[round(x, 5) for x in losses],
        traced_step_loss=round(float(m["loss"]), 5),
        step_wall_ms=[round(w * 1e3, 1) for w in walls], step_wall_ms_median=wall_ms,
        traced_step_busy_ms=busy, busy_share=busy / wall_ms,
        traced_step_profile=prof, peak_mem_gb=peak,
        bound_compute_ms=compute_ms, bound_optimizer_bytes_ms=bytes_ms,
        bound_ms=compute_ms + bytes_ms)


# ---------------------------------------------------------------------------
# phase 14: tensor-parallel paged serving (distributed/tp.py) — one process
# per rank, all ranks on the one card over gloo (NCCL refuses two ranks on
# one card), and one NCCL rank
# ---------------------------------------------------------------------------

#: ``expert_stat``'s two steps at Yi-9B TP=2 shapes (F = 11008 / 2): a
#: prefill chunk in bf16 and the engine's whole prompt in bf16 and fp32
TP_STAT_SHAPES = ((1, 32, 5504, "bfloat16"), (2, 512, 5504, "bfloat16"),
                  (2, 512, 5504, "float32"))

#: the two steps' launch counters (module ``expert_stat``), apart from
#: ``COUNTERS`` so phases 2-13 report what they did before
TP_COUNTERS = {"expert_stat_row_sq": ("expert_stat", "row_sq_launches"),
               "expert_stat_from_norm": ("expert_stat", "from_norm_launches")}

#: the reference's sharded-serving trace (tests/distributed_progs/
#: prog_sharded_serving.py): 4 requests, 3 slots, a pool tight enough to
#: preempt, two prompts sharing a 16-token prefix
TP_TINY_SERVER = dict(page_size=8, num_pages=10, n_slots=3, prefill_chunk=16,
                      max_len=64)
TP_TINY_NEW = 10

#: phase 14d's tolerances, TP=2 against one rank with the same selection
#: math (``GriffinConfig(tp_shards=2)``), bf16.  The first prefill chunk
#: is dense, so it is compared before a selection can differ: its logits
#: within ``TP_LOGIT_TOL`` of the largest |logit| of the compared rows,
#: and each gathered statistic leaf within ``TP_STAT_TOL`` of its largest
#: value.  The ranks then select from the single rank's statistic, so the
#: first decode step runs the same experts: its logits within
#: ``TP_LOGIT_TOL`` too, and the streams equal up to the first token whose
#: single-rank top-2 margin is within twice that gap (each of the two
#: logits may move by it).  The TP step adds bf16 roundings of the
#: all-reduced partial sums (2 a layer) to a 48-layer random model; a
#: missing or doubled all-reduce moves every sublayer's output by its own
#: size.  Set from readings on an H100 (``PERF.md`` §6): TP=2 3.7%
#: (prefill) and 3.2% (decode) of max |logit|, 7.2% for the statistics;
#: a missing or doubled all-reduce 104-122% and 150-168%, which the phase
#: checks each run (``yi_tp_mutants``).
#: 14d's new tokens a request and prefill chunk (phase 4's 32 and 32,
#: cut for the script's time: ranks over gloo step ~7x slower than one
#: rank, and 14d's ranks also serve the mesh frontend; 14a checks
#: ``paged_attn`` at the 128-token chunk, local and full heads)
TP_YI_NEW = 8
TP_YI_CHUNK = 128
#: 14d's depth: 16 of Yi-9B's 48 layers, for the script's time (every
#: layer costs the ranks two all-reduces over gloo); at 16 a rank still
#: holds under 0.6 of one rank's parameter bytes (the embeddings are
#: whole on each rank)
TP_YI_LAYERS = 16
TP_LOGIT_TOL = 0.10
TP_STAT_TOL = 0.20


def tp_yi_cfg(arch: str):
    """14d's config: ``arch`` at ``TP_YI_LAYERS`` layers at most."""
    from repro_torch.configs.registry import get_config

    cfg = get_config(arch)
    return cfg.replace(num_layers=min(cfg.num_layers, TP_YI_LAYERS))


def tp_counts(counts):
    """``run_ranks``' summed ``module.attr`` counters by kernel name."""
    names = dict(COUNTERS, **TP_COUNTERS)
    return {k: counts.get(f"{mod}.{attr}", 0) for k, (mod, attr) in names.items()}


def phase_tp_kernels(torch, dev, flush):
    """14a: ``expert_stat_row_sq`` and ``expert_stat_from_norm`` against
    their plain versions at ``TP_STAT_SHAPES`` (rtol=atol=1e-5, each
    deterministic), timed beside their bounds and plain versions; then
    the composed path (F cut in 2 blocks, both steps, row norms added on
    one rank) against the single launch at full F.  ``paged_attn`` at
    the local head counts: Yi-9B TP=2 (16 Q / 2 KV heads) decode and
    prefill (32-token and 14d's ``TP_YI_CHUNK``-token chunks), Yi-9B's
    full heads at 14d's chunk (its one rank), and 1 KV head (2 Q, hd 32:
    tinylm-tp's TP=4 split at a head dim the kernel takes)."""
    from repro_torch.kernels import ops, ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    out = {"expert_stat_row_sq": [], "expert_stat_from_norm": []}
    lines = []
    for B, S, F, dt in TP_STAT_SHAPES:
        dtype = getattr(torch, dt)
        z = torch.randn(B, S, 2 * F, generator=gen, device=dev).to(dtype)
        z[:, -3:] = 0  # padded chunk rows
        blocks = [z[..., :F].contiguous(), z[..., F:].contiguous()]
        zb = blocks[0]
        row_k, row_p = ops.griffin_row_sq(zb), ref.expert_stat_row_sq_ref(zb)
        s_k = ops.griffin_stat_from_norm(zb, row_p)
        s_p = ref.expert_stat_from_norm_ref(zb, row_p)
        torch.cuda.synchronize()
        what = f"expert_stat two-step [{B},{S},{F}] {dt}"
        err_r = (row_k - row_p).abs().max().item()
        err_s = (s_k - s_p).abs().max().item()
        check(torch.allclose(row_k, row_p, rtol=1e-5, atol=1e-5),
              f"{what}: row_sq max err {err_r}")
        check(torch.allclose(s_k, s_p, rtol=1e-5, atol=1e-5),
              f"{what}: statistic max err {err_s}")
        check(torch.equal(row_k, ops.griffin_row_sq(zb))
              and torch.equal(s_k, ops.griffin_stat_from_norm(zb, row_p)),
              f"{what}: not deterministic")
        # composed: both ranks' row norms added, each block's statistic
        rows = ops.griffin_row_sq(blocks[0]) + ops.griffin_row_sq(blocks[1])
        comp = torch.cat([ops.griffin_stat_from_norm(b, rows) for b in blocks], -1)
        single = ops.griffin_stat(z)
        torch.cuda.synchronize()
        err_c = (comp - single).abs().max().item()
        check(torch.allclose(comp, single, rtol=1e-5, atol=1e-5),
              f"{what}: composed vs single launch max err {err_c}")
        n_el, isz = zb.numel(), zb.element_size()
        at = f"z [{B},{S},{F}] {dt}"
        for name, fn, plain, err, byts, flops in (
                ("expert_stat_row_sq", lambda: ops.griffin_row_sq(zb),
                 lambda: ref.expert_stat_row_sq_ref(zb), err_r,
                 n_el * isz + B * S * 4, 2 * n_el),
                ("expert_stat_from_norm", lambda: ops.griffin_stat_from_norm(zb, row_p),
                 lambda: ref.expert_stat_from_norm_ref(zb, row_p), err_s,
                 n_el * isz + B * S * 4 + B * F * 4, 3 * n_el)):
            ms = time_ms(torch, fn, flush=flush)
            plain_ms = time_ms(torch, plain, flush=flush)
            b_ms, b_by = bound(byts, flops)
            out[name].append(dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by, library_ms=None,
                                  max_abs_err=err, composed_err=err_c, at=at))
            lines.append(f"{name} {at}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
                         f"  bound {b_ms:.5f} ms ({b_by})  max_abs_err {err:.3g}"
                         f"  (composed vs single launch at F={2 * F}: {err_c:.3g})")
    # paged_attn at the ranks' local head counts
    local = {}
    for label, B, S, lens, shape in (
            ("yi9b_tp2_decode", 2, 1, [583, 431], dict(H=16, KV=2, hd=128, page=16, W=40)),
            ("yi9b_tp2_prefill", 1, 32, [448], dict(H=16, KV=2, hd=128, page=16, W=40)),
            ("yi9b_tp2_prefill128", 1, TP_YI_CHUNK, [448],
             dict(H=16, KV=2, hd=128, page=16, W=40)),
            ("yi9b_one_prefill128", 1, TP_YI_CHUNK, [448],
             dict(H=32, KV=4, hd=128, page=16, W=40)),
            ("kv1_decode", 3, 1, [43, 28, 9], dict(H=2, KV=1, hd=32, page=8, W=8)),
            ("kv1_prefill", 1, 16, [32], dict(H=2, KV=1, hd=32, page=8, W=8))):
        pool_dtype = torch.bfloat16 if label.startswith("yi") else torch.float32
        args = paged_attn_case(torch, gen, B, S, lens, pool_dtype, dev, **shape)
        kern = [a.clone() for a in args]
        plain = [a.clone() for a in args]
        ctx_k, pk_k, pv_k = ops.paged_attention(*kern)
        ctx_r, pk_r, pv_r = ref.paged_attn_ref(*plain)
        torch.cuda.synchronize()
        err = (ctx_k - ctx_r).abs().max().item()
        check(torch.allclose(ctx_k, ctx_r, rtol=1e-5, atol=1e-5),
              f"paged_attn {label}: ctx max err {err}")
        check(torch.equal(pk_k[:-1], pk_r[:-1]) and torch.equal(pv_k[:-1], pv_r[:-1]),
              f"paged_attn {label}: pools differ")
        ms = time_ms(torch, lambda: ops.paged_attention(*kern), flush=flush)
        plain_ms = time_ms(torch, lambda: ref.paged_attn_ref(*plain), flush=flush)
        byts, flops = paged_attn_work(args, lens)
        b_ms, b_by = bound(byts, flops, str(pool_dtype).split(".")[-1])
        at = (f"B={B} S={S} ctx={lens} H={shape['H']} KV={shape['KV']} "
              f"hd={shape['hd']} {str(pool_dtype).split('.')[-1]} pool")
        local[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                            bound_by=b_by, max_abs_err=err, at=at)
        lines.append(f"paged_attn {label} {at}: kernel {ms:.4f} ms  plain "
                     f"{plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})  "
                     f"max_abs_err {err:.3g}")
    return out, local, lines


def tp_tiny_setup(np, head_dim=None):
    """tinylm-tp (``head_dim`` overridden if given), its weights (one
    draw on the CPU, matrices scaled by 2 so greedy streams vary) and the
    reference's sharded-serving trace."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import decoder

    cfg = get_config("tinylm-tp")
    if head_dim is not None:
        cfg = cfg.replace(head_dim=head_dim)
    rng = np.random.default_rng(11)
    shared = rng.integers(0, cfg.vocab_size, size=16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, cfg.vocab_size, size=n)
                               .astype(np.int32)]) for n in (8, 10)]
    prompts += [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                for n in (24, 20)]
    host = decoder.init_params(cfg, seed=0, device="cpu")
    scale_matrices(host, 2.0)
    return cfg, host, [(p, TP_TINY_NEW) for p in prompts]


def tp_cases_rank(mesh, cases):
    """One rank of phase 14b/14c (runs in a spawned process): each case
    ``(cfg, host params, gcfg, prompts, server kwargs)`` through
    ``launch.serve.serve_requests`` with TF32 off."""
    import torch

    from repro_torch.launch.serve import serve_requests

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    for cfg, host, gcfg, prompts, kw in cases:
        res = serve_requests(mesh, cfg, host, gcfg, prompts, kw)
        out.append(dict(streams=res["streams"], pool_bytes=res["pool_bytes"],
                        param_bytes=res["param_bytes"],
                        preemptions=res["metrics"]["preemptions"],
                        spec_rounds=res["metrics"].get("spec_rounds", 0.0),
                        prefix_hits=res["prefix_hits"]))
    return out


def single_rank(cfg, host, gcfg, prompts, kw, device):
    """The same requests through one ordinary ``PagedServer``: (streams,
    pool bytes)."""
    from repro_torch.distributed.tp import pool_shard_bytes
    from repro_torch.serving.server import PagedServer

    srv = PagedServer(cfg, to_device(host, device), gcfg, device=device, **kw)
    out = serve(srv, prompts)
    return out, pool_shard_bytes(srv.pools)


def phase_tp_tinylm(torch, np, dev, nccl: str = "nccl"):
    """14b: tinylm-tp in fp32 at TP=2 and TP=4, all ranks on the card over
    gloo: ``spec_k`` 0 and 4 with fp32 and int8 pools on the gather
    backend (tinylm-tp's head_dim 24 is no power of two, which the fused
    kernel refuses), and fused fp32/int8 on the same model at head_dim 32
    (TP=4: one KV head a rank).  Streams equal on every rank, equal to a
    single-rank card server and to the CPU (both with the same
    ``GriffinConfig(tp_shards=N)``); per-rank pool bytes total / N.
    14c: one NCCL rank (world size 1) equals the plain server.  Returns
    the TP runs' launches by path and the results."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.launch.mesh import run_ranks

    from concurrent.futures import ThreadPoolExecutor

    cfg, host, prompts = tp_tiny_setup(np)
    cfg32, host32, prompts32 = tp_tiny_setup(np, head_dim=32)
    res, paths = {}, {}

    def cases_of(n):
        gcfg = GriffinConfig(sparsity=0.5, per_shard_topk=True, tp_shards=n)
        cases, names = [], []
        for spec_k in (0, 4):
            for kvd in ("fp32", "int8"):
                cases.append((cfg, host, gcfg, prompts,
                              dict(TP_TINY_SERVER, spec_k=spec_k, kv_dtype=kvd,
                                   kernel_backend="gather")))
                names.append(f"gather spec_k={spec_k} {kvd}")
        for kvd in ("fp32", "int8"):
            cases.append((cfg32, host32, gcfg, prompts32,
                          dict(TP_TINY_SERVER, kv_dtype=kvd, kernel_backend="fused")))
            names.append(f"fused hd32 {kvd}")
        return cases, names

    def timed_ranks(n, cases):
        t0 = time.perf_counter()
        out = run_ranks(tp_cases_rank, n, backend="gloo", device=dev.type,
                        args=(cases,), timeout_s=300)
        return out, time.perf_counter() - t0

    # TP=2's and TP=4's ranks run at once, beside the one-rank servers
    # they are held to (card and CPU), which this process runs meanwhile
    with ThreadPoolExecutor(2) as ex:
        futures = {n: ex.submit(timed_ranks, n, cases_of(n)[0]) for n in (2, 4)}
        singles = {n: [(single_rank(c, h, g, p, kw, dev),
                        single_rank(c, h, g, p, dict(kw, kernel_backend="gather"),
                                    "cpu")[0])
                       for c, h, g, p, kw in cases_of(n)[0]] for n in (2, 4)}
        done = {n: f.result() for n, f in futures.items()}
    for n in (2, 4):
        cases, names = cases_of(n)
        (ranks, counts), wall = done[n]
        counts = tp_counts(counts)
        check(counts["expert_stat_row_sq"] > 0 and counts["expert_stat_from_norm"] > 0
              and counts["expert_stat"] == 0 and counts["paged_gather"] > 0
              and counts["paged_attn"] > 0 and counts["paged_attn_quant"] > 0,
              f"14b TP={n} launches {counts}")
        paths[f"tp{n}_tinylm"] = counts
        for i, (name, (c, h, g, p, kw)) in enumerate(zip(names, cases)):
            what = f"14b tinylm-tp TP={n} {name}"
            streams = [r[i]["streams"] for r in ranks]
            check(all(s == streams[0] for s in streams), f"{what}: ranks differ {streams}")
            (card, total), cpu = singles[n][i]
            check(streams[0] == card, f"{what}: TP {streams[0]} != one rank {card}")
            check(card == cpu, f"{what}: card {card} != CPU {cpu}")
            check(len({t for s in card.values() for t in s}) > 4,
                  f"{what}: degenerate streams {card}")
            check(all(r[i]["pool_bytes"] * n == total for r in ranks),
                  f"{what}: pool bytes {[r[i]['pool_bytes'] for r in ranks]} "
                  f"x {n} != {total}")
            r0 = ranks[0][i]
            res[f"TP={n} {name}"] = dict(
                rid0=streams[0][0], pool_bytes_per_rank=r0["pool_bytes"],
                pool_bytes_one_rank=total, preemptions=r0["preemptions"],
                spec_rounds=r0["spec_rounds"], prefix_hits=r0["prefix_hits"])
        res[f"TP={n} wall_s"] = wall  # TP=2 and TP=4 at once
    # 14c: NCCL at world size 1 == the plain server (tp_shards=1)
    gcfg = GriffinConfig(sparsity=0.5)
    kw = dict(TP_TINY_SERVER, kernel_backend="gather")
    ranks, counts = run_ranks(tp_cases_rank, 1, backend=nccl, device=dev.type,
                              args=([(cfg, host, gcfg, prompts, kw)],), timeout_s=300)
    plain, _ = single_rank(cfg, host, gcfg, prompts, kw, dev)
    check(ranks[0][0]["streams"] == plain,
          f"14c NCCL world 1: {ranks[0][0]['streams']} != plain {plain}")
    paths["tp1_nccl_tinylm"] = tp_counts(counts)
    res["nccl world 1"] = dict(rid0=plain[0], equal=True)
    return paths, res


def capture_first_decode(torch, srv):
    """Wrap ``srv._step_model``: the inputs and logits of its first
    one-token step (the first decode tick) go into the returned dict, as
    numpy (tokens, positions, mask, fp32 logits)."""
    first = {}
    step_model = srv._step_model

    def step(bt, toks, pos, mask, pruned, collect=False):
        out = step_model(bt, toks, pos, mask, pruned, collect)
        if not first and toks.shape[1] == 1 and not collect:
            first.update(toks=toks.copy(), pos=pos.copy(), mask=mask.copy(),
                         logits=out[0][:, 0].float().cpu().numpy())
        return out

    srv._step_model = step
    return first


def drain_timed(torch, srv):
    """Drain ``srv`` tick by tick up to a ``synchronize``; returns the
    wall time, the decode-only ticks' walls (one-token decode, no prefill
    chunk, classified by the attention launches of the tick) and the
    bytes of the first compacted request's FF copy."""
    ticks, compacted = [], None
    on_card = srv.device.type == "cuda"  # a CPU rehearsal has no card
    t0 = time.perf_counter()
    while True:
        before = launches()
        t = time.perf_counter()
        more = srv.step()
        if on_card:
            torch.cuda.synchronize()
        w = time.perf_counter() - t
        after = launches()
        k = attn_kinds({n: after[n] - before[n] for n in after})
        if k["decode"] and not k["prefill"] and not k["verify"]:
            ticks.append(w)
        if compacted is None and srv._compacted:
            from repro_torch.distributed.tp import tree_bytes

            compacted = tree_bytes(next(iter(srv._compacted.values())).pruned_host)
        if not more:
            break
    return time.perf_counter() - t0, ticks, compacted


def tree_np(tree):
    """A ``{li: {leaf: tensor}}`` statistics tree as fp32 numpy."""
    return {li: {k: v.float().cpu().numpy() for k, v in st.items()}
            for li, st in tree.items()}


def capture_first_prefill(torch, srv):
    """Wrap ``srv._step_model``: the inputs, logits (fp32, the masked
    rows) and gathered statistics of its first collecting step (the first
    prefill chunk, dense) go into the returned dict as numpy."""
    first = {}
    step_model = srv._step_model

    def step(bt, toks, pos, mask, pruned, collect=False):
        out = step_model(bt, toks, pos, mask, pruned, collect)
        if not first and collect:
            first.update(bt=bt.copy(), toks=toks.copy(), pos=pos.copy(),
                         mask=mask.copy(), logits=out[0][torch.as_tensor(
                             mask, device=out[0].device)].float().cpu().numpy(),
                         stats=tree_np(out[2]))
        return out

    srv._step_model = step
    return first


def selection_stats(torch, srv, given=None, key=None):
    """Wrap ``srv.sched.finish_prefill_chunk``, which runs just before a
    request's selection: with ``given`` None, record each request's
    accumulated statistic (rid -> numpy tree, returned); else replace it
    by ``given[key(req)]`` (default key: the rid), so that the server
    selects what another one did."""
    got = {}
    finish = srv.sched.finish_prefill_chunk
    key = key or (lambda req: req.rid)

    def fin(work, first_token):
        req = work.req
        if work.is_last and not req.compacted and req.s_sq_acc is not None:
            if given is None:
                got[req.rid] = tree_np(req.s_sq_acc)
            else:
                req.s_sq_acc = {li: {k: torch.as_tensor(
                    given[key(req)][li][k], device=v.device).to(v.dtype)
                    for k, v in st.items()} for li, st in req.s_sq_acc.items()}
                got[req.rid] = True
        return finish(work, first_token)

    srv.sched.finish_prefill_chunk = fin
    return got


def yi_tp_rank(mesh, arch, prompts, kw, gcfg, given):
    """One rank of 14d (a spawned process): Yi-9B drawn as phase 4 draws
    it (seed 0 on the card), cut to this rank's blocks leaf by leaf
    (``PagedTP.init_params``), served over phase 4's prompts (``TP_YI_NEW``
    new tokens each), each
    request selecting from ``given[rid]`` (the single rank's statistic).
    Returns the streams, the first prefill chunk's and the first decode
    step's inputs and outputs, the decode ticks' walls, and this rank's
    parameter, pool, compacted-FF and peak bytes."""
    import numpy as np
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.tp import PagedTP, pool_shard_bytes, tree_bytes
    from repro_torch.serving.server import PagedServer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tp_yi_cfg(arch)
    on_card = mesh.device.type == "cuda"  # a CPU rehearsal has no card
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = PagedTP(cfg, mesh).init_params(seed=0)
    if on_card:
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    srv = PagedServer(cfg, params, gcfg, mesh=mesh, **kw)
    del params
    prefill = capture_first_prefill(torch, srv)
    first = capture_first_decode(torch, srv)
    injected = selection_stats(torch, srv, given)
    for i, (p, n) in enumerate(prompts):
        srv.submit(np.asarray(p), n, rid=i)
    reset_launches()
    wall, ticks, compacted = drain_timed(torch, srv)
    out = {rid: r.generated for rid, r in srv.sched.finished.items()}
    m = srv.metrics.summary()
    res = dict(streams=out, prefill=prefill, first=first, injected=sorted(injected),
               wall_s=wall, init_s=init_s,
               decode_ticks=ticks, param_bytes=tree_bytes(srv.params),
               pool_bytes=pool_shard_bytes(srv.pools), compacted_bytes=compacted,
               peak_bytes=torch.cuda.max_memory_allocated() if on_card else 0,
               tokens_per_s=m["tokens_per_sec"], ttft_p50_s=m["ttft_p50_s"])
    params = srv.params
    del srv
    res["frontend"] = tp_frontend_session(torch, np, mesh, cfg, params, gcfg, kw,
                                          prompts, given)
    return res


#: 14d's mesh frontend: phase 8b's classes for phase 4's prompts
TP_FE_SLOS = ("interactive", "batch", "interactive", "batch")


def tp_frontend_session(torch, np, mesh, cfg, params, gcfg, kw, prompts, given):
    """14d's mesh frontend (in a spawned rank, after the held drain): rank
    0 serves phase 8b's four concurrent ``POST /v1/generate`` (phase 4's
    prompts, ``TP_YI_NEW`` new tokens, two interactive and two batch)
    through ``ServingFrontend.serve_http`` over a ``relay.MeshLeader`` on a
    free 127.0.0.1 port; rank 1 replays them (``relay.follow``).  Each
    request selects from ``given`` of its prompt, as the held drain did.
    Returns the session's outcome (``relay.outcome``), rank 0's SSE token
    streams by prompt index and TTFTs, each rank's tick walls (on rank 0
    the leader's step: its control broadcast, then its server's step; on
    a follower its server's step), all and decode-only (classified as
    ``drain_timed`` does), rank 0's broadcast walls and each rank's peak
    bytes."""
    import asyncio

    from repro_torch.serving import relay
    from repro_torch.serving.frontend import FINISHED, ServingFrontend
    from repro_torch.serving.server import PagedServer

    on_card = mesh.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    srv = PagedServer(cfg, params, gcfg, mesh=mesh, **kw)
    index = {np.asarray(p).tobytes(): i for i, (p, _) in enumerate(prompts)}
    selection_stats(torch, srv, given,
                    key=lambda req: index[np.asarray(req.prompt).tobytes()])
    ticks, sends = [], []  # (wall, decode-only) a tick; a broadcast's wall

    def timed_tick(step):
        def tick():
            before = launches()
            t0 = time.perf_counter()
            more = step()
            if on_card:
                torch.cuda.synchronize()
            w = time.perf_counter() - t0
            k = attn_kinds({n: v - before[n] for n, v in launches().items()})
            ticks.append((w, k["decode"] and not k["prefill"] and not k["verify"]))
            return more
        return tick

    ch = relay.ControlChannel()
    send = ch.send

    def timed_send(msg):
        t0 = time.perf_counter()
        send(msg)
        sends.append(time.perf_counter() - t0)

    ch.send = timed_send
    out = dict(sse=None, ttft_p50_s=None, ttft_p99_s=None)
    t0 = time.perf_counter()
    if mesh.rank == 0:
        leader = relay.MeshLeader(srv, ch)
        leader.step = timed_tick(leader.step)
        fe = ServingFrontend(leader)
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        bodies = [http_post("/v1/generate", {
            "prompt": np.asarray(p).tolist(), "max_new": n, "slo": slo,
            "deadline_s": FRONTEND_DEADLINE_S})
            for (p, n), slo in zip(prompts, TP_FE_SLOS)]

        async def run():
            serving = asyncio.ensure_future(fe.serve_http("127.0.0.1", port))
            while not fe._running:
                await asyncio.sleep(0.01)
            try:
                return await asyncio.gather(*(http_call(asyncio, port, b)
                                              for b in bodies))
            finally:
                fe.stop()
                await serving

        raws = asyncio.run(run())
        leader.stop()
        sse = {}
        for raw in raws:
            status, frames = parse_sse(raw)
            check(status == "HTTP/1.1 200 OK" and frames[0][0] == "accepted"
                  and frames[-1][0] == "done", f"14d SSE: {raw[:300]}")
            h = fe.handles[frames[0][1]["rid"]]
            check(h.state == FINISHED, f"14d SSE rid {h.rid}: {h.state}")
            sse[index[np.asarray(h.prompt).tobytes()]] = \
                [d["token"] for _, d in frames[1:-1]]
        s = fe.summary()
        out.update(sse=sse, ttft_p50_s=s["ttft_p50_s"], ttft_p99_s=s["ttft_p99_s"])
    else:
        srv.step = timed_tick(srv.step)
        relay.follow(srv, ch)
    p50 = lambda xs: statistics.median(xs) * 1e3 if xs else None  # noqa: E731
    out.update(outcome=relay.outcome(srv), wall_s=time.perf_counter() - t0,
               tick_wall_ms_p50=p50([w for w, _ in ticks]),
               decode_tick_wall_ms_p50=p50([w for w, d in ticks if d]),
               ticks=len(ticks), decode_ticks=sum(d for _, d in ticks),
               broadcast_ms_p50=p50(sends),
               broadcast_ms_max=max(sends) * 1e3 if sends else None,
               messages=ch.messages,
               peak_bytes=torch.cuda.max_memory_allocated() if on_card else 0)
    return out


def yi_tp_mutants(mesh, arch, prompts, kw, gcfg):
    """14d's self-test (a spawned rank): the first prefill chunk again,
    with every layer's out/down-projection all-reduce missing, then
    doubled; ``TP_LOGIT_TOL`` and ``TP_STAT_TOL`` must refuse both."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.tp import PagedTP
    from repro_torch.serving.server import PagedServer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tp_yi_cfg(arch)
    params = PagedTP(cfg, mesh).init_params(seed=0)
    real, out = dist.all_reduce, {}
    for mode in ("missing", "doubled"):
        def all_reduce(x, *a, mode=mode, **k):
            if x.ndim >= 2 and x.shape[-1] == cfg.d_model:  # a layer's partial sum
                if mode == "missing":
                    return None
                real(x, *a, **k)
            return real(x, *a, **k)

        dist.all_reduce = all_reduce
        try:
            srv = PagedServer(cfg, params, gcfg, mesh=mesh, **kw)
            out[mode] = capture_first_prefill(torch, srv)
            for i, (p, n) in enumerate(prompts):
                srv.submit(np.asarray(p), n, rid=i)
            srv.step()
        finally:
            dist.all_reduce = real
        del srv
    return out


def first_divergence_ok(a, b, margins, tol2):
    """Per request: the first position where streams ``a`` and ``b``
    differ must be one where the single rank's top-2 margin is within
    ``tol2``; returns the failures."""
    bad = []
    for rid in b:
        for i, (x, y) in enumerate(zip(a[rid], b[rid])):
            if x != y:
                if margins[rid][i] > tol2:
                    bad.append((rid, i, x, y, margins[rid][i]))
                break
    return bad


def logit_gap(np, a, b, what, rows=None):
    """max |logit| gap of two captured steps (over ``rows`` of their
    logits, else all), and the largest |logit| of ``b`` there; fails
    unless the steps had the same inputs."""
    for k in ("bt", "toks", "pos", "mask"):
        if k in b:
            check(np.array_equal(a[k], b[k]), f"14d: {what}: the {k} differ "
                  f"({a[k].tolist()} vs {b[k].tolist()})")
    la, lb = a["logits"], b["logits"]
    if rows is not None:
        la, lb = la[rows], lb[rows]
    return float(np.abs(la - lb).max()), float(np.abs(lb).max())


def stat_gap(np, a, b):
    """Largest gap of two statistics trees, as a share of each leaf's
    largest value."""
    check(a.keys() == b.keys(), "14d: the statistics' layers differ")
    return max(float(np.abs(a[li][k] - v).max() / max(np.abs(v).max(), 1e-30))
               for li in b for k, v in b[li].items())


def phase_tp_yi9b(torch, np, dev, yi, arch: str = "yi-9b"):
    """14d: Yi-9B at ``TP_YI_LAYERS`` layers, bf16, GRIFFIN 0.5, TP=2 with both ranks on the
    card (gloo), over phase 4's prompts (``TP_YI_NEW`` new tokens each),
    beside one rank with the same
    selection math (``GriffinConfig(tp_shards=2)``) on the same backend;
    the single rank runs first and is freed before the ranks draw their
    blocks.  Held: the first prefill chunk's logits and gathered
    statistics, and, with the ranks selecting from the single rank's
    statistic, the first decode step's logits and the streams
    (``TP_LOGIT_TOL``, ``TP_STAT_TOL``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.distributed.tp import pool_shard_bytes, tree_bytes
    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models import decoder
    from repro_torch.serving.server import PagedServer

    cfg = tp_yi_cfg(arch)
    rng = np.random.default_rng(1)  # phase 4's prompts
    prompts = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), TP_YI_NEW)
               for n in YI_PROMPT_LENS]
    gcfg = GriffinConfig(sparsity=0.5, per_shard_topk=True, tp_shards=2)
    kw = dict(page_size=16, num_pages=256, n_slots=2, prefill_chunk=TP_YI_CHUNK,
              max_len=640, kernel_backend="auto")
    params = decoder.init_params(cfg, seed=0, device=dev)
    full_bytes = tree_bytes(params)
    srv = PagedServer(cfg, params, gcfg, device=dev, **kw)
    margins = record_margins(torch, np, srv)
    prefill = capture_first_prefill(torch, srv)
    first = capture_first_decode(torch, srv)
    given = selection_stats(torch, srv)
    for i, (p, n) in enumerate(prompts):
        srv.submit(p, n, rid=i)
    reset_launches()
    _, one_ticks, one_compacted = drain_timed(torch, srv)
    single = {rid: r.generated for rid, r in srv.sched.finished.items()}
    one_pool = pool_shard_bytes(srv.pools)
    del srv, params
    free(torch)
    check(sorted(given) == list(range(len(prompts))), f"14d: selections {sorted(given)}")
    t0 = time.perf_counter()
    ranks, counts = run_ranks(yi_tp_rank, 2, backend="gloo", device=dev.type,
                              args=(arch, prompts, kw, gcfg, given), timeout_s=600)
    spawn_wall = time.perf_counter() - t0
    counts = tp_counts(counts)
    check(counts["paged_attn"] > 0 and counts["expert_stat_row_sq"] > 0
          and counts["expert_stat_from_norm"] > 0 and counts["expert_stat"] == 0,
          f"14d launches {counts}")
    streams = [r["streams"] for r in ranks]
    check(streams[0] == streams[1], "14d: the ranks' streams differ")
    tp = streams[0]
    check(sorted(tp) == list(range(len(prompts)))
          and all(len(tp[i]) == prompts[i][1] for i in tp), f"14d streams {tp}")
    for r in ranks:
        check(r["injected"] == sorted(given), f"14d: injected {r['injected']}")
        check(r["pool_bytes"] * 2 == one_pool,
              f"14d pool bytes {r['pool_bytes']} x 2 != {one_pool}")
        check(r["param_bytes"] < 0.6 * full_bytes,
              f"14d: a rank holds {r['param_bytes']} of {full_bytes} parameter bytes")
        check(r["compacted_bytes"] * 2 == one_compacted,
              f"14d: a rank's compacted FF {r['compacted_bytes']} x 2 != "
              f"{one_compacted}")
    pre_gap, pre_max = logit_gap(np, ranks[0]["prefill"], prefill, "first prefill chunk")
    s_gap = stat_gap(np, ranks[0]["prefill"]["stats"], prefill["stats"])
    dec_gap, dec_max = logit_gap(np, ranks[0]["first"], first, "first decode step",
                                 rows=first["mask"][:, 0])
    check(pre_gap <= TP_LOGIT_TOL * pre_max,
          f"14d: the first prefill chunk's logits differ by {pre_gap} > "
          f"{TP_LOGIT_TOL} x {pre_max}")
    check(s_gap <= TP_STAT_TOL, f"14d: the first prefill chunk's statistics "
          f"differ by {s_gap} of their largest value > {TP_STAT_TOL}")
    check(dec_gap <= TP_LOGIT_TOL * dec_max,
          f"14d: the first decode step's logits differ by {dec_gap} > "
          f"{TP_LOGIT_TOL} x {dec_max}")
    bad = first_divergence_ok(tp, single, margins, 2 * dec_gap)
    check(not bad, f"14d: streams differ where the single rank's top-2 "
          f"margin exceeds {2 * dec_gap}: {bad}")
    # the mesh frontend: the ranks agree, and the SSE streams are the held
    # drain's (the same requests under the same selection)
    fes = [r["frontend"] for r in ranks]
    check(fes[0]["outcome"] == fes[1]["outcome"],
          "14d frontend: the ranks' streams, aborts or free pages differ")
    check(fes[0]["ticks"] == fes[1]["ticks"] > 0
          and fes[0]["messages"] == fes[1]["messages"] > fes[0]["ticks"],
          f"14d frontend: ticks {[f['ticks'] for f in fes]}, messages "
          f"{[f['messages'] for f in fes]}")
    check(sorted(fes[0]["sse"]) == list(range(len(prompts)))
          and not fes[0]["outcome"]["aborted"], f"14d frontend: {fes[0]['outcome']}")
    for i, toks in fes[0]["sse"].items():
        check(toks == tp[i], f"14d frontend SSE stream {i} {toks} != the mesh "
              f"drain()'s {tp[i]}")
    mutants, _ = run_ranks(yi_tp_mutants, 2, backend="gloo", device=dev.type,
                           args=(arch, prompts, kw, gcfg), timeout_s=300)
    mutant_gaps = {}
    for mode, cap in mutants[0].items():
        g, m = logit_gap(np, cap, prefill, f"the {mode} all-reduce's prefill")
        mutant_gaps[mode] = (g / m, stat_gap(np, cap["stats"], prefill["stats"]))
        check(mutant_gaps[mode][0] > TP_LOGIT_TOL and mutant_gaps[mode][1] > TP_STAT_TOL,
              f"14d: the tolerances pass a {mode} all-reduce: {mutant_gaps[mode]}")
    gb = 1e9
    res = dict(
        match_rate_vs_one_rank=match_rate(tp, single),
        first_prefill_logit_gap=pre_gap, first_prefill_max_abs_logit=pre_max,
        first_prefill_stat_gap=s_gap,
        mutant_prefill_logit_and_stat_gaps=mutant_gaps,
        first_decode_logit_gap=dec_gap, first_decode_max_abs_logit=dec_max,
        share_of_margins_above_2x_decode_gap=statistics.fmean(
            m > 2 * dec_gap for v in margins.values() for m in v),
        logit_tol=TP_LOGIT_TOL, stat_tol=TP_STAT_TOL,
        decode_tick_wall_ms_p50_tp2=statistics.median(ranks[0]["decode_ticks"]) * 1e3
        if ranks[0]["decode_ticks"] else None,
        decode_tick_wall_ms_p50_one_rank=statistics.median(one_ticks) * 1e3
        if one_ticks else None,
        decode_tick_wall_ms_p50_phase4=yi["decode_tick_wall_ms_p50"],
        decode_ticks=len(ranks[0]["decode_ticks"]),
        tokens_per_s_tp2=ranks[0]["tokens_per_s"], ttft_p50_s_tp2=ranks[0]["ttft_p50_s"],
        tokens_per_s_phase4=yi["tokens_per_s"],
        param_gb_per_rank=[r["param_bytes"] / gb for r in ranks],
        param_gb_one_rank=full_bytes / gb,
        pool_gb_per_rank=[r["pool_bytes"] / gb for r in ranks],
        pool_gb_one_rank=one_pool / gb,
        compacted_ff_gb_per_rank=[r["compacted_bytes"] / gb for r in ranks],
        compacted_ff_gb_one_rank=one_compacted / gb,
        peak_gb_per_rank=[r["peak_bytes"] / gb for r in ranks],
        init_s_per_rank=[r["init_s"] for r in ranks],
        drain_wall_s_tp2=ranks[0]["wall_s"], spawn_to_result_s=spawn_wall,
        rid0_tp2=tp[0][:8], rid0_one_rank=single[0][:8],
        frontend_sse_equal_drain=True,
        frontend_wall_s=fes[0]["wall_s"],
        frontend_tick_wall_ms_p50_per_rank=[f["tick_wall_ms_p50"] for f in fes],
        frontend_decode_tick_wall_ms_p50_per_rank=[f["decode_tick_wall_ms_p50"]
                                                   for f in fes],
        frontend_ticks=fes[0]["ticks"], frontend_decode_ticks=fes[0]["decode_ticks"],
        frontend_broadcast_ms_p50=fes[0]["broadcast_ms_p50"],
        frontend_broadcast_ms_max=fes[0]["broadcast_ms_max"],
        frontend_control_messages=fes[0]["messages"],
        frontend_ttft_p50_s=fes[0]["ttft_p50_s"], frontend_ttft_p99_s=fes[0]["ttft_p99_s"],
        frontend_peak_gb_per_rank=[f["peak_bytes"] / gb for f in fes])
    return counts, res

# ---------------------------------------------------------------------------
# phase 15: sharded training (the (data, model) training mesh) — one
# process per rank, all ranks on the one card over gloo, TF32 off
# ---------------------------------------------------------------------------

#: 15a-c: the tier-1 tests' setups (tests/test_torch_train_mesh.py):
#: AdamW at this lr, 3 steps on one batch; losses card == CPU within the
#: reference's ``prog_train_mesh.py`` tolerance, parameters within
#: ``TRAIN_CARD_TOL``'s rule at this lr (three steps of about lr each)
MESH_SMOKE_LR = 1e-2
MESH_LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
MESH_CARD_TOL = dict(rtol=1e-4, atol=1e-5, few=5e-3, few_atol=3 * MESH_SMOKE_LR)
#: MoE blocks (routed EP, 2-D EP) card == CPU: outputs and gradients,
#: relative to each tensor's largest value (the dispatch's backward adds
#: with atomics on the card)
MESH_MOE_TOL = 1e-5

#: 15d: Yi-9B at full width, cut to 4 of its 48 layers, bf16, remat, at
#: (2, 2) under ``policy_for``'s rules (FSDP), AdamW, one 4 x 512 batch;
#: 15e: Moonshot-v1-16B-A3B at full width, 2 layers (its dense layer and
#: one MoE layer), routed EP at (1, 2)
MESH_YI = dict(layers=4, B=4, S=512, steps=2, lr=1e-4)
MESH_MOON = dict(layers=2, B=2, S=512, steps=2, lr=1e-4)
#: 15d/e against one rank on the card: the first step's loss (relative)
#: and each leaf's gradient (largest difference over the leaf's largest
#: |g| of one rank's).  The mesh adds bf16 roundings of the all-reduced
#: partial sums and of FSDP's reduce-scatter; each run also builds the
#: mutants of ``MESH_MUTANTS``, each of which these limits must refuse.
#: Set from readings on an H100 (``PERF.md`` §6): first losses 5.4e-6 and
#: 4.5e-6 apart, gradients at most 1.7% (15d) and 1.4% (15e), the
#: ``enter_backward`` mutant 129%.
MESH_FULL_LOSS_TOL = 1e-4
MESH_FULL_GRAD_TOL = 0.10
#: 15e's routed experts and router, held in norm (the difference's norm
#: over one rank's block norm): bf16 rounding moves near ties of the
#: routing, each flip moving one token's whole share of an expert's
#: gradient (largest differences 22-24% of the leaf's largest |g|, norms
#: 4.8-5.5% on the H100; 15e counts the flipped assignments)
MESH_ROUTED_GRAD_TOL = 0.20
#: 15e's routed experts' output (``_moe_trace``) in a no-grad forward
#: against one rank's, in norm: the first loss does not see a combine
#: without its sum over ``model`` at the init (2.4e-6 on the H100, under
#: the mesh's own 4.5e-6), so the routed output is held itself; each
#: flipped routing moves a whole row's share of one expert
MESH_MOE_OUT_TOL = 0.20
#: the mutants 15d and 15e build each run, by the run they belong to, and
#: what they are held to: ``grads`` (their step-1 gradients must fail
#: ``MESH_FULL_GRAD_TOL``), ``routed`` (must fail ``MESH_ROUTED_GRAD_TOL``),
#: ``loss`` (their first loss must fail ``MESH_FULL_LOSS_TOL``) or
#: ``moe_out`` (their MoE blocks' output must fail ``MESH_MOE_OUT_TOL``)
MESH_MUTANTS = {
    "15d_yi9b": {"enter_backward": "grads", "reduce_forward": "loss"},
    "15e_moonshot": {"ep_dispatch": "routed", "ep_combine": "moe_out"},
}

#: 15f: the MoE dispatch over several global chunks at full width, on the
#: MoE block of 15e's 2-layer Moonshot (fp32, capacity factor 1.0, so
#: assignments drop): the dispatch without EP on the 4 data ranks of 15c's
#: spawn, each global chunk of ``dp_chunk`` tokens spanning two of them,
#: and routed EP at (2, 2) in 15a's spawn, with ``ep_chunk`` tokens a
#: chunk (each split over the 2 data rows).  Held against one rank's
#: ``moe_forward`` at the reference's grouping: the global chunks, and
#: for routed EP blocks of ``ep_chunk / 2`` tokens each with its own
#: capacity.  ``MOE_CHUNK_TOL``: the largest |difference| over the
#: largest |y| (fp32, TF32 off: the ranks' expert products run at other
#: batch shapes, and routed EP sums two partial outputs); the old per-row
#: grouping of the dispatch without EP must miss by more.
MOE_CHUNKS = dict(B=4, S=512, capacity_factor=1.0, dp_chunk=1024, ep_chunk=512,
                  seed=3)
MOE_CHUNK_TOL = 1e-4


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_np(v) for v in tree]
    return tree.detach().float().cpu().numpy()


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k], path + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree)
                for p, v in _paths(t, path + (str(i),)).items()}
    return {"/".join(path): tree}


def mesh_smoke_cfg(tag: str):
    from repro_torch.configs.registry import get_config

    if tag == "yi":  # the reference's prog_train_mesh.py config
        return get_config("yi-9b", smoke=True).replace(
            d_model=64, d_ff=128, num_heads=4, num_kv_heads=2, vocab_size=256,
            dtype="float32")
    if tag == "tiny":
        return get_config("tinylm")
    if tag == "elastic":  # prog_elastic.py's
        return get_config("tinylm").replace(
            num_layers=2, d_model=32, d_ff=64, num_heads=2, num_kv_heads=2,
            head_dim=16, vocab_size=256)
    if tag == "ep":
        return get_config("moonshot-v1-16b-a3b", smoke=True)
    if tag == "ep2d":
        return get_config("deepseek-v3-671b", smoke=True).replace(moe_group_limit=1)
    raise KeyError(tag)


def mesh_train_steps(torch, np, cfg, mesh, rules, steps, lr, tokens, dev):
    """3 AdamW steps of the smoke setup from the CPU init (seed 0): the
    losses and the full parameters after them (on one rank without a
    mesh)."""
    from repro_torch import bridge
    from repro_torch.distributed.tp import TrainTP
    from repro_torch.models import decoder
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_step as ts

    opt = opt_lib.adamw(lr)
    params = decoder.init_params(cfg, 0, "cpu")
    if mesh is None:
        params = to_device(params, dev)
        state = {"params": params, "opt": opt.init(bridge.ref_view(params, cfg)),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
    else:
        tp = TrainTP(cfg, mesh, rules)
        params = tp.shard_params(params, dev)
        state = {"params": params,
                 "opt": opt.init(bridge.ref_view(params, cfg), shard=tp.leaf_shards()),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
    step = ts.build_train_step(cfg, opt, mesh=mesh, rules=rules)
    batch = {"tokens": torch.from_numpy(tokens).to(dev)}
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    full = state["params"] if mesh is None else step.tp.gather_params(state["params"])
    return losses, _tree_np(full)


def mesh_moe_block(torch, np, mesh, tag, dev):
    """The MoE block on this rank's rows under the training mesh's rules
    (15b): y, and d(sum(y * ct))/d(x, params) with the parameter
    gradients summed over ``data`` where the leaf is replicated over it."""
    from repro_torch.distributed import sharding as shlib
    from repro_torch.distributed.tp import block_of
    from repro_torch.models import param as param_lib
    from repro_torch.models.layers import moe

    cfg = mesh_smoke_cfg(tag)
    rules = shlib.make_rules(phase="train", expert_2d=tag == "ep2d")
    specs = _paths(shlib.tree_specs(moe.moe_specs(cfg), mesh, rules))
    full = _paths(param_lib.init_params(moe.moe_specs(cfg), 0, cfg.dtype, "cpu"))
    keys = sorted(full)
    local = {k: block_of(full[k], specs[k], mesh).to(dev).requires_grad_(True)
             for k in keys}
    tree = {}
    for k, v in local.items():
        node, parts = tree, k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    rng = np.random.default_rng(15)
    x = rng.normal(size=(4, 8, cfg.d_model)).astype(np.float32)
    ct = rng.normal(size=(4, 8, cfg.d_model)).astype(np.float32)
    axes = shlib.batch_axes(mesh, rules)
    nd, r = mesh.extent(axes), mesh.coord(axes)
    rows = slice(r * 4 // nd, (r + 1) * 4 // nd)
    xt = torch.from_numpy(x[rows]).to(dev).requires_grad_(True)
    with shlib.axis_rules(mesh, rules):
        y, aux, _ = moe.moe_forward(tree, xt, cfg)
        gs = torch.autograd.grad((y * torch.from_numpy(ct[rows]).to(dev)).sum(),
                                 [xt] + [local[k] for k in keys])
    out = {"y": y.detach().cpu().numpy(), "aux": float(aux.detach()),
           "gx": gs[0].cpu().numpy()}
    for k, g in zip(keys, gs[1:]):
        if "data" not in str(specs[k]) and nd > 1:
            g = shlib.all_reduce_(g.contiguous(), mesh.group("data"))
        out[k] = g.cpu().numpy()
    return out


def mesh_smoke_rank(mesh, ckdir, yi_spec, yi_ref, moe_ref=None):
    """One rank of 15a-d at (2, 2) (a spawned process, on the card or, for
    the comparison, on the CPU): the yi and tinylm smoke setups with FSDP,
    the MoE blocks (routed EP on Moonshot's smoke config, 2-D EP on
    DeepSeek-V3's with ``moe_group_limit=1``), with ``ckdir`` an elastic
    run's first step into a checkpoint there, and with ``yi_spec`` 15d
    (``mesh_full_rank``, its mutants included); with ``moe_ref`` 15f's
    routed EP over several global chunks."""
    import numpy as np
    import torch

    from repro_torch import bridge
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.distributed import sharding as shlib
    from repro_torch.distributed.tp import TrainTP
    from repro_torch.models import decoder
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training.loop import train

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (4, 32)).astype(np.int64)
    rules = shlib.make_rules(phase="train", fsdp=True)
    out = {}
    for tag in ("yi", "tiny"):
        out[tag] = mesh_train_steps(torch, np, mesh_smoke_cfg(tag), mesh, rules, 3,
                                    MESH_SMOKE_LR, tokens, dev)
    for tag in ("ep", "ep2d"):
        out[tag] = mesh_moe_block(torch, np, mesh, tag, dev)
    if ckdir is not None:
        cfg = mesh_smoke_cfg("elastic")
        erules = shlib.make_rules(phase="train", fsdp=False)
        tp = TrainTP(cfg, mesh, erules)
        opt = opt_lib.adamw(MESH_SMOKE_LR)
        params = tp.shard_params(decoder.init_params(cfg, 0, "cpu"), dev)
        state = {"params": params,
                 "opt": opt.init(bridge.ref_view(params, cfg), shard=tp.leaf_shards()),
                 "step": torch.zeros((), dtype=torch.int32, device=dev)}
        etok = np.random.default_rng(2).integers(0, 256, (8, 32)).astype(np.int64)
        res = train(cfg, opt, [{"tokens": etok}], 1, state=state, log_every=0,
                    ckpt=CheckpointManager(ckdir, interval=1, use_async=False),
                    mesh=mesh, rules=erules)
        out["elastic"] = res.losses
    if moe_ref is not None:
        out["moe_ep"] = moe_chunk_rank(torch, mesh, moe_ref, "ep",
                                       yi_spec is not None and yi_spec.get("smoke", False))
    if yi_spec is not None:
        out["yi9b"] = mesh_full_rank(mesh, "yi-9b", yi_spec, yi_ref,
                                     MESH_MUTANTS["15d_yi9b"])
    return out


def mesh_compression_rank(mesh, moe_ref=None, smoke=False):
    """15c: the reference's 20-step int8 error-feedback all-reduce check on
    4 data ranks (identical gradients, then distinct ones); with
    ``moe_ref``, 15f's dispatch without EP on these ranks."""
    import numpy as np
    import torch

    from repro_torch.training.compression import init_residual, make_compressed_allreduce

    dev = mesh.device
    g_host = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    allreduce = make_compressed_allreduce(mesh, "data")
    r, n = mesh.coord("data"), mesh.shape["data"]
    out = {}
    for same in (True, False):
        residual = init_residual({"w": torch.zeros(64, 64, device=dev)})
        true_acc = np.zeros_like(g_host)
        comp_acc = np.zeros_like(g_host)
        for step in range(20):
            base = g_host * (1 + 0.1 * step)
            mine = base if same else base + 0.05 * r
            mean, residual = allreduce({"w": torch.from_numpy(mine).to(dev)}, residual)
            true_acc += base if same else base + 0.05 * (n - 1) / 2
            comp_acc += mean["w"].cpu().numpy()
        out["same" if same else "distinct"] = float(
            np.abs(comp_acc - true_acc).max() / np.abs(true_acc).max())
    if moe_ref is not None:
        torch.backends.cuda.matmul.allow_tf32 = False
        out["moe_dp"] = moe_chunk_rank(torch, mesh, moe_ref, "dp", smoke)
    return out


def moe_chunk_setup(torch, dev, smoke: bool = False):
    """15f's MoE block (fp32, drawn from ``MOE_CHUNKS['seed']`` on ``dev``)
    without its shared experts (every rank runs them whole; their output
    would hide a dropped assignment), and its input ``[B, S, D]``."""
    from repro_torch.models import param as param_lib
    from repro_torch.models.layers import moe

    m = MOE_CHUNKS
    cfg = mesh_full_cfg("moonshot-v1-16b-a3b", dict(MESH_MOON, smoke=smoke)).replace(
        dtype="float32", capacity_factor=m["capacity_factor"])
    specs = {k: v for k, v in moe.moe_specs(cfg).items() if k != "shared"}
    params = param_lib.init_params(specs, m["seed"], "float32", dev)
    g = torch.Generator(device=dev).manual_seed(m["seed"])
    x = torch.randn(m["B"], m["S"], cfg.d_model, generator=g, device=dev)
    return cfg, params, x


def moe_chunk_one(torch, dev, path: str, smoke: bool = False):
    """15f's one rank: ``moe_forward`` at the reference's grouping of each
    job, saved to ``path``; the assignments each grouping drops."""
    from repro_torch.models.layers import moe

    m = MOE_CHUNKS
    cfg, params, x = moe_chunk_setup(torch, dev, smoke)
    xt = x.reshape(-1, cfg.d_model)
    idx = moe._route(params, xt, cfg, want_aux=False)[1].cpu()

    def dropped(width):
        C = moe._capacity(width, cfg)
        hot = torch.zeros(idx.shape[0], cfg.num_experts, dtype=torch.int64)
        hot.scatter_(1, idx, 1)
        load = hot.reshape(-1, width, cfg.num_experts).sum(1)
        return int((load - C).clamp(min=0).sum())

    out, drops = {}, {}
    with torch.no_grad():
        for job, chunk in (("dp", m["dp_chunk"]), ("ep", m["ep_chunk"] // 2)):
            y, aux, _ = moe.moe_forward(params, x, cfg, chunk_tokens=chunk)
            out[job] = dict(y=y.cpu(), aux=float(aux))
            drops[job] = dropped(chunk)
    drops["dp_old_per_row"] = dropped(m["dp_chunk"] // 4)
    drops["assignments"] = idx.numel()
    torch.save(out, path)
    return drops


def moe_chunk_rank(torch, mesh, path: str, job: str, smoke: bool = False):
    """15f on one rank of a spawn: this rank's rows of the MoE block under
    the training mesh's rules, against one rank's (``path``); the dispatch
    without EP also with the old per-row grouping (a mutant)."""
    from repro_torch.distributed import sharding as shlib
    from repro_torch.distributed.tp import block_of
    from repro_torch.models.layers import moe

    m = MOE_CHUNKS
    t_job = time.perf_counter()
    cfg, full, x = moe_chunk_setup(torch, mesh.device, smoke)
    rules = shlib.make_rules(phase="train")
    specs = _paths(shlib.tree_specs(
        {k: v for k, v in moe.moe_specs(cfg).items() if k != "shared"}, mesh, rules))
    tree = {}
    for k, v in _paths(full).items():
        node, parts = tree, k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = block_of(v, specs[k], mesh)
    del full
    axes = shlib.batch_axes(mesh, rules)
    nd, r = mesh.extent(axes), mesh.coord(axes)
    w = m["B"] // nd
    x = x[r * w:(r + 1) * w]
    ref = torch.load(path)[job]
    want = ref["y"][r * w:(r + 1) * w].to(mesh.device)
    scale = float(ref["y"].abs().max())
    chunk = m["dp_chunk"] if job == "dp" else m["ep_chunk"]

    def gap():
        with torch.no_grad(), shlib.axis_rules(mesh, rules):
            y, aux, _ = moe.moe_forward(tree, x, cfg, chunk_tokens=chunk)
        return float((y - want).abs().max()) / scale, float(aux)

    t0 = time.perf_counter()
    y_gap, aux = gap()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    out = dict(y_gap=y_gap, aux_rel=abs(aux - ref["aux"]) / abs(ref["aux"]),
               wall_ms=(time.perf_counter() - t0) * 1e3)
    with shlib.axis_rules(mesh, rules):
        out["ep"] = moe._ep_shard_info(cfg) is not None
    if job == "dp":
        good = moe._global_chunks

        def old(idx, chunk, cfg, mesh, rules):
            n = mesh.extent(shlib.batch_axes(mesh, rules))
            return [(i, i + chunk // n, chunk // n, None)
                    for i in range(0, idx.shape[0], chunk // n)]

        moe._global_chunks = old
        try:
            out["old_grouping_y_gap"] = gap()[0]
        finally:
            moe._global_chunks = good
    del tree, x, want
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    out["job_s"] = time.perf_counter() - t_job
    return out


def mesh_full_cfg(arch: str, spec: dict):
    """The arch at ``spec['layers']`` layers (``spec['smoke']``: its smoke
    config, for a rehearsal on the CPU)."""
    from repro_torch.configs.registry import get_config

    return get_config(arch, smoke=spec.get("smoke", False)).replace(
        num_layers=spec["layers"])


def mesh_full_rules(cfg, B: int, S: int, seq_parallel: bool = False):
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.policies import policy_for

    return policy_for(cfg, ShapeConfig("chip", S, B, "train"),
                      seq_parallel=seq_parallel).rules


def mesh_full_batch(torch, cfg, B, S, dev):
    gen = torch.Generator(device="cpu")
    gen.manual_seed(15)
    return {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen).to(dev)}


def mesh_full_one(torch, np, dev, arch: str, spec: dict, ref_path: str):
    """15d/e's one rank on the card: the step-1 gradients (saved to
    ``ref_path`` on the host), then ``spec['steps']`` AdamW steps; the
    losses, the step walls and the state's bytes."""
    from repro_torch.distributed.tp import tree_bytes
    from repro_torch.models import decoder
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_step as ts

    cfg = mesh_full_cfg(arch, spec)
    opt = opt_lib.adamw(spec["lr"])
    state = ts.init_train_state(cfg, opt, 0, dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    batch = mesh_full_batch(torch, cfg, spec["B"], spec["S"], dev)
    loss, _, grads = ts.value_and_grad(decoder.loss_fn, state["params"], batch, cfg)
    grads = {k: g for k, g in _paths(grads).items() if g is not None}
    with torch.no_grad(), _moe_trace() as moe_trace:
        decoder.loss_fn(state["params"], batch, cfg)
    torch.save({"grads": {k: g.detach().cpu() for k, g in grads.items()},
                "scale": {k: float(g.detach().float().abs().max())
                          for k, g in grads.items()},
                "norm": {k: float(g.detach().float().norm()) for k, g in grads.items()},
                "moe": moe_trace},
               ref_path)
    del grads
    step = ts.build_train_step(cfg, opt)
    losses, walls = [], []
    for _ in range(spec["steps"]):
        sync()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
    out = dict(first_loss=float(loss), losses=losses,
               step_wall_ms=[round(w * 1e3, 1) for w in walls],
               param_bytes=tree_bytes(state["params"]),
               opt_bytes=tree_bytes(state["opt"]),
               leaf_bytes={k: v.numel() * v.element_size()
                           for k, v in _paths(state["params"]).items()})
    del state, batch
    if dev.type == "cuda":
        free(torch)
    return out


def _grad_gaps(torch, tp, grads, ref):
    """Per leaf: max |rank's block - one rank's block| over the one rank's
    largest |g| of the leaf, and the blocks' difference norm over the
    one rank's block norm (``(max_gap, norm_gap)``), on the rank's
    device."""
    shapes = _paths(tp.param_shapes)
    specs = _paths(tp.param_specs)
    gaps = {}
    for k, g in _paths(grads).items():
        if k not in ref["grads"]:
            continue
        blk = ref["grads"][k][tp.slices(specs[k], shapes[k].shape)].to(
            g.device, torch.float32)
        d = g.detach().float() - blk
        gaps[k] = (float(d.abs().max()) / max(ref["scale"][k], 1e-30),
                   float(d.norm()) / max(float(blk.norm()), 1e-30))
    return gaps


@contextlib.contextmanager
def _moe_trace(keep_inputs: bool = False):
    """What each MoE block does while the scope is open, one entry per
    block call in call order, on the host: ``idx``, the experts it routes
    its tokens to ([T, k]), and ``y``, the output of its routed experts
    alone ([B, S, D], fp32; the shared experts, which every rank runs
    whole, would hide a broken combine), from a second call without
    them; with ``keep_inputs`` also ``calls``: each call's routed
    parameters and input, on the device, to run the block again."""
    from repro_torch.models.layers import moe

    got = {"idx": [], "y": [], "calls": []}
    real_route, real_forward = moe._route, moe.moe_forward
    keep = [True]

    def route(params, x, cfg, *a, **kw):
        gate, idx, aux = real_route(params, x, cfg, *a, **kw)
        if keep[0]:
            got["idx"].append(idx.detach().cpu())
        return gate, idx, aux

    def forward(params, x, cfg, *a, **kw):
        out = real_forward(params, x, cfg, *a, **kw)
        keep[0] = False
        routed = {k: v for k, v in params.items() if k != "shared"}
        got["y"].append(real_forward(routed, x, cfg, *a, **kw)[0].detach().float().cpu())
        if keep_inputs:
            got["calls"].append((routed, x.detach(), cfg, a, kw))
        keep[0] = True
        return out

    moe._route, moe.moe_forward = route, forward
    try:
        yield got
    finally:
        moe._route, moe.moe_forward = real_route, real_forward


def _route_moves(torch, mine, ref, E):
    """``(tokens whose expert set differs, assignments moved, assignments)``
    between a rank's routing and one rank's on the same rows."""
    tokens = moved = total = 0
    for a, b in zip(mine, ref):
        ha = torch.zeros(a.shape[0], E, dtype=torch.bool).scatter_(1, a, True)
        hb = torch.zeros(b.shape[0], E, dtype=torch.bool).scatter_(1, b, True)
        tokens += int((ha != hb).any(1).sum())
        moved += int((ha & ~hb).sum())
        total += a.numel()
    return tokens, moved, total


@contextlib.contextmanager
def _mutant(name: str):
    """One collective of the training mesh broken (``MESH_MUTANTS``):
    ``enter_backward`` drops the backward all-reduce before every
    column-split projection, ``reduce_forward`` the forward all-reduce
    after every row-split one; ``ep_dispatch`` drops the routed dispatch's
    backward all-reduce and ``ep_combine`` the routed combine's sum over
    ``model``, in the MoE block alone."""
    import types

    from repro_torch.distributed import sharding as shlib
    from repro_torch.models.layers import moe

    if any(name in v for v in WHOLE_MUTANTS.values()):  # phase 17's
        with whole_mutant(name):
            yield
        return
    if name in ("enter_backward", "reduce_forward"):
        cls, attr = ((shlib._Enter, "backward") if name == "enter_backward"
                     else (shlib._Reduce, "forward"))
        real = cls.__dict__[attr]
        setattr(cls, attr, staticmethod(
            (lambda ctx, g: (g, None)) if name == "enter_backward"
            else (lambda ctx, x, group: x.clone())))
    else:
        cls, attr, real = moe, "shlib", moe.shlib
        broken = types.SimpleNamespace(**vars(shlib))
        if name == "ep_dispatch":  # the block's entry without its backward sum
            broken.block_in = lambda x: x
        else:  # the block's partial sums left unsummed
            broken.block_out = lambda y, partial=True, d=1: y
        moe.shlib = broken
    try:
        yield
    finally:
        setattr(cls, attr, real)


def mesh_full_rank(mesh, arch: str, spec: dict, ref_path: str, mutants: dict):
    """One rank of 15d/e (a spawned process): the model drawn as one rank
    draws it (seed 0 on the card) and cut to this rank's blocks
    (``TrainTP.init_params``); the step-1 gradients against one rank's
    (``ref_path``); ``spec['steps']`` AdamW steps with their walls and the
    all-reduces of each; this rank's parameter and optimizer bytes by
    leaf; where the model routes, its routed experts' output and routing
    in a no-grad forward against one rank's; then each of ``mutants``
    (``MESH_MUTANTS``): its step-1 gradients, its first loss or its
    routed experts' output."""
    import torch

    from repro_torch.distributed import sharding as shlib
    from repro_torch.distributed.tp import TrainTP, tree_bytes
    from repro_torch.models import decoder
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    on_card = dev.type == "cuda"  # a CPU rehearsal has no card
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = mesh_full_cfg(arch, spec)
    rules = mesh_full_rules(cfg, spec["B"], spec["S"], spec.get("seq_parallel", False))
    tp = TrainTP(cfg, mesh, rules)
    opt = opt_lib.adamw(spec["lr"])
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state = tp.init_train_state(opt, 0, dev)
    batch = mesh_full_batch(torch, cfg, spec["B"], spec["S"], dev)
    rows = ts._rows(mesh, rules, 1)
    local = {"tokens": rows(batch["tokens"], 0)}
    ref = torch.load(ref_path, mmap=True)

    def grads_once():
        flat, rebuild = ts._flatten(state["params"])
        with shlib.axis_rules(mesh, rules):
            loss, _, g = ts.value_and_grad(decoder.loss_fn, state["params"], local, cfg)
            sp = shlib.sp_wanted(local["tokens"].shape[1])
        gflat = [torch.zeros_like(p) if x is None else x
                 for p, x in zip(flat, ts._flatten(g)[0])]
        return float(loss), tp.sync_grads(rebuild(gflat), sp)

    def loss_once():
        with torch.no_grad(), shlib.axis_rules(mesh, rules):
            return float(decoder.loss_fn(state["params"], local, cfg)[0])

    B = batch["tokens"].shape[0]
    ref_y = [rows(y, 0) for y in ref["moe"]["y"]]

    def moe_out_gap():
        """The routed experts' output in a no-grad forward against one
        rank's on this rank's rows (the difference's norm over one rank's
        norm), and the routing moves (``_route_moves``)."""
        with _moe_trace() as got:
            loss_once()
        d = sum(float((a - b).norm()) ** 2 for a, b in zip(got["y"], ref_y)) ** 0.5
        n = sum(float(b.norm()) ** 2 for b in ref_y) ** 0.5
        mine = [rows(r.reshape(B, -1), 0).reshape(-1, r.shape[1])
                for r in ref["moe"]["idx"]]
        return d / max(n, 1e-30), _route_moves(torch, got["idx"], mine, cfg.num_experts)

    loss1, grads = grads_once()
    gaps = _grad_gaps(torch, tp, grads, ref)
    del grads
    moe_gap = route_moves = None
    if ref_y:
        moe_gap, route_moves = moe_out_gap()
    mutant_out = {}
    for name, held in mutants.items():
        with _mutant(name):
            if held == "loss":
                mutant_out[name] = loss_once()
            elif held == "moe_out":
                mutant_out[name] = moe_out_gap()[0]
            else:
                _, grads = grads_once()
                mutant_out[name] = _grad_gaps(torch, tp, grads, ref)
                del grads
    step = ts.build_train_step(cfg, opt, mesh=mesh, rules=rules)
    losses, walls, traffic = [], [], []
    for _ in range(spec["steps"]):
        sync()
        shlib.reset_traffic()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        walls.append(time.perf_counter() - t0)
        traffic.append(dict(shlib.TRAFFIC))
    out = dict(first_loss=loss1, gaps=gaps, losses=losses,
               step_wall_ms=[round(w * 1e3, 1) for w in walls], traffic=traffic,
               param_bytes=tree_bytes(state["params"]),
               opt_bytes=tree_bytes(state["opt"]),
               leaf_bytes={k: v.numel() * v.element_size()
                           for k, v in _paths(state["params"]).items()},
               peak_gb=torch.cuda.max_memory_allocated() / 1e9 if on_card else 0.0,
               moe_out_gap=moe_gap, route_moves=route_moves, mutants=mutant_out)
    return out


def mesh_resume_rank(mesh, ckdir, moon_spec, moon_ref):
    """One rank of 15c's second half and of 15e at (1, 2) (a spawned
    process): the elastic run re-meshed from (2, 2) to (1, 2), restored
    from ``ckdir`` and continued one step, beside one rank restored from
    the same checkpoint without a mesh and stepped on the same rows; then
    Moonshot at full width (``mesh_full_rank``)."""
    import numpy as np
    import torch

    from repro_torch import bridge
    from repro_torch.checkpoint import checkpointer
    from repro_torch.distributed import sharding as shlib
    from repro_torch.distributed.tp import TrainTP
    from repro_torch.runtime.elastic import plan_remesh
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_step as ts

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = mesh_smoke_cfg("elastic")
    rules = shlib.make_rules(phase="train", fsdp=False)
    plan = plan_remesh((2, 2), ("data", "model"), failed_data_rows=[1])
    check(plan.new_shape == mesh.dims, f"15c remesh to {plan.new_shape}")
    restored, n = checkpointer.restore(ckdir)
    state = bridge.train_state_from_jax(restored, cfg, mesh.device,
                                        tp=TrainTP(cfg, mesh, rules))
    etok = np.random.default_rng(2).integers(0, 256, (8, 32)).astype(np.int64)
    nb = int(8 * plan.global_batch_scale)
    batch = {"tokens": torch.from_numpy(etok[:nb]).to(mesh.device)}
    step = ts.build_train_step(cfg, opt_lib.adamw(MESH_SMOKE_LR), mesh=mesh,
                               rules=rules)
    state, m = step(state, batch)
    one = bridge.train_state_from_jax(restored, cfg, mesh.device)
    one, m1 = ts.build_train_step(cfg, opt_lib.adamw(MESH_SMOKE_LR))(one, batch)
    out = {"resume": dict(step=n, loss=float(m["loss"]), one_loss=float(m1["loss"]),
                          params=_tree_np(step.tp.gather_params(state["params"])),
                          one_params=_tree_np(one["params"]))}
    del state, one
    out["moonshot"] = mesh_full_rank(mesh, "moonshot-v1-16b-a3b", moon_spec,
                                     moon_ref, MESH_MUTANTS["15e_moonshot"])
    return out


def _smoke_close(torch, np, a, b):
    """(ok, worst, share) of two numpy trees within ``MESH_CARD_TOL``."""
    ta = [torch.from_numpy(np.asarray(v)) for v in _paths(a).values()]
    tb = [torch.from_numpy(np.asarray(v)) for v in _paths(b).values()]
    return trees_close(torch, ta, tb, **MESH_CARD_TOL)


def _moe_close(np, a, b) -> float:
    """Largest gap of two MoE block results, relative to each tensor's
    largest value."""
    worst = 0.0
    for k, v in a.items():
        if k == "aux":
            worst = max(worst, abs(v - b[k]) / max(abs(b[k]), 1e-30))
            continue
        worst = max(worst, float(np.abs(v - b[k]).max() / max(np.abs(b[k]).max(), 1e-30)))
    return worst


def _bytes_by_kind(leaf_bytes, one_bytes):
    """Per-rank bytes over one rank's, by kind of leaf: the routed
    experts, the layers' other matrices, and each other leaf name."""
    kinds = {}
    for k, b in leaf_bytes.items():
        parent, name = k.rsplit("/", 1)
        if k.startswith("layers/") and parent + "/router" in leaf_bytes and \
                name in ("w1", "w2", "wg"):
            kind = "experts"
        elif k.startswith("layers/") and one_bytes[k] >= 1 << 20:
            kind = "layer_matrices"  # the norms' scales are a few KB
        else:
            kind = k.split("/")[0] + "/" + name
        s = kinds.setdefault(kind, [0, 0])
        s[0] += b
        s[1] += one_bytes[k]
    return {k: round(v[0] / v[1], 4) for k, v in kinds.items()}


def phase_mesh_train(torch, np, dev, tmp: Path, yi_spec=MESH_YI,
                     moon_spec=MESH_MOON):
    """Phase 15: sharded training on the card (module docstring).  With
    ``dev`` the CPU and smoke specs, a rehearsal on the CPU."""
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch.mesh import run_ranks

    res: dict = {}
    counts: dict = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    from concurrent.futures import ThreadPoolExecutor

    card_dev = dev.type
    mesh22 = dict(backend="gloo", shape=(2, 2), axes=("data", "model"),
                  timeout_s=600)
    ck = str(tmp / "elastic_ckpt")
    yi_ref, moon_ref = str(tmp / "yi_grads.pt"), str(tmp / "moon_grads.pt")
    with ThreadPoolExecutor(1) as ex:
        # the CPU ranks run beside the one-rank runs, which use the card
        t0 = time.perf_counter()
        f_cpu = ex.submit(run_ranks, mesh_smoke_rank, 4, device="cpu",
                          args=(None, None, None), **mesh22)
        # 15a: one rank on the card and on the CPU
        rng = np.random.default_rng(1)
        tokens = rng.integers(0, 256, (4, 32)).astype(np.int64)
        one = {tag: {d.type: mesh_train_steps(torch, np, mesh_smoke_cfg(tag), None,
                                              None, 3, MESH_SMOKE_LR, tokens, d)
                     for d in (dev, torch.device("cpu"))}
               for tag in ("yi", "tiny")}
        # 15d's and 15e's one rank, freed before the ranks draw theirs
        yi_one = mesh_full_one(torch, np, dev, "yi-9b", yi_spec, yi_ref)
        moon_one = mesh_full_one(torch, np, dev, "moonshot-v1-16b-a3b", moon_spec,
                                 moon_ref)
        # 15f's one rank
        smoke = moon_spec.get("smoke", False)
        moe_ref = str(tmp / "moe_chunks.pt")
        t_moe = time.perf_counter()
        drops = moe_chunk_one(torch, dev, moe_ref, smoke)
        moe_one_s = time.perf_counter() - t_moe
        if dev.type == "cuda":
            free(torch)
        res["one_rank_s"] = round(time.perf_counter() - t0, 1)
        # 15a-d, 15f's routed EP: (2, 2) on the card
        t0 = time.perf_counter()
        card, c = run_ranks(mesh_smoke_rank, 4, device=card_dev,
                            args=(ck, yi_spec, yi_ref, moe_ref), **mesh22)
        add(c)
        res["ranks_22_s"] = round(time.perf_counter() - t0, 1)
        cpu, _ = f_cpu.result()
        # 15c compression on 4 data ranks beside 15c's and 15e's (1, 2)
        t0 = time.perf_counter()
        f_comp = ex.submit(run_ranks, mesh_compression_rank, 4, backend="gloo",
                           device=card_dev, shape=(4,), axes=("data",),
                           args=(moe_ref, smoke), timeout_s=300)
        tail, c = run_ranks(mesh_resume_rank, 2, backend="gloo", device=card_dev,
                            shape=(1, 2), axes=("data", "model"),
                            args=(ck, moon_spec, moon_ref), timeout_s=600)
        add(c)
        comp, c = f_comp.result()
        add(c)
        res["ranks_12_and_4_s"] = round(time.perf_counter() - t0, 1)

    # 15a: card ranks == one rank on the card == CPU
    for tag in ("yi", "tiny"):
        ref_l, ref_p = one[tag]["cpu"]
        for what, (l, p) in [("one rank on the card", one[tag][card_dev])] + \
                [(f"card rank {r}", card[r][tag]) for r in (0,)] + \
                [("CPU ranks", cpu[0][tag])]:
            check(np.allclose(l, ref_l, **MESH_LOSS_TOL),
                  f"15a {tag} {what} losses {l} vs CPU {ref_l}")
            ok, worst, share = _smoke_close(torch, np, p, ref_p)
            check(ok, f"15a {tag} {what} params vs CPU: worst {worst}, share {share}")
            res[f"15a_{tag}_{what.replace(' ', '_')}"] = dict(
                losses=[round(x, 6) for x in l], param_worst=worst, param_share=share)
        for r in range(4):
            check(card[r][tag][0] == card[0][tag][0], f"15a {tag} rank losses differ")
        check(ref_l[-1] < ref_l[0], f"15a {tag} loss not falling {ref_l}")
    # 15b: MoE blocks card == CPU, rank by rank
    for tag in ("ep", "ep2d"):
        gap = max(_moe_close(np, card[r][tag], cpu[r][tag]) for r in range(4))
        check(gap <= MESH_MOE_TOL, f"15b {tag} card vs CPU gap {gap}")
        res[f"15b_{tag}_card_vs_cpu"] = gap
    # 15c: compression and elastic
    for r in comp:
        check(r["same"] < 2e-2 and r["distinct"] < 2e-2, f"15c compression {r}")
    res["15c_compression_rel_err"] = {k: comp[0][k] for k in ("same", "distinct")}
    # 15f: several global chunks with drops, the ranks against one rank's
    # moe_forward at the reference's grouping
    check(drops["dp"] > 0 and drops["ep"] > 0, f"15f: nothing dropped {drops}")
    f = dict(drops=drops, chunks=dict(dp=MOE_CHUNKS["B"] * MOE_CHUNKS["S"]
                                      // MOE_CHUNKS["dp_chunk"],
                                      ep=MOE_CHUNKS["B"] * MOE_CHUNKS["S"]
                                      // MOE_CHUNKS["ep_chunk"]), tol=MOE_CHUNK_TOL)
    for job, outs in (("dp", [r["moe_dp"] for r in comp]),
                      ("ep", [r["moe_ep"] for r in card])):
        f[f"{job}_y_gap"] = max(o["y_gap"] for o in outs)
        f[f"{job}_aux_rel"] = max(o["aux_rel"] for o in outs)
        f[f"{job}_wall_ms"] = max(o["wall_ms"] for o in outs)
        f[f"{job}_job_s"] = max(o["job_s"] for o in outs)
        check(all(o["ep"] == (job == "ep") for o in outs),
              f"15f {job}: routed EP {[o['ep'] for o in outs]}")
        check(f[f"{job}_y_gap"] <= MOE_CHUNK_TOL and f[f"{job}_aux_rel"] <= MOE_CHUNK_TOL,
              f"15f {job}: y gap {f[f'{job}_y_gap']}, aux {f[f'{job}_aux_rel']}")
    f["dp_old_grouping_y_gap"] = min(o["old_grouping_y_gap"] for o in
                                     (r["moe_dp"] for r in comp))
    # what 15f adds to the phase's wall: its one rank, then its jobs in the
    # ranks of two spawns that were there
    f["one_rank_s"] = moe_one_s
    f["added_s"] = moe_one_s + f["dp_job_s"] + f["ep_job_s"]
    check(f["dp_old_grouping_y_gap"] > MOE_CHUNK_TOL,
          f"15f: the old per-row grouping passes: {f['dp_old_grouping_y_gap']}")
    res["15f_moe_chunks"] = f
    # elastic: the (1, 2) mesh resumed from the (2, 2) checkpoint == one
    # rank resumed from it on the card
    resumed = tail[0]["resume"]
    ok, worst, share = _smoke_close(torch, np, resumed["params"], resumed["one_params"])
    res["15c_elastic"] = dict(first=card[0]["elastic"], step=resumed["step"],
                              loss=resumed["loss"], one_rank_loss=resumed["one_loss"],
                              param_worst=worst, param_share=share)
    check(all(np.isfinite(card[0]["elastic"])) and resumed["step"] == 1,
          f"15c elastic {res['15c_elastic']}")
    check(np.allclose(resumed["loss"], resumed["one_loss"], **MESH_LOSS_TOL),
          f"15c elastic resumed loss {resumed['loss']} vs one rank's "
          f"{resumed['one_loss']}")
    check(ok, f"15c elastic params vs one rank: worst {worst}, share {share}")
    check(resumed["loss"] == tail[1]["resume"]["loss"], "15c ranks differ")
    # 15d/e: the full-width runs against one rank
    for tag, ranks, ref in (("15d_yi9b", [r["yi9b"] for r in card], yi_one),
                            ("15e_moonshot", [t["moonshot"] for t in tail], moon_one)):
        loss_gap = max(abs(r["first_loss"] - ref["first_loss"]) / abs(ref["first_loss"])
                       for r in ranks)
        routed = {k for k in ranks[0]["gaps"]
                  if k.rsplit("/", 1)[0] + "/router" in ranks[0]["gaps"]}
        dense = [(g[0], k) for r in ranks for k, g in r["gaps"].items()
                 if k not in routed]
        grad_gap, worst_leaf = max(dense)
        out = dict(first_loss=ranks[0]["first_loss"], one_rank_first_loss=ref["first_loss"],
                   loss_gap=loss_gap, grad_gap=grad_gap, worst_leaf=worst_leaf,
                   grad_norm_gap=max(g[1] for r in ranks for g in r["gaps"].values()),
                   losses=ranks[0]["losses"], one_rank_losses=ref["losses"],
                   step_wall_ms=ranks[0]["step_wall_ms"],
                   one_rank_step_wall_ms=ref["step_wall_ms"],
                   allreduce_per_step=ranks[0]["traffic"][-1],
                   param_bytes_ratio=ranks[0]["param_bytes"] / ref["param_bytes"],
                   opt_bytes_ratio=ranks[0]["opt_bytes"] / ref["opt_bytes"],
                   bytes_by_kind=_bytes_by_kind(ranks[0]["leaf_bytes"], ref["leaf_bytes"]),
                   peak_gb=max(r["peak_gb"] for r in ranks))
        if routed:
            # routing flips where bf16 rounding moves a near tie: each moves
            # a token's whole contribution, so these are held in norm
            out["routed"] = {k: max(r["gaps"][k] for r in ranks) for k in sorted(routed)}
            out["routed_norm_gap"] = max(v[1] for v in out["routed"].values())
            moves = [r["route_moves"] for r in ranks]
            out["route_moves"] = dict(tokens=max(m[0] for m in moves),
                                      assignments=max(m[1] for m in moves),
                                      of=moves[0][2])
            out["moe_out_gap"] = max(r["moe_out_gap"] for r in ranks)
            check(out["routed_norm_gap"] <= MESH_ROUTED_GRAD_TOL,
                  f"{tag} routed experts' gradient norm gap {out['routed_norm_gap']}")
            check(out["moe_out_gap"] <= MESH_MOE_OUT_TOL,
                  f"{tag} routed experts' output norm gap {out['moe_out_gap']}")
        # each mutant must be refused by the limit it is held to
        out["mutants"] = {}
        for name, held in MESH_MUTANTS[tag].items():
            if held == "loss":
                gap = max(abs(r["mutants"][name] - ref["first_loss"])
                          / abs(ref["first_loss"]) for r in ranks)
                refused = gap > MESH_FULL_LOSS_TOL
            elif held == "moe_out":
                gap = max(r["mutants"][name] for r in ranks)
                refused = gap > MESH_MOE_OUT_TOL
            elif held == "grads":
                gap = max(g[0] for r in ranks for k, g in r["mutants"][name].items()
                          if k not in routed)
                refused = gap > MESH_FULL_GRAD_TOL
            else:
                gap = max(r["mutants"][name][k][1] for r in ranks for k in routed)
                refused = gap > MESH_ROUTED_GRAD_TOL
            out["mutants"][name] = dict(held_to=held, gap=gap)
            check(refused, f"{tag} the {name} mutant passes its {held} limit: {gap}")
        res[tag] = out
        check(loss_gap <= MESH_FULL_LOSS_TOL, f"{tag} first loss gap {loss_gap}")
        check(grad_gap <= MESH_FULL_GRAD_TOL, f"{tag} gradient gap {grad_gap} "
              f"({worst_leaf})")
        check(all(np.isfinite(ranks[0]["losses"])) and
              ranks[0]["losses"][-1] < ranks[0]["losses"][0],
              f"{tag} losses {ranks[0]['losses']}: not finite or not falling")
        for r in ranks:
            check(r["losses"] == ranks[0]["losses"], f"{tag} rank losses differ")
    ek = res["15e_moonshot"]["bytes_by_kind"].get("experts")
    check(ek is not None and abs(ek - 0.5) < 1e-6, f"15e expert bytes per rank {ek}")
    check(sum(counts.values()) == 0, f"15 training launched {counts}")
    return counts, res


# ---------------------------------------------------------------------------
# phase 16: the dry-run on the production meshes, and Yi-9B's serving
# cells run for real at (1, 1) and (2, 2)
# ---------------------------------------------------------------------------

#: (pods, arch, shape) of the dry-run cells whose error is the port's own
#: refusal naming ROADMAP: none is left (DeepSeek-V3's experts over
#: (data, model) without a group limit step ``ok``)
DRYRUN_NOT_PORTED: frozenset = frozenset()
#: 16a's sequence-parallel cells at one pod: the train and prefill cells
#: of these archs (the whole ``--all --seq-parallel`` sweep runs on the
#: CPU, ``PERF.md``)
DRYRUN_SP_ARCHS = ("yi-9b", "mamba2-1.3b", "recurrentgemma-9b", "deepseek-v3-671b")
DRYRUN_SP_SHAPES = ("train_4k", "prefill_32k")
#: the group limit of the 2-D EP tests (``tests/test_torch_train_mesh.py``);
#: DeepSeek-V3's cells with it
#: must be ``ok``
DRYRUN_GROUP_LIMIT = 1
#: cells stepped at once by each ``--all`` run
DRYRUN_JOBS = 3
#: host cores the dry-runs run on from the build to the end of phase 17
#: (the last of the script's own; the measured phases, their spawned
#: ranks included, keep the others, so the dry-runs take no core from
#: them); 16a then lets what is left of them use every core
DRYRUN_CORES = 2
#: seconds 16a waits, after phase 17, for the dry-runs still stepping
DRYRUN_TIMEOUT_S = 420
#: what every ``ok`` record of 16a holds beside the analytic roofline: the
#: step counted on ``meta`` (``collectives.count_ops``)
DRYRUN_FIELDS = (("counted", "flops_per_chip"), ("counted", "bytes_accessed_per_chip"),
                 ("flops_counted_over_analytic",),
                 ("memory", "argument_size_in_bytes"), ("memory", "output_size_in_bytes"),
                 ("memory", "alias_size_in_bytes"), ("memory", "temp_size_in_bytes"),
                 ("memory", "peak_bytes"), ("memory", "fits_card"))

#: 16b / 16c: Yi-9B, bf16, GRIFFIN 0.5, random weights from seed 0;
#: (shape name, seq, batch): prefill cut from 32 x 32,768 (the eager
#: chunked attention, ROADMAP item 13), decode from 128 sequences
CELL_PREFILL = ("prefill_32k", 4096, 2)
CELL_DECODE = ("decode_32k", 32768, 4)
#: 16b / 16c (and 17d / 17e, which reuse the cells): 24 of Yi-9B's 48
#: layers, for the script's time (16c's four gloo ranks on one card pay
#: every layer's collectives)
CELL_LAYERS = 24
#: the decode cache's keys are drawn at 8x the unit scale and its values
#: at 4x: scores spread ~8 wide make each head attend to a few of the
#: 32,768 keys, as a trained model's do (at unit scale every head
#: averages the whole cache to ~0), and the values make attention carry
#: the residual stream.  At keys and values x1 a merge without rescaling
#: moved the logits by 7% of their largest, at both x4 the unsummed
#: partial scores by 9.6% (on an H100, ``PERF.md`` §6), inside ``TP_LOGIT_TOL``:
#: half-width scores over flat softmaxes shrink the context more than
#: they turn it
CELL_KEY_SCALE = 8.0
CELL_VALUE_SCALE = 4.0
CELL_REPS = 5
#: 16b: the cell is ``GenerationEngine``'s path on the same weights, cache
#: and inputs: logits within this share of the largest |logit|
CELL_ENGINE_TOL = 1e-3
#: 16c: the ranks' eq. 7 statistic (s-bar) within ``TP_STAT_TOL`` of
#: 16b's largest value, and an expert the ranks select and 16b does not
#: (or the reverse) a near-tie: 16b's s-bar within ``CELL_TIE_GAPS`` times
#: the two statistics' largest gap in its shard of the shard's boundary
#: (each of the two values may move by that gap; the ranks' bf16 partial
#: sums move s-bar ~0.5% over 48 layers on an H100, ``PERF.md`` §6)
CELL_TIE_GAPS = 2.0
#: 16c's mutants, each of which must move the logits past TP_LOGIT_TOL:
#: the log-sum-exp merge without rescaling (each rank's locally
#: normalized context summed), and the head_dim partial scores unsummed
CELL_MUTANTS = ("lse_no_rescale", "head_dim_unsummed")


def split_cores():
    """(the measured phases' cores, the dry-runs' cores): the script's
    own cores less the last ``DRYRUN_CORES`` of them, and those (all of
    them for both on a host with too few to split)."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 3 * DRYRUN_CORES:
        return cores, cores
    return cores[:-DRYRUN_CORES], cores[-DRYRUN_CORES:]


def start_dryrun(out: Path, cores):
    """16a's dry-run subprocesses, started after the build on the host
    ``cores`` that the measured phases do not use (``split_cores``), so
    that they step beside phases 2-17 without taking their cores:
    ``--all`` at one and two pods, DeepSeek-V3 with the group limit at
    both, and ``--seq-parallel`` over ``DRYRUN_SP_ARCHS`` x
    ``DRYRUN_SP_SHAPES`` at one pod.  Returns ``{name: (process, log
    path)}``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONWARNINGS="ignore", OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    runs = {}
    for pods in (1, 2):
        runs[f"all_p{pods}"] = base + ["--all", "--pods", str(pods), "--jobs",
                                       str(DRYRUN_JOBS), "--out", str(out / "all")]
        runs[f"gl_p{pods}"] = base + [
            "--arch", "deepseek-v3-671b", "--pods", str(pods),
            "--moe-group-limit", str(DRYRUN_GROUP_LIMIT),
            "--tag", f"gl{DRYRUN_GROUP_LIMIT}", "--out", str(out / "gl")]
    runs["sp_p1"] = base + ["--arch", *DRYRUN_SP_ARCHS, "--shape", *DRYRUN_SP_SHAPES,
                            "--seq-parallel", "--pods", "1", "--jobs", "2",
                            "--out", str(out / "sp")]
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, cmd in runs.items():
        log = out / f"{name}.log"
        with open(log, "w") as f:
            procs[name] = (subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                            env=env, cwd=str(ROOT),
                                            start_new_session=True,
                                            preexec_fn=lambda: os.sched_setaffinity(
                                                0, cores)), log)
    return procs


def widen_dryrun(procs, cores) -> None:
    """Every thread of what is left of the dry-runs (their cell workers
    too, found through ``/proc``) may run on ``cores``."""
    kids: dict = {}
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            ppid = int((d / "stat").read_text().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        kids.setdefault(ppid, []).append(int(d.name))
    todo = [p.pid for p, _ in procs.values() if p.poll() is None]
    while todo:
        pid = todo.pop()
        todo += kids.get(pid, [])
        try:
            tids = [int(t.name) for t in Path(f"/proc/{pid}/task").iterdir()]
        except OSError:
            continue
        for tid in tids:
            try:
                os.sched_setaffinity(tid, cores)
            except OSError:
                pass


def stop_dryrun(procs) -> None:
    """Kill what is left of the dry-runs (each runs in a session of its
    own, its cell workers with it) and remove their files."""
    import shutil
    import signal

    for p, log in procs.values():
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            p.wait()
        out = log.parent
    if procs:
        shutil.rmtree(out, ignore_errors=True)


def phase_dryrun(procs, out: Path, t_start: float):
    """16a: wait for the dry-runs, hold every record: ``ok`` or skipped,
    an error only on ``DRYRUN_NOT_PORTED`` (naming ROADMAP), and
    DeepSeek-V3's group-limited cells ``ok``.  One line per cell."""
    deadline = t_start + DRYRUN_TIMEOUT_S  # t_start: when 16a begins waiting
    for name, (p, log) in procs.items():
        try:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            tail = log.read_text()[-2000:]
            stop_dryrun(procs)
            raise AssertionError(f"16a: the dry-run {name} outlived "
                                 f"{DRYRUN_TIMEOUT_S} s: {tail}")
    lines, counts = [], {"ok": 0, "skipped": 0, "not_ported": 0}
    for sub in ("all", "gl", "sp"):
        for f in sorted((out / sub).glob("*.json")):
            r = json.loads(f.read_text())
            key = (r["pods"], r["arch"], r["shape"])
            st = r["status"]
            if st == "error":
                check(sub == "all" and key in DRYRUN_NOT_PORTED
                      and "ROADMAP" in r["error"],
                      f"16a: {f.name} failed: {r['error'][:500]}")
                counts["not_ported"] += 1
                lines.append(f"[not ported] {f.stem}: {r['error'][:160]}")
                continue
            counts[st] += 1
            if st == "skipped":
                continue
            missing = [".".join(k) for k in DRYRUN_FIELDS
                       if k[-1] not in (r[k[0]] if len(k) > 1 else r)]
            check(not missing, f"16a: {f.stem} lacks {missing}")
            ro, mem = r["roofline"], r["memory"]
            lines.append(
                f"[ok] {f.stem}: bytes/rank {mem['input_bytes_per_device']:.4e}"
                f" counted/analytic flops {r['flops_counted_over_analytic']:.4f}"
                f" predicted peak {mem['peak_bytes'] / 1e9:.3f} GB"
                f" (fits {mem['fits_card']})"
                f" dominant {ro['dominant']} bound {ro['bound_s']:.4e} s"
                f" (compute {ro['compute_s']:.3e} memory {ro['memory_s']:.3e}"
                f" collective {ro['collective_s']:.3e}) coll "
                f"{r['collectives']['bytes_total']:.4e} B step {r['step_s']} s")
    want = 64 + 6 + len(DRYRUN_SP_ARCHS) * len(DRYRUN_SP_SHAPES)
    check(counts["ok"] + counts["not_ported"] == want,
          f"16a: {counts} (want 64 supported cells, DeepSeek-V3's 6 with the "
          f"group limit and the {want - 70} sequence-parallel ones)")
    for name, (p, log) in procs.items():
        want = 1 if name.startswith("all") and DRYRUN_NOT_PORTED else 0
        check(p.returncode == want, f"16a: {name} exited {p.returncode}")
    return counts, lines


def cell_setup(smoke: bool = False):
    """(cfg, prefill shape, decode shape, prefill policy, decode policy,
    head_dim-split decode policy) of 16b/16c; ``smoke``: Yi-9B's smoke
    config at 2 x 16 and 4 x 32 (a rehearsal on the CPU)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.policies import CellPolicy, policy_for

    cfg = get_config("yi-9b", smoke=smoke)
    if not smoke:
        cfg = cfg.replace(num_layers=CELL_LAYERS)
    (_, sp, bp), (_, sd, bd) = ((None, 16, 2), (None, 32, 4)) if smoke else \
        (CELL_PREFILL, CELL_DECODE)
    pre = ShapeConfig(CELL_PREFILL[0], sp, bp, "prefill")
    dec = ShapeConfig(CELL_DECODE[0], sd, bd, "decode")
    pp, dp = policy_for(cfg, pre), policy_for(cfg, dec)
    # the cache's head_dim split over model: KV heads and kv_seq kept off it
    hp = CellPolicy(rules=dict(make_rules(phase="serve", head_dim_fallback=True),
                               kv_heads=None), griffin=dp.griffin)
    return cfg, pre, dec, pp, dp, hp


def scale_cache(cache) -> None:
    for layer in cache:
        layer["k"].mul_(CELL_KEY_SCALE)
        layer["v"].mul_(CELL_VALUE_SCALE)


def timed_ms(torch, fn, cuda: bool = True) -> float:
    """Wall of one call of ``fn``: CUDA events around it, started on an
    idle card, so host dispatch gaps count (the host clock off the
    card)."""
    if not cuda:
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e)


def wall_ms(torch, fn, reps: int, cuda: bool = True):
    """Median ``timed_ms`` of ``reps`` calls after a warm-up, and the
    times."""
    fn()
    ts = [timed_ms(torch, fn, cuda) for _ in range(reps)]
    return statistics.median(ts), ts


def busy_peak(torch, fn, cuda: bool, clear=None):
    """Device busy ms of one call of ``fn`` (``torch.profiler``), the peak
    GB allocated during another and the GB allocated just before it (0
    off the card).  ``clear`` drops what the earlier calls left (their
    outputs) before that, so that the peak over what was allocated
    before is the call's own."""
    if not cuda:
        fn()
        return 0.0, 0.0, 0.0
    busy = sum(e.time_range.elapsed_us() / 1e3
               for e in fenced_device_events(torch, fn, 8))
    if clear is not None:
        clear()
    free(torch)
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 1e9
    fn()
    torch.cuda.synchronize()
    return busy, torch.cuda.max_memory_allocated() / 1e9, resident


#: 16b: the peak the dry-run's count predicts (arguments + temp, on
#: ``meta``) within this share of ``max_memory_allocated``, and its temp
#: within this share of the call's own (the peak over what was allocated
#: before it) ...
CELL_PEAK_TOL = 0.10
#: ... plus this many GB: cuBLAS's and cuBLASLt's workspaces (32 MiB each
#: on Hopper), which the caching allocator holds from a first product on
CELL_TEMP_FLOOR_GB = 0.064


def counted_on_card(cell, args, meta, cuda: bool):
    """16b: the cell's real call counted (its forward, after the timed
    and measured calls): on the card its FLOPs are the ``meta`` count's
    less what the kernels' plain versions did there (the kernels run
    instead), off it the ``meta`` count's.  Returns (count, seconds)."""
    from repro_torch.analysis import collectives

    t0 = time.perf_counter()
    count = collectives.count_ops(cell.fn, *args)
    plain = sum(v["flops"] for v in meta.cost["plain_versions"].values()) \
        if cuda else 0
    check(count.cost["flops"] == meta.cost["flops"] - plain,
          f"16b {cell.name}: the card's call counted {count.cost['flops']} "
          f"FLOPs, meta {meta.cost['flops']} less {plain} in "
          f"{sorted(meta.cost['plain_versions'])}")
    return count, time.perf_counter() - t0


def check_peak(name: str, res: dict, cuda: bool) -> None:
    """16b: the predicted peak within ``CELL_PEAK_TOL`` of the card's, and
    the predicted temp within ``CELL_PEAK_TOL`` of the call's own plus
    ``CELL_TEMP_FLOOR_GB`` (the arguments, known before the count, are
    most of a decode cell's peak)."""
    if cuda:
        gap = abs(res["predicted_peak_gb"] - res["peak_gb"]) / res["peak_gb"]
        check(gap <= CELL_PEAK_TOL,
              f"16b {name}: predicted peak {res['predicted_peak_gb']} GB vs "
              f"{res['peak_gb']} GB allocated ({res['resident_gb']} GB before)")
        pred, got = res["predicted_temp_gb"], res["temp_gb"]
        check(abs(pred - got) <= CELL_PEAK_TOL * pred + CELL_TEMP_FLOOR_GB,
              f"16b {name}: predicted temp {pred} GB vs {got} GB allocated "
              f"over the {res['resident_gb']} GB before the call")


@contextlib.contextmanager
def cell_mutant(name: str):
    """``CELL_MUTANTS``: one step of the serving mesh's attention broken.
    ``lse_no_rescale`` sums the ranks' locally normalized contexts (no
    shared maximum, no shared sum); ``head_dim_unsummed`` softmaxes each
    rank's partial q.k."""
    import torch

    from repro_torch.distributed import sharding as shlib
    from repro_torch.models.layers import attention

    if name == "lse_no_rescale":
        attr = "split_softmax_ctx"

        def broken(scores, valid, v, seq_axes, pv):
            s = scores.masked_fill(~valid, attention.NEG_INF)
            p = torch.softmax(s, dim=-1).to(v.dtype)
            return shlib.psum(torch.einsum(pv, p, v), seq_axes)
    else:
        attr = "sum_scores"

        def broken(s, axes):
            return s
    real = getattr(attention, attr)
    setattr(attention, attr, broken)
    try:
        yield
    finally:
        setattr(attention, attr, real)


def cell_numbers(torch, cfg, shape, sp: float, ms: float, busy_ms: float,
                 peak_gb: float, input_gb: float, count, resident_gb: float):
    """The analytic bound of a cell on one card and the measured wall
    beside it; the step counted on ``meta`` (``count``): its FLOPs and
    its predicted peak (arguments + temp) beside the measured peak and
    what was allocated on the card before the call (``resident_gb``)."""
    from repro_torch.analysis import analytic, roofline

    c = analytic.cell_cost(cfg, shape, griffin_sparsity=sp)
    mf = roofline.model_flops(cfg, shape)
    r = roofline.from_costs(c.flops, c.hbm_bytes, 0.0, model_flops_total=mf,
                            chips=1, dtype=cfg.dtype)
    pred = count.memory["peak_bytes"] / 1e9
    return dict(wall_ms=round(ms, 3), busy_ms=round(busy_ms, 3),
                busy_share=round(busy_ms / ms, 4), peak_gb=round(peak_gb, 3),
                predicted_peak_gb=round(pred, 3),
                predicted_over_peak=round(pred / peak_gb, 4) if peak_gb else None,
                resident_gb=round(resident_gb, 3),
                temp_gb=round(peak_gb - resident_gb, 3),
                predicted_temp_gb=round(count.memory["temp_size_in_bytes"] / 1e9, 3),
                counted_flops=count.cost["flops"],
                flops_counted_over_analytic=count.cost["flops"] / c.flops,
                dryrun_input_gb=round(input_gb, 3),
                analytic_flops=c.flops, analytic_bytes=c.hbm_bytes,
                bound_ms=round(r.bound_s * 1e3, 3), bound_by=r.dominant,
                compute_ms=round(r.compute_s * 1e3, 3),
                memory_ms=round(r.memory_s * 1e3, 3), model_flops=mf,
                mfu=round(mf / (ms / 1e3 * r.peak_flops), 5),
                roofline_fraction=round(r.roofline_fraction, 5),
                wall_over_bound=round(ms / (r.bound_s * 1e3), 3))


def phase_cells_one(torch, np, dev, smoke: bool = False):
    """16b: Yi-9B's prefill and decode cells at (1, 1) on the card, built
    by ``cells.build_cell`` and ``materialize``: walls, busy share, peak
    memory beside the dry-run's input bytes and the peak its count on
    ``meta`` predicts (``CELL_PEAK_TOL``), the analytic bound and the
    model-FLOPs share; logits and selection == ``GenerationEngine``'s on
    the same weights, cache and inputs; the real call counted once
    (``counted_on_card``)."""
    from repro_torch.core import griffin as griffin_lib
    from repro_torch.launch import cells
    from repro_torch.launch.dryrun import step_cell
    from repro_torch.launch.mesh import TrainMesh
    from repro_torch.models import decoder
    from repro_torch.serving.engine import GenerationEngine

    cfg, pre, dec, pp, dp, _ = cell_setup(smoke)
    cuda = dev.type == "cuda"
    mesh = TrainMesh(dims=(1, 1), device=dev)
    res, ref = {}, {}
    cell = cells.build_cell(cfg, pre, mesh, pp)
    meta, _, res["prefill_meta_count_s"] = step_cell(cell)  # before materialize
    t0 = time.perf_counter()
    in_gb = cells.input_bytes(cell) / 1e9
    params, inputs = cells.materialize(cell, dev, seed=0)
    res["materialize_s"] = round(time.perf_counter() - t0, 2)
    out = {}

    def prefill():
        out.clear()  # a call's peak holds no earlier call's outputs
        out.update(cell.fn(params, inputs))

    # the path's launches: one run of each cell, counted alone
    reset_launches()
    prefill()
    counts = launches()
    ms, _ = wall_ms(torch, prefill, CELL_REPS, cuda)
    busy, peak, resident = busy_peak(torch, prefill, cuda, out.clear)
    res["prefill"] = cell_numbers(torch, cfg, pre, 0.0, ms, busy, peak, in_gb,
                                  meta, resident)
    check_peak("prefill", res["prefill"], cuda)
    count, res["prefill_card_count_s"] = counted_on_card(cell, (params, inputs), meta,
                                                         cuda)
    res["prefill"]["card_counted_peak_gb"] = round(count.memory["peak_bytes"] / 1e9, 3)
    res["prefill"]["plain_versions"] = sorted(meta.cost["plain_versions"])
    # the engine on the same weights and prompts
    eng = GenerationEngine(cfg, params, pp.griffin, q_chunk=pp.q_chunk, device=dev)
    lg, aux = eng.prefill(inputs["tokens"])
    stats = decoder.prune_stats_tree(aux.stats, cfg)
    idx = {}
    pruned_e, _ = griffin_lib.select_and_compact(
        stats, decoder.extract_ffn_tree(params, cfg), pp.griffin,
        on_select=lambda li, i: idx.__setitem__(li, i))
    scale = float(lg.abs().max())
    gap = float((out["last_logits"] - lg).abs().max())
    check(gap <= CELL_ENGINE_TOL * scale, f"16b prefill logits {gap} vs engine "
          f"(max |logit| {scale})")
    check(all(torch.equal(out["experts"][li], idx[li]) for li in idx),
          "16b: the cell's selection differs from the engine's")
    check(all(torch.equal(out["pruned"][li]["w1"], pruned_e[li]["w1"]) for li in idx),
          "16b: the cell's compacted FF differs from the engine's")
    res["prefill"]["engine_gap"] = gap
    res["prefill"]["max_logit"] = scale
    ref["prefill_logits"] = out["last_logits"].float().cpu().numpy()
    ref["experts"] = {li: v.cpu().numpy() for li, v in idx.items()}
    ref["sbar"] = {li: v.float().cpu().numpy() for li, v in out["scores"].items()}
    pruned = out["pruned"]
    del aux, stats, pruned_e, out, lg
    if cuda:
        free(torch)
    # decode on the prefill's compacted FF over a random 32,768-token cache
    dcell = cells.build_cell(cfg, dec, mesh, dp)
    in_gb = cells.input_bytes(dcell) / 1e9
    meta, _, res["decode_meta_count_s"] = step_cell(dcell)
    _, cache, _, token, pos = cells.materialize(dcell, dev, seed=0, params=params,
                                                pruned=pruned)
    scale_cache(cache)
    dout = {}

    def decode():
        dout.clear()
        dout["logits"], _ = dcell.fn(params, cache, pruned, token, pos)

    reset_launches()
    decode()
    for name, n in launches().items():
        counts[name] = counts.get(name, 0) + n
    ms, _ = wall_ms(torch, decode, CELL_REPS, cuda)
    busy, peak, resident = busy_peak(torch, decode, cuda, dout.clear)
    res["decode"] = cell_numbers(torch, cfg, dec, dp.griffin.sparsity, ms, busy,
                                 peak, in_gb, meta, resident)
    check_peak("decode", res["decode"], cuda)
    count, res["decode_card_count_s"] = counted_on_card(
        dcell, (params, cache, pruned, token, pos), meta, cuda)
    res["decode"]["card_counted_peak_gb"] = round(count.memory["peak_bytes"] / 1e9, 3)
    lg, _ = eng.decode(cache, pruned, token, pos)
    scale = float(lg.abs().max())
    gap = float((dout["logits"] - lg).abs().max())
    check(gap <= CELL_ENGINE_TOL * scale, f"16b decode logits {gap} vs engine "
          f"(max |logit| {scale})")
    res["decode"]["engine_gap"] = gap
    res["decode"]["max_logit"] = scale
    ref["decode_logits"] = dout["logits"].float().cpu().numpy()
    check(counts.get("expert_stat", 0) > 0 or not cuda, f"16b launched {counts}")
    del params, cache, pruned, dout, lg, eng
    if cuda:
        free(torch)
    return counts, res, ref


def dry_cell_records(rank: int, smoke: bool = False):
    """The dry mesh's record of 16c's three cells for ``rank`` of (2, 2)
    (a spawned process: shapes on ``meta``)."""
    import warnings

    warnings.simplefilter("ignore")
    from repro_torch.analysis import collectives
    from repro_torch.launch import cells
    from repro_torch.launch.dryrun import step_cell
    from repro_torch.launch.mesh import dry_train_mesh

    cfg, pre, dec, pp, dp, hp = cell_setup(smoke)
    mesh = dry_train_mesh((2, 2), ("data", "model"), rank)
    return {tag: collectives.summary(step_cell(cells.build_cell(cfg, shape, mesh, pol))[1])
            for tag, shape, pol in (("prefill", pre, pp), ("kv_seq", dec, dp),
                                    ("head_dim", dec, hp))}


def cells_rank(mesh, experts, smoke: bool = False):
    """One rank of 16c (a spawned process): the prefill cell, then the
    decode cells (``kv_seq`` split, then ``head_dim`` split) on this
    rank's blocks of 16b's compacted FF (``experts``: 16b's selection),
    each with its mutant run after it; ``launches`` counts the kernel
    launches of one run of each cell (``module.attr``), not those of the
    timed and mutant runs."""
    import torch

    from repro_torch.analysis import collectives
    from repro_torch.core import griffin as griffin_lib
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import launch_counts
    from repro_torch.models import decoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, pre, dec, pp, dp, hp = cell_setup(smoke)
    dev = mesh.device
    cuda = dev.type == "cuda"
    out = {"launches": {}}

    def counted(fn):
        """One run of the path, its kernel launches counted (the timed
        and mutant runs are not)."""
        before = launch_counts()
        r = fn()
        for k, v in launch_counts().items():
            out["launches"][k] = out["launches"].get(k, 0) + v - before.get(k, 0)
        return r

    cell = cells.build_cell(cfg, pre, mesh, pp)
    params, inputs = cells.materialize(cell, dev, seed=0)
    shlib.reset_records()
    # the walls are the counted runs' (their first calls): a second run of
    # each cell would cost the script ~10 s on a slow host
    res = {}
    out["prefill_ms"] = timed_ms(
        torch, lambda: res.update(counted(lambda: cell.fn(params, inputs))), cuda)
    out["prefill_records"] = collectives.summary(shlib.RECORDS)
    out["prefill_logits"] = res["last_logits"].float().cpu().numpy()
    out["experts"] = {li: v.cpu().numpy() for li, v in res["experts"].items()}
    out["scores"] = {li: v.float().cpu().numpy() for li, v in res["scores"].items()}
    del res
    ffn = decoder.extract_ffn_tree(params, cfg)
    c, n = mesh.coord("model"), mesh.extent("model")
    pruned = {li: griffin_lib.compact(ffn[li], griffin_lib.shard_indices(
        torch.as_tensor(experts[li]), cfg.d_ff, c, n)) for li in ffn}
    del ffn  # views of the weights, which the head_dim cell draws anew
    for tag, pol, mutant in (("kv_seq", dp, CELL_MUTANTS[0]),
                             ("head_dim", hp, CELL_MUTANTS[1])):
        dcell = cells.build_cell(cfg, dec, mesh, pol)
        if dcell.resolved[0] != cell.resolved[0]:  # other weight blocks
            del params
            params = None
            if cuda:
                torch.cuda.empty_cache()
        params, cache, _, token, pos = cells.materialize(
            dcell, dev, seed=0, params=params, pruned=pruned)
        cell = dcell
        scale_cache(cache)
        shlib.reset_records()
        box = []
        out[f"{tag}_ms"] = timed_ms(torch, lambda: box.append(
            counted(lambda: dcell.fn(params, cache, pruned, token, pos))), cuda)
        logits, _ = box.pop()
        out[f"{tag}_records"] = collectives.summary(shlib.RECORDS)
        out[f"{tag}_logits"] = logits.float().cpu().numpy()
        with cell_mutant(mutant):
            logits, _ = dcell.fn(params, cache, pruned, token, pos)
        out[f"{tag}_mutant_logits"] = logits.float().cpu().numpy()
        out[f"{tag}_cache_gb"] = sum(t.numel() * t.element_size()
                                     for layer in cache for t in layer.values()) / 1e9
        del cache, logits
        if cuda:
            torch.cuda.empty_cache()
    out["param_gb"] = cells.tree_bytes(params) / 1e9
    out["pruned_gb"] = cells.tree_bytes(pruned) / 1e9
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0
    return out


def assemble(np, blocks, ranks, data_dim: int, vocab_dim: int):
    """A global array from the (2, 2) ranks' (rows, vocabulary) blocks."""
    rows = []
    for d in (0, 1):
        row = [blocks[r] for r in ranks if r // 2 == d]
        rows.append(np.concatenate(row, axis=vocab_dim))
    return np.concatenate(rows, axis=data_dim)


def phase_cells_mesh(torch, np, ref, dev, smoke: bool = False):
    """16c: the same cells at (2, 2), four gloo ranks on the one card:
    logits within ``TP_LOGIT_TOL`` of 16b's, the selection 16b's up to
    near-ties (``CELL_TIE_GAPS``), each rank's recorded collectives equal
    to the dry mesh's for that rank, both mutants refused."""
    from concurrent.futures import ProcessPoolExecutor
    import multiprocessing

    from repro_torch.launch.mesh import run_ranks

    cfg = cell_setup(smoke)[0]
    res = {}
    if dev.type == "cuda":
        free(torch)  # 16b's weights, cache and compacted FF, held in the cache
    t0 = time.perf_counter()
    with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn")) as ex:
        dry = [ex.submit(dry_cell_records, r, smoke) for r in range(4)]
        ranks, _ = run_ranks(cells_rank, 4, backend="gloo", shape=(2, 2),
                                  axes=("data", "model"), device=dev.type,
                                  args=(ref["experts"], smoke), timeout_s=900)
        dry = [f.result() for f in dry]
    res["ranks_s"] = round(time.perf_counter() - t0, 1)
    for r in range(4):
        for tag in ("prefill", "kv_seq", "head_dim"):
            check(ranks[r][f"{tag}_records"] == dry[r][tag],
                  f"16c rank {r} {tag} collectives {ranks[r][f'{tag}_records']} "
                  f"!= the dry-run's {dry[r][tag]}")
    res["records_rank0"] = {t: ranks[0][f"{t}_records"]
                            for t in ("prefill", "kv_seq", "head_dim")}
    checks = []  # every reading is taken before the first check fails
    lg = assemble(np, [x["prefill_logits"] for x in ranks], range(4), 0, 1)
    scale = float(np.abs(ref["prefill_logits"]).max())
    gap = float(np.abs(lg - ref["prefill_logits"]).max())
    checks.append((gap <= TP_LOGIT_TOL * scale, f"16c prefill logits {gap} vs "
                   f"16b ({scale})"))
    res["prefill_gap_share"] = gap / scale
    # the selection: each data row's two model ranks together select 16b's
    # experts, up to near-ties of the statistic within their shard
    flips, worst, stat_gap = 0, 0.0, 0.0
    F, sh = cfg.d_ff, 16
    w = F // sh
    for li, want in ref["experts"].items():
        sbar = ref["sbar"][li]
        k_sh = len(want) // sh
        for d in (0, 1):
            rows = [r for r in range(4) if r // 2 == d]
            mine = np.concatenate([ranks[r]["scores"][li] for r in rows])
            stat_gap = max(stat_gap, float(np.abs(mine - sbar).max()
                                           / np.abs(sbar).max()))
            got = np.sort(np.concatenate([ranks[r]["experts"][li] for r in rows]))
            diff = np.setxor1d(got, want)
            flips += len(diff) // 2
            for j in diff:
                b = j // w
                block = np.sort(sbar[b * w:(b + 1) * w])[::-1]
                t = 0.5 * (block[k_sh - 1] + block[k_sh])
                gap = float(np.abs(mine[b * w:(b + 1) * w] - sbar[b * w:(b + 1) * w]).max())
                worst = max(worst, abs(float(sbar[j]) - t) / max(CELL_TIE_GAPS * gap, 1e-30))
    checks.append((stat_gap <= TP_STAT_TOL, f"16c: s-bar {stat_gap:.3g} of its "
                   f"largest value from 16b's"))
    checks.append((worst <= 1.0, f"16c: a selection differs beyond a near-tie "
                   f"({worst:.3g} of {CELL_TIE_GAPS} x the statistic's gap, "
                   f"{flips} swaps)"))
    res["stat_gap_share"] = stat_gap
    res["selection_swaps"] = flips
    res["selection_worst_tie_over_gap"] = worst
    scale = float(np.abs(ref["decode_logits"]).max())
    for tag, mutant in (("kv_seq", CELL_MUTANTS[0]), ("head_dim", CELL_MUTANTS[1])):
        lg = assemble(np, [x[f"{tag}_logits"] for x in ranks], range(4), 0, 2)
        gap = float(np.abs(lg - ref["decode_logits"]).max())
        checks.append((gap <= TP_LOGIT_TOL * scale, f"16c {tag} decode logits "
                       f"{gap} vs 16b ({scale})"))
        mg = float(np.abs(assemble(np, [x[f"{tag}_mutant_logits"] for x in ranks],
                                   range(4), 0, 2) - ref["decode_logits"]).max())
        checks.append((mg > TP_LOGIT_TOL * scale, f"16c mutant {mutant} passed: "
                       f"{mg} vs 16b ({scale})"))
        res[f"{tag}_gap_share"] = gap / scale
        res[f"{tag}_mutant_{mutant}_gap_share"] = mg / scale
        res[f"{tag}_ms_rank0"] = round(ranks[0][f"{tag}_ms"], 3)
        res[f"{tag}_cache_gb_rank"] = round(ranks[0][f"{tag}_cache_gb"], 3)
    res["prefill_ms_rank0"] = round(ranks[0]["prefill_ms"], 3)
    for k in ("param_gb", "pruned_gb", "peak_gb"):
        res[f"{k}_rank"] = [round(x[k], 3) for x in ranks]
    counts = {}  # the ranks' counted runs of the path
    for x in ranks:
        for k, v in x["launches"].items():
            counts[k] = counts.get(k, 0) + v
    c = tp_counts(counts)
    checks.append((dev.type != "cuda" or (c.get("expert_stat_row_sq", 0) > 0 and
                                          c.get("expert_stat_from_norm", 0) > 0),
                   f"16c launched {c}"))
    bad = [msg for ok, msg in checks if not ok]
    check(not bad, "; ".join(bad) + f" (readings: {res})")
    return c, res



# ---------------------------------------------------------------------------
# phase 17: the production mesh whole -- experts over (data, model) without
# a group limit, the SSM / RG-LRU mixers split over model, an int8 cache
# split over head_dim, sequence parallelism
# ---------------------------------------------------------------------------

#: 17a: the smoke setups (fp32, TF32 off) at (2, 2) and (1, 2) on the card
#: against one rank on the card (the same cells and step at (1, 1)) and
#: against the same ranks on the CPU
WHOLE_SMOKE_TOL = dict(rtol=1e-4, atol=1e-5)
#: 17a's train steps: each leaf's synced gradient blocks within this share
#: of the one-rank leaf's largest |g| (a leaf whose gradient is zero but
#: for rounding, as an attention key bias's: of ``WHOLE_ZERO_GRAD`` times
#: the tree's largest |g|)
WHOLE_GRAD_TOL = 1e-4
WHOLE_ZERO_GRAD = 1e-3
#: 17b: DeepSeek-V3 at full width, 4 layers (its 3 dense layers and one
#: MoE layer), no MTP, bf16, GRIFFIN 0.5, random weights from seed 0,
#: under ``policy_for``'s rules (experts over (data, model), no group
#: limit); (batch, seq) of the prefill cell (cut from 32 x 32,768) and of
#: the decode cell (cut from 128 sequences over 32,768); the expanded
#: attention's query chunk (``q_chunk``, the policy's 1,024 cut: four
#: ranks share the card)
WHOLE_DS = dict(layers=4, prefill=(2, 1024), decode=(4, 4096), q_chunk=256)
#: 17c: Mamba2-1.3B and RecurrentGemma-9B whole at (1, 2): (arch, dtype)
#: of each run.  RecurrentGemma bf16 (``TP_LOGIT_TOL``).  Mamba2 in fp32,
#: held to ``WHOLE_FP32_TOL`` (the split is the same computation), and in
#: its config's bf16, where the layout's rounding (the out-projection's
#: partial sums, each rounded to bf16 and added) grows through 48
#: recurrent layers: held against the fp32 (1, 1) cells, within
#: ``WHOLE_BF16_RATIO`` times the (1, 1) bf16 cells' own distance from
#: them (bf16's rounding at full size; the two bf16 layouts each round
#: their own way)
WHOLE_REC = dict(prefill=(2, 1024), decode=(4, 4096),
                 runs=(("mamba2-1.3b", "float32"), ("mamba2-1.3b", "bfloat16"),
                       ("recurrentgemma-9b", "bfloat16")))
#: 17c's fp32 cells against (1, 1): summation order alone (TF32 off)
WHOLE_FP32_TOL = 1e-3
WHOLE_BF16_RATIO = 2.0
#: 17d / 17e: Yi-9B's decode cell (16b's shape) with an int8 cache, and
#: its prefill cell (16b's) and 15d's train step under seq_parallel rules:
#: its first loss and gradients (the forward, backward and gradient sums
#: of the step), no optimizer step after them
WHOLE_YI_TRAIN = dict(MESH_YI, steps=0, seq_parallel=True)
#: 17b: a rank's peak memory while it draws its cell's inputs, above its
#: blocks: the largest leaf drawn whole (below ``param.SLICED_NUMEL``:
#: DeepSeek-V3's dense w1, fp32 and its bf16 cast, 0.8 GB) or one slice
WHOLE_INIT_SLACK_GB = 1.0
#: 17d: a block's scales against the whole head's (relative)
WHOLE_SCALE_TOL = 1e-5
#: the mutants: each must move its run past the limits it is held to
#: (17b: a dispatch of this data row's tokens only, a combine without the
#: sum over ``data``; 17c: the gated norm's mean square over this rank's
#: block; 17e: the blocks' partial sums cut without their reduce-scatter)
WHOLE_MUTANTS = {"17b": ("row_dispatch", "no_data_sum"), "17c": ("local_norm",),
                 "17e": ("no_reduce_scatter",)}


@contextlib.contextmanager
def whole_mutant(name: str):
    """One step of phase 17's paths broken (``WHOLE_MUTANTS``)."""
    import types

    from repro_torch.distributed import sharding as shlib
    from repro_torch.models.layers import ssm

    if name == "row_dispatch":
        real, target, attr = shlib.exchange_in, shlib, "exchange_in"
        broken = (lambda x, pos, n, owners, summers:
                  real(x, pos, n, (), summers))
    elif name == "no_data_sum":
        real, target, attr = shlib.exchange_out, shlib, "exchange_out"
        broken = (lambda y, pos, summers, owners: real(y, pos, (), owners))
    elif name == "local_norm":
        real, target, attr = ssm.shlib, ssm, "shlib"
        broken = types.SimpleNamespace(**vars(shlib))
        # sum x n / (n d_loc): the mean square of this rank's block alone
        broken.reduce = lambda x, axis="model": x * shlib.active_rules()[0].extent(axis)
    elif name == "no_reduce_scatter":
        real, target, attr = shlib._SeqScatter, shlib, "_SeqScatter"
        broken = types.SimpleNamespace(apply=lambda y, d: shlib.seq_cut(y, d))
    else:
        raise KeyError(name)
    setattr(target, attr, broken)
    try:
        yield
    finally:
        setattr(target, attr, real)


def whole_smoke_cfg(tag: str):
    from repro_torch.configs.registry import get_config

    if tag == "ds":  # capacity drops: 8 slots an expert
        return get_config("deepseek-v3-671b", smoke=True).replace(capacity_factor=0.5)
    if tag == "yi":
        return mesh_smoke_cfg("yi")
    if tag == "tiny8":
        return get_config("tinylm").replace(kv_cache_int8=True)
    return get_config(tag, smoke=True)


def whole_policy(cfg, shape, *, expert_2d=False, seq_parallel=False,
                 head_dim=False, griffin=True):
    """The cells' policy: ``policy_for``'s, or for a smoke config (whose
    name ``policy_for`` does not know) its rules spelled out."""
    from repro_torch.core.griffin import GriffinConfig
    from repro_torch.distributed.sharding import make_rules
    from repro_torch.launch.policies import CellPolicy, policy_for

    pol = policy_for(cfg, shape, seq_parallel=seq_parallel)
    rules = dict(pol.rules)
    if expert_2d:
        rules["experts"] = ("data", "model")
    if head_dim:  # the cache's head_dim over model, KV heads and kv_seq off it
        rules = dict(make_rules(phase="serve", head_dim_fallback=True,
                                seq_parallel=seq_parallel), kv_heads=None)
    g = pol.griffin
    if griffin and g is not None and cfg.name.endswith("-smoke"):
        g = GriffinConfig(sparsity=0.5, tp_shards=2)
    return CellPolicy(rules=rules, griffin=g if griffin else None)


def _moved(tree, dev):
    """A cell's arguments (tuples, dicts, lists, host ints) on ``dev``."""
    if isinstance(tree, tuple):
        return tuple(_moved(v, dev) for v in tree)
    if isinstance(tree, dict):
        return {k: _moved(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_moved(v, dev) for v in tree]
    return tree.to(dev) if hasattr(tree, "to") else tree


def whole_cell(torch, np, mesh, cfg, shape, pol, *, params=None, mutants=(),
               trace=False, record_quant=False, host_draw=False):
    """One cell of this rank (``cells.build_cell`` + ``materialize``):
    its output block (prefill: the last logits; decode: the logits) with
    its rows and vocabulary columns, the launches of one run, the init's
    wall, peak memory above what was held before and this rank's input
    bytes beside the dry-run's count for the cell; ``trace``: the routed
    experts' output (``_moe_trace``); each of ``mutants``' output (with
    ``trace``: the MoE blocks' alone, run again on their inputs).
    ``host_draw``: the inputs drawn on the CPU and copied (a card's
    generator draws other values, and 17a holds the card to the CPU)."""
    from repro_torch.distributed import sharding as shlib
    from repro_torch.launch import cells
    from repro_torch.launch.mesh import launch_counts

    dev = mesh.device
    on_card = dev.type == "cuda"
    cell = cells.build_cell(cfg, shape, mesh, pol)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    if host_draw:
        args = _moved(cells.materialize(cell, "cpu", seed=0,
                                        params=params), dev)
    else:
        args = cells.materialize(cell, dev, seed=0, params=params)
    init_s = time.perf_counter() - t0
    init_peak = (torch.cuda.max_memory_allocated() - held) / 1e9 if on_card else 0.0
    if on_card and mesh.size > 1:
        print(f"  [rank {mesh.rank}] {cell.name}: {cells.tree_bytes(args) / 1e9:.3f} "
              f"GB of inputs, {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
              f"init peak +{init_peak:.3f} GB", flush=True)
    res = dict(init_s=round(init_s, 2), init_peak_gb=round(init_peak, 3),
               block_gb=round(cells.tree_bytes(args) / 1e9, 3),
               dryrun_gb=round(cells.input_bytes(cell) / 1e9, 3))

    def run():
        out = cell.fn(*args)
        lg = out["last_logits"] if cell.kind == "prefill" else out[0][:, 0]
        return lg.float().cpu().numpy()

    quant = []
    if record_quant:  # the int8 write's inputs and outputs, per layer
        from repro_torch.models.layers import attention

        real_q = attention.quantize_kv

        def spy(x, axes=()):
            q, s = real_q(x, axes)
            quant.append((x.float().cpu().numpy(), q.cpu().numpy(),
                          s.cpu().numpy()))
            return q, s

        attention.quantize_kv = spy
    before = launch_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        calls = []
        if trace:
            with _moe_trace(keep_inputs=bool(mutants)) as got:
                res["out"] = run()
            res["moe_y"] = [y.numpy() for y in got["y"]]
            calls = got["calls"]
        else:
            res["out"] = run()
    finally:
        if record_quant:
            attention.quantize_kv = real_q
    # the counted run's wall (its first call: one run of each cell keeps
    # phase 17 inside the script's time; with ``trace`` it holds the routed
    # experts' second forward)
    res["wall_ms"] = round((time.perf_counter() - t0) * 1e3, 1)
    res["launches"] = {k: v - before.get(k, 0) for k, v in launch_counts().items()
                       if v - before.get(k, 0)}
    res["quant"] = quant
    if on_card:
        torch.cuda.synchronize()
        res["run_peak_gb"] = round(torch.cuda.max_memory_allocated() / 1e9, 3)
        torch.cuda.empty_cache()
        if mesh.size > 1:
            print(f"  [rank {mesh.rank}] {cell.name}: run peak {res['run_peak_gb']} GB",
                  flush=True)
    lg = res["out"]
    B_loc, V_loc = lg.shape[0], lg.shape[-1]
    axes = shlib.batch_axes(mesh, pol.rules)
    r = mesh.coord(axes) if axes else 0
    c = mesh.coord("model") if V_loc != cfg.vocab_size else 0
    res["rows"] = slice(r * B_loc, (r + 1) * B_loc)
    res["cols"] = slice(c * V_loc, (c + 1) * V_loc)
    for name in mutants:
        if on_card:
            torch.cuda.empty_cache()
        with whole_mutant(name):
            if trace:  # the MoE blocks alone, again on their inputs
                from repro_torch.models.layers import moe

                with shlib.axis_rules(mesh, pol.rules), torch.no_grad():
                    res[f"mutant_{name}_moe_y"] = [
                        moe.moe_forward(p, x, c, *a, **kw)[0].float().cpu().numpy()
                        for p, x, c, a, kw in calls]
            else:
                res[f"mutant_{name}"] = run()
    calls = None
    res["params"] = args[0] if cell.kind == "prefill" else None
    res["resolved"] = cell.resolved[0]
    return res


def whole_cells(torch, np, mesh, cfg, pre, dec, pre_pol, dec_pol, *,
                mutants=(), mutants_on=("prefill",), trace=False, host_draw=False):
    """A prefill then a decode cell of this rank (``whole_cell``), the
    decode on the prefill's weights where both resolve them alike, with
    ``mutants`` on the cells ``mutants_on`` names; the results without
    the weights."""
    from repro_torch.models import decoder

    a = whole_cell(torch, np, mesh, cfg, pre, pre_pol, trace=trace,
                   mutants=mutants if "prefill" in mutants_on else (),
                   host_draw=host_draw)
    params = a.pop("params")
    same = decoder.train_specs(cfg, mesh, dec_pol.rules) == a.pop("resolved")
    if host_draw and same:
        params = _moved(params, "cpu")
    b = whole_cell(torch, np, mesh, cfg, dec, dec_pol, params=params if same else None,
                   mutants=mutants if "decode" in mutants_on else (), trace=trace,
                   host_draw=host_draw)
    del params
    b.pop("resolved"), b.pop("params")
    return {"prefill": a, "decode": b}


def whole_launches(tree) -> dict:
    """The kernel launches of the counted runs in a rank's results (each
    cell's ``launches``: one run of it, not its timed or mutant runs)."""
    out: dict = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if k == "launches" and isinstance(v, dict):
                for name, n in v.items():
                    out[name] = out.get(name, 0) + n
            else:
                for name, n in whole_launches(v).items():
                    out[name] = out.get(name, 0) + n
    elif isinstance(tree, list):
        for v in tree:
            for name, n in whole_launches(v).items():
                out[name] = out.get(name, 0) + n
    return out


def whole_train(torch, np, mesh, cfg, rules, steps, tokens):
    """``steps`` AdamW steps (lr 1e-2) of this rank from the mesh's init
    (``TrainTP.init_train_state``: each rank draws its blocks, on the CPU;
    one rank: the plain step from ``init_train_state``): the losses, and
    the first step's gradients as the optimizer takes them (the mesh:
    this rank's blocks after ``TrainTP.sync_grads``, with their slices of
    the global leaves; one rank: the whole leaves)."""
    from repro_torch.distributed.tp import TrainTP
    from repro_torch.models import decoder
    from repro_torch.training import optimizer as opt_lib
    from repro_torch.training import train_step as ts

    opt = opt_lib.adamw(MESH_SMOKE_LR)
    # drawn on the CPU: the card's generator draws other values
    if mesh.size == 1:  # one rank: the plain step
        state = ts.init_train_state(cfg, opt, 0, "cpu")
        step = ts.build_train_step(cfg, opt)
    else:
        state = TrainTP(cfg, mesh, rules).init_train_state(opt, 0, "cpu")
        step = ts.build_train_step(cfg, opt, mesh=mesh, rules=rules)
    state = _moved(state, mesh.device)
    batch = {"tokens": torch.from_numpy(tokens).to(mesh.device)}
    got = {}
    if mesh.size == 1:
        _, _, g = ts.value_and_grad(decoder.loss_fn, state["params"], batch, cfg)
        got["grads"] = {k: (np.zeros(tuple(p.shape), np.float32) if v is None
                            else v.float().cpu().numpy())
                        for (k, v), p in zip(_paths(g).items(),
                                             _paths(state["params"]).values())}
    else:
        tp, real = step.tp, step.tp.sync_grads

        def sync(grads, seq_parallel=False):
            grads = real(grads, seq_parallel)
            if not got:
                shapes = _paths(tp.param_shapes)
                got["grads"] = {k: v.float().cpu().numpy()
                                for k, v in _paths(grads).items()}
                got["slices"] = {k: tp.slices(sp, shapes[k].shape)
                                 for k, sp in _paths(tp.param_specs).items()}
            return grads

        tp.sync_grads = sync
    out = []
    for _ in range(steps):
        state, m = step(state, batch)
        out.append(float(m["loss"]))
    return dict(losses=np.array(out), **got)


def _grads_gap(np, ranks, one):
    """The ranks' synced gradient blocks (``whole_train``) against one
    rank's whole leaves: the largest gap over the leaf's largest |g| (a
    leaf whose gradient is zero but for rounding: over ``WHOLE_ZERO_GRAD``
    of the tree's largest)."""
    want = one["grads"]
    top = max(float(np.abs(w).max()) for w in want.values())
    worst = 0.0
    for r in ranks:
        check(sorted(r["grads"]) == sorted(want), "17a: gradient trees differ")
        for k, w in want.items():
            blk = w[r["slices"][k]] if "slices" in r else w
            scale = max(float(np.abs(w).max()), WHOLE_ZERO_GRAD * top, 1e-30)
            worst = max(worst, float(np.abs(r["grads"][k] - blk).max()) / scale)
    return worst


def whole_smoke_jobs(torch, np, mesh, which: str):
    """17a's jobs of this rank (``which``: the (2, 2) set or the (1, 2)
    set); each a dict of numpy results."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.distributed.sharding import make_rules

    torch.backends.cuda.matmul.allow_tf32 = False
    tokens = np.random.default_rng(1).integers(0, 256, (4, 32)).astype(np.int64)
    pre, dec = ShapeConfig("p", 32, 4, "prefill"), ShapeConfig("d", 32, 4, "decode")
    out = {}
    if which == "22":
        ds = whole_smoke_cfg("ds")
        out["ds_train"] = whole_train(torch, np, mesh, ds, make_rules(
            phase="train", expert_2d=True), 1, tokens)
        out["ds_cells"] = whole_cells(torch, np, mesh, ds, pre, dec,
                                      whole_policy(ds, pre, expert_2d=True),
                                      whole_policy(ds, dec, expert_2d=True),
                                      host_draw=True)
        yi = whole_smoke_cfg("yi")
        out["sp_train"] = whole_train(torch, np, mesh, yi, make_rules(
            phase="train", fsdp=True, seq_parallel=True), 1, tokens)
        out["sp_prefill"] = whole_cell(torch, np, mesh, yi, pre, whole_policy(
            yi, pre, seq_parallel=True), host_draw=True)
        out["sp_prefill"].pop("params")
    else:
        for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
            cfg = whole_smoke_cfg(arch)
            out[arch] = whole_cells(torch, np, mesh, cfg, pre, dec,
                                    whole_policy(cfg, pre), whole_policy(cfg, dec),
                                    host_draw=True)
        t8 = whole_smoke_cfg("tiny8")
        out["int8"] = whole_cell(torch, np, mesh, t8, dec, whole_policy(
            t8, dec, head_dim=True), record_quant=True, host_draw=True)
        out["int8"].pop("params")
    return out


def whole_smoke_rank(mesh, which: str):
    import numpy as np
    import torch

    torch.set_num_threads(1)
    return whole_smoke_jobs(torch, np, mesh, which)


def whole_full_rank(mesh, jobs):
    """One rank of 17b-17e (a spawned process): each ``(job, spec)`` of
    ``jobs`` in turn, the card's cache emptied between them (one spawn
    a mesh shape); returns each job's results and its wall."""
    import numpy as np
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for job, spec in jobs:
        t0 = time.perf_counter()
        r = whole_full_job(torch, np, mesh, job, spec)
        out.append((r, round(time.perf_counter() - t0, 1)))
        if mesh.device.type == "cuda":
            free(torch)
    return out


def whole_full_job(torch, np, mesh, job: str, spec: dict):
    from repro_torch.configs.registry import get_config
    from repro_torch.configs.shapes import ShapeConfig

    if job == "train":  # 17e: 15d's train step under seq_parallel rules
        return mesh_full_rank(mesh, "yi-9b", spec["spec"], spec["ref_path"],
                              spec["mutants"])

    if job == "ds":  # 17b
        cfg = get_config("deepseek-v3-671b", smoke=spec.get("smoke", False)).replace(
            num_layers=spec["layers"], mtp_depth=0)
        if spec.get("smoke"):
            cfg = cfg.replace(capacity_factor=0.5)
        (bp, sp), (bd, sd) = spec["prefill"], spec["decode"]
        pre = ShapeConfig("prefill_32k", sp, bp, "prefill")
        dec = ShapeConfig("decode_32k", sd, bd, "decode")
        e2d = spec.get("smoke", False)
        pols = [whole_policy(cfg, sh, expert_2d=e2d) for sh in (pre, dec)]
        pols = [dataclasses.replace(p, q_chunk=spec.get("q_chunk", p.q_chunk))
                for p in pols]
        return whole_cells(torch, np, mesh, cfg, pre, dec, *pols,
                           mutants=spec.get("mutants", ()), trace=True)
    if job == "rec":  # 17c
        cfg = get_config(spec["arch"], smoke=spec.get("smoke", False))
        cfg = cfg.replace(dtype=spec["dtype"])
        (bp, sp), (bd, sd) = spec["prefill"], spec["decode"]
        pre = ShapeConfig("prefill_32k", sp, bp, "prefill")
        dec = ShapeConfig("decode_32k", sd, bd, "decode")
        return whole_cells(torch, np, mesh, cfg, pre, dec, whole_policy(cfg, pre),
                           whole_policy(cfg, dec), mutants=spec.get("mutants", ()),
                           mutants_on=("decode",))
    if job == "int8":  # 17d
        cfg, _, dec, _, _, _ = cell_setup(spec.get("smoke", False))
        cfg = cfg.replace(kv_cache_int8=True)
        r = whole_cell(torch, np, mesh, cfg, dec, whole_policy(cfg, dec, head_dim=True),
                       record_quant=True)
        r.pop("params"), r.pop("resolved")
        return r
    if job == "sp_prefill":  # 17e
        cfg, pre, _, _, _, _ = cell_setup(spec.get("smoke", False))
        r = whole_cell(torch, np, mesh, cfg, pre, whole_policy(cfg, pre,
                                                               seq_parallel=True))
        r.pop("params"), r.pop("resolved")
        return r
    raise KeyError(job)


def _gap(np, got, want):
    """max |got - want| over max |want|."""
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _block_gap(np, ranks, one, key):
    """The ranks' blocks of ``key`` against one rank's whole: the largest
    gap over its largest |value|."""
    worst = 0.0
    scale = max(float(np.abs(one[key]).max()), 1e-30)
    for r in ranks:
        worst = max(worst, float(np.abs(r[key] - one[key][r["rows"], r["cols"]]).max())
                    / scale)
    return worst


def _mutant_gap(np, ranks, one, name):
    """A mutant's output blocks against one rank's correct output."""
    return _block_gap(np, [dict(r, out=r[f"mutant_{name}"]) for r in ranks], one,
                      "out")


def _moe_gap(np, ranks, one, key="moe_y"):
    """The routed experts' output of the ranks' rows against one rank's,
    in norm (difference over one rank's)."""
    d = n = 0.0
    for r in ranks:
        for got, want in zip(r[key], one["moe_y"]):
            w = want[r["rows"]]
            d += float(np.square(got - w).sum())
            n += float(np.square(w).sum())
    return (d / max(n, 1e-30)) ** 0.5


def _quant_check(torch, np, ranks, dev):
    """17d: every layer's written codes and scales on the ranks against
    the whole head's quantization of the same keys/values: each layer's
    blocks gathered over ``model`` (ranks of one data row), quantized by
    the same function on ``dev`` (the card divides by a scalar as a
    product with its reciprocal, the CPU does not: one ulp of scale);
    codes equal to the bit, scales within ``WHOLE_SCALE_TOL``.  Returns
    (writes checked, worst scale gap)."""
    from repro_torch.models.layers.attention import quantize_kv

    n, worst = 0, 0.0
    rows = {}
    for i, r in enumerate(ranks):
        rows.setdefault(r["rows"].start, []).append(i)
    for _, members in rows.items():
        for j in range(len(ranks[members[0]]["quant"])):
            x = np.concatenate([ranks[i]["quant"][j][0] for i in members], axis=-1)
            q, s = (t.cpu() for t in quantize_kv(torch.from_numpy(x).to(dev)))
            w = x.shape[-1] // len(members)
            for k, i in enumerate(members):
                got_q, got_s = ranks[i]["quant"][j][1], ranks[i]["quant"][j][2]
                check(np.array_equal(got_q, q.numpy()[..., k * w:(k + 1) * w]),
                      f"17d: write {j} codes of rank {i} differ from the whole "
                      f"head's")
                gap = float(np.abs(got_s - s.numpy()).max()
                            / max(float(np.abs(s.numpy()).max()), 1e-30))
                worst = max(worst, gap)
                n += 1
    check(worst <= WHOLE_SCALE_TOL, f"17d: scales {worst} from the whole head's")
    return n, worst


def phase_whole(torch, np, dev, ref16, yi_ref_path, yi15_one, smoke: bool = False):
    """Phase 17 (module docstring).  ``ref16``: 16b's results (its prefill
    logits); ``yi_ref_path`` / ``yi15_one``: 15d's one-rank gradients and
    results.  With ``dev`` the CPU and ``smoke``, a rehearsal."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import TrainMesh, run_ranks

    res, counts, timing = {}, {}, {}
    card = dev.type
    # the ranks' allocators map memory as they grow: four ranks share the
    # card, and a rank's cached but unused blocks would starve the others
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    def ranks_of(fn, shape, args, device=card):
        out, c = run_ranks(fn, int(np.prod(shape)), backend="gloo", shape=shape,
                           axes=("data", "model"), device=device, args=args,
                           timeout_s=900)
        return out, c

    # 17a: the smoke setups, ranks on the card and on the CPU, one rank
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:  # the (1, 2) ranks beside the (2, 2) ones
        f12 = ex.submit(ranks_of, whole_smoke_rank, (1, 2), ("12",))
        card22, _ = ranks_of(whole_smoke_rank, (2, 2), ("22",))
        card12, _ = f12.result()
    one = {w: whole_smoke_jobs(torch, np, TrainMesh(dims=(1, 1), device=dev), w)
           for w in ("22", "12")}
    card_ranks = {"22": card22, "12": card12}
    a = {}
    for w, jobs in (("22", ("ds_train", "ds_cells", "sp_train", "sp_prefill")),
                    ("12", ("mamba2-1.3b", "recurrentgemma-9b", "int8"))):
        for job in jobs:
            o = one[w][job]
            for where, ranks in (("card", card_ranks[w]),):
                rs = [r[job] for r in ranks]
                if "losses" in o:  # a train step: its losses and gradients
                    gap = max(_gap(np, r["losses"], o["losses"]) for r in rs)
                    a[f"{job}_{where}_grads"] = ggap = _grads_gap(np, rs, o)
                    ok = ggap <= WHOLE_GRAD_TOL and all(
                        np.allclose(r["losses"], o["losses"], **WHOLE_SMOKE_TOL)
                        for r in rs)
                else:
                    parts = (("prefill", "decode") if "prefill" in o else (None,))
                    gap, ok = 0.0, True
                    for p in parts:
                        oo = o[p] if p else o
                        rr = [r[p] if p else r for r in rs]
                        g = _block_gap(np, rr, oo, "out")
                        gap = max(gap, g)
                        ok = ok and all(np.allclose(r["out"], oo["out"][r["rows"], r["cols"]],
                                                    **WHOLE_SMOKE_TOL) for r in rr)
                check(ok, f"17a {job} {where} ranks vs one rank on the card: {gap}")
                a[f"{job}_{where}"] = gap
    # the card's one rank == the CPU's one rank (so the card's ranks ==
    # the CPU's computation)
    for w in ("22", "12"):
        one_cpu = whole_smoke_jobs(torch, np, TrainMesh(dims=(1, 1)), w) if not smoke \
            else one[w]
        for job, o in one[w].items():
            oc = one_cpu[job]
            if "losses" in o:
                g = max(_gap(np, o["losses"], oc["losses"]), _grads_gap(np, [o], oc))
            else:
                g = max(_gap(np, (o[p] if p else o)["out"], (oc[p] if p else oc)["out"])
                        for p in (("prefill", "decode") if "prefill" in o else (None,)))
            check(g <= 1e-4, f"17a {job}: one rank on the card vs the CPU {g}")
            a[f"{job}_one_card_vs_cpu"] = g
    n_q, sgap = _quant_check(torch, np, [r["int8"] for r in card12], dev)
    a["int8_writes_checked"], a["int8_scale_gap"] = n_q, sgap
    res["17a"] = a
    add(whole_launches(card22 + card12))
    timing["17a_s"] = round(time.perf_counter() - t0, 1)
    if card == "cuda":
        free(torch)

    # 17b-17e: one rank at (1, 1) here for each, then one spawn a mesh
    # shape running its jobs in turn: (1, 2) 17c and 17e's prefill, (2, 2)
    # 17b, 17d and 17e's train step
    one = TrainMesh(dims=(1, 1), device=dev)
    ds_spec = dict(WHOLE_DS, smoke=smoke)
    if smoke:
        ds_spec.update(layers=2, prefill=(2, 32), decode=(4, 32))
    rec_spec = dict(WHOLE_REC, smoke=smoke)
    if smoke:
        rec_spec.update(prefill=(2, 32), decode=(4, 32))
    d_spec = dict(smoke=smoke)
    t_spec = dict(spec=dict(WHOLE_YI_TRAIN, **({"layers": 2, "B": 4, "S": 32,
                                                 "smoke": True} if smoke else {})),
                  ref_path=yi_ref_path,
                  mutants={n: "loss" for n in WHOLE_MUTANTS["17e"]})
    # the local-norm mutant on Mamba2's fp32 decode cell
    recs = [(f"{arch} {dt}", dict(rec_spec, arch=arch, dtype=dt, mutants=WHOLE_MUTANTS[
        "17c"] if (arch, dt) == ("mamba2-1.3b", "float32") else ()))
        for arch, dt in WHOLE_REC["runs"]]
    t0 = time.perf_counter()
    ones = {}
    for key, spec in recs:
        ones[key] = whole_full_job(torch, np, one, "rec", dict(spec, mutants=()))
        if card == "cuda":
            free(torch)
    r12, _ = ranks_of(whole_full_rank, (1, 2), (
        [("rec", spec) for _, spec in recs] + [("sp_prefill", dict(smoke=smoke))],))
    timing["12_spawn_s"] = round(time.perf_counter() - t0, 1)
    t0 = time.perf_counter()
    ds_one = whole_full_job(torch, np, one, "ds", ds_spec)
    if card == "cuda":
        free(torch)
    d_one = whole_full_job(torch, np, one, "int8", d_spec)
    if card == "cuda":
        free(torch)
        timing["17b_parent_reserved_gb"] = round(torch.cuda.memory_reserved() / 1e9, 3)
    r22, _ = ranks_of(whole_full_rank, (2, 2), (
        [("ds", dict(ds_spec, mutants=WHOLE_MUTANTS["17b"])), ("int8", d_spec),
         ("train", t_spec)],))
    timing["22_spawn_s"] = round(time.perf_counter() - t0, 1)
    for i, key in enumerate([k for k, _ in recs] + ["17e_prefill"]):
        timing[f"{key}_rank_s"] = r12[0][i][1]
    for i, key in enumerate(("17b", "17d", "17e_train")):
        timing[f"{key}_rank_s"] = r22[0][i][1]

    # 17b: DeepSeek-V3 full width, 4 layers, (2, 2) against (1, 1)
    ds_ranks = [r[0][0] for r in r22]
    add(whole_launches(ds_ranks))
    b = {}
    for p in ("prefill", "decode"):
        rs = [r[p] for r in ds_ranks]
        b[f"{p}_gap"] = _block_gap(np, rs, ds_one[p], "out")
        b[f"{p}_moe_gap"] = _moe_gap(np, rs, ds_one[p])
        b[f"{p}_wall_ms"] = [r["wall_ms"] for r in rs]
        b[f"{p}_one_wall_ms"] = ds_one[p]["wall_ms"]
        b[f"{p}_init"] = [dict(peak_gb=r["init_peak_gb"], block_gb=r["block_gb"],
                               dryrun_gb=r["dryrun_gb"], init_s=r["init_s"],
                               run_peak_gb=r.get("run_peak_gb"))
                          for r in rs]
        b[f"{p}_one_run_peak_gb"] = ds_one[p].get("run_peak_gb")
        b[f"{p}_one_block_gb"] = ds_one[p]["block_gb"]
        check(b[f"{p}_gap"] <= TP_LOGIT_TOL, f"17b {p} logits {b[f'{p}_gap']} of "
              f"(1, 1)'s largest")
        check(b[f"{p}_moe_gap"] <= MESH_MOE_OUT_TOL, f"17b {p} routed experts' "
              f"output {b[f'{p}_moe_gap']}")
    for name in WHOLE_MUTANTS["17b"]:  # held on the MoE block's output
        rs = [r["prefill"] for r in ds_ranks]
        mg = _moe_gap(np, rs, ds_one["prefill"], f"mutant_{name}_moe_y")
        b[f"mutant_{name}_moe_gap"] = mg
        check(mg > MESH_MOE_OUT_TOL, f"17b mutant {name} passed: routed output {mg}")
    for r in ds_ranks:  # the prefill cell draws the weights
        p = r["prefill"]
        check(p["init_peak_gb"] <= p["block_gb"] + WHOLE_INIT_SLACK_GB,
              f"17b init peak {p['init_peak_gb']} GB beside {p['block_gb']} GB")
    res["17b"] = b

    # 17c: Mamba2-1.3B (fp32 and bf16) and RecurrentGemma-9B whole at (1, 2)
    cres = {}
    for i, (key, spec) in enumerate(recs):
        o, rs = ones[key], [r[i][0] for r in r12]
        add(whole_launches(rs))
        mamba_bf16 = key == "mamba2-1.3b bfloat16"
        tol = WHOLE_FP32_TOL if spec["dtype"] == "float32" else TP_LOGIT_TOL
        cc = {"dtype": spec["dtype"], "tol": tol}
        for p in ("prefill", "decode"):
            rr = [r[p] for r in rs]
            cc[f"{p}_gap"] = _block_gap(np, rr, o[p], "out")
            if mamba_bf16:  # both bf16 layouts against the fp32 (1, 1) cell
                o32 = ones["mamba2-1.3b float32"][p]
                cc[f"{p}_one_vs_fp32"] = _gap(np, o[p]["out"], o32["out"])
                cc[f"{p}_vs_fp32"] = _block_gap(np, rr, o32, "out")
                cc[f"{p}_limit"] = WHOLE_BF16_RATIO * cc[f"{p}_one_vs_fp32"]
                check(cc[f"{p}_vs_fp32"] <= cc[f"{p}_limit"],
                      f"17c {key} {p} logits {cc[f'{p}_vs_fp32']} from the fp32 "
                      f"(1, 1) cell's, (1, 1) bf16 {cc[f'{p}_one_vs_fp32']}")
            else:
                check(cc[f"{p}_gap"] <= tol, f"17c {key} {p} logits "
                      f"{cc[f'{p}_gap']} (limit {tol})")
            cc[f"{p}_bytes"] = dict(rank_gb=[r["block_gb"] for r in rr],
                                    dryrun_gb=[r["dryrun_gb"] for r in rr],
                                    one_gb=o[p]["block_gb"])
            cc[f"{p}_wall_ms"] = [r["wall_ms"] for r in rr]
            cc[f"{p}_one_wall_ms"] = o[p]["wall_ms"]
        for name in spec["mutants"]:  # on the decode cell
            g = _mutant_gap(np, [r["decode"] for r in rs], o["decode"], name)
            cc[f"mutant_{name}"] = g
            check(g > tol, f"17c mutant {name} passed: {g}")
        cres[key] = cc
    res["17c"] = cres

    # 17d: Yi-9B's decode cell with an int8 cache, head_dim over model
    d_ranks = [r[1][0] for r in r22]
    add(whole_launches(d_ranks))
    d = dict(gap=_block_gap(np, d_ranks, d_one, "out"),
             wall_ms=[r["wall_ms"] for r in d_ranks], one_wall_ms=d_one["wall_ms"])
    check(d["gap"] <= TP_LOGIT_TOL, f"17d logits {d['gap']}")
    d["writes_checked"], d["scale_gap"] = _quant_check(torch, np, d_ranks, dev)
    # the codes beside (1, 1)'s, a reading: the keys themselves move with
    # the layout's bf16 partial sums from layer to layer
    def code_diff(i, r, j):
        got = r["quant"][j][1].astype(np.int32)
        w = got.shape[-1]
        want = d_one["quant"][j][1][r["rows"], ..., w * (i % 2): w * (i % 2 + 1)]
        return np.abs(got - want.astype(np.int32))

    diffs = [(j, code_diff(i, r, j)) for i, r in enumerate(d_ranks)
             for j in range(len(r["quant"]))]
    d["codes_vs_one_rank"] = dict(
        equal_share=float(np.mean([float((x == 0).mean()) for _, x in diffs])),
        within_one_share=float(np.mean([float((x <= 1).mean()) for _, x in diffs])),
        layer0_equal_share=float(np.mean([float((x == 0).mean()) for j, x in diffs
                                          if j < 2])),
        max_step=int(max(int(x.max()) for _, x in diffs)))
    res["17d"] = d

    # 17e: Yi-9B under seq_parallel: prefill cell at (1, 2) against 16b's,
    # the 4-layer (2, 2) FSDP train step against 15d's one rank
    e_ranks = [r[len(recs)][0] for r in r12]
    add(whole_launches(e_ranks))
    e = dict(prefill_gap=_block_gap(np, e_ranks, {"out": ref16["prefill_logits"]}, "out"),
             prefill_wall_ms=[r["wall_ms"] for r in e_ranks],
             prefill_block_gb=[r["block_gb"] for r in e_ranks])
    check(e["prefill_gap"] <= TP_LOGIT_TOL, f"17e prefill logits {e['prefill_gap']}")
    t_ranks = [r[2][0] for r in r22]
    loss_gap = max(abs(r["first_loss"] - yi15_one["first_loss"]) / abs(yi15_one["first_loss"])
                   for r in t_ranks)
    grad_gap = max(g[0] for r in t_ranks for g in r["gaps"].values())
    e.update(first_loss=t_ranks[0]["first_loss"], one_rank_first_loss=yi15_one["first_loss"],
             loss_gap=loss_gap, grad_gap=grad_gap,
             peak_gb=max(r["peak_gb"] for r in t_ranks),
             param_bytes=t_ranks[0]["param_bytes"])
    check(loss_gap <= MESH_FULL_LOSS_TOL, f"17e first loss gap {loss_gap}")
    check(grad_gap <= MESH_FULL_GRAD_TOL, f"17e gradient gap {grad_gap}")
    for name in WHOLE_MUTANTS["17e"]:
        g = max(abs(r["mutants"][name] - yi15_one["first_loss"]) / abs(yi15_one["first_loss"])
                for r in t_ranks)
        e[f"mutant_{name}"] = g
        check(g > MESH_FULL_LOSS_TOL, f"17e mutant {name} passed: {g}")
    res["17e"] = e
    res["timing"] = timing
    return counts, res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile Yi-9B decode ticks (phases 4, 5 and "
                    "7b's dense server), spec rounds (7b), the GRIFFIN "
                    "engines' prefill and decode steps (9b, 10b, 10c, 11b; "
                    "11c's dense engine) and 12d's dense prefix prefill with "
                    "torch.profiler; the attention kernels' share is named "
                    "apart")
    ap.add_argument("--out", default="", help="also write the results as JSON")
    args = ap.parse_args()

    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: no src/repro_torch beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # the measured phases keep to their cores from here on (the processes
    # they start inherit them), 16a's dry-runs to the others
    all_cores = sorted(os.sched_getaffinity(0))
    cores, dry_cores = split_cores()
    os.sched_setaffinity(0, cores)
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

    t_script = time.perf_counter()
    marks = {}  # seconds since the build began, at the end of each phase
    t0 = time.perf_counter()
    build.build()
    print(f"phase 1 build: {time.perf_counter() - t0:.2f} s")
    # 16a's dry-runs step from here on, on cores of their own; 16a reads
    # them after phase 17
    dry_start = time.perf_counter()
    dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    dry_procs = start_dryrun(dry_dir, dry_cores)
    print(f"host cores: phases {cores}, 16a's dry-runs {dry_cores}")
    atexit.register(stop_dryrun, dry_procs)
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
    # and at phase 11's (RecurrentGemma-9B's), between 11264 and 18432
    rec_stat = engine_shape_expert_stat(torch, dev, RECURRENT_STAT_WIDTH,
                                        (torch.bfloat16,))["bf16"]
    lo, hi = moe_stat[11264]["ms"], moe_stat[18432]["ms"]
    rec_stat["cliff_side"] = "11264's" if abs(rec_stat["ms"] - lo) <= \
        abs(rec_stat["ms"] - hi) else "18432's"
    lines.append(f"expert_stat {rec_stat['at']} bf16 (phase 11's width): kernel "
                 f"{rec_stat['ms']:.4f} ms  plain {rec_stat['plain_ms']:.4f} ms  "
                 f"bound {rec_stat['bound_ms']:.5f} ms ({rec_stat['bound_by']})  "
                 f"max_abs_err {rec_stat['max_abs_err']:.3g}  nearer "
                 f"{rec_stat['cliff_side']} time (F=11264 {lo:.4f}, 18432 {hi:.4f} ms)")
    kernels["expert_stat"]["recurrent_engine"] = rec_stat
    # and at phase 12's shapes
    fe_stat = [engine_shape_expert_stat(torch, dev, F, (torch.bfloat16,), B=B, S=S)["bf16"]
               for B, S, F in FRONTEND_STAT_SHAPES]
    for r in fe_stat:
        lines.append(f"expert_stat {r['at']} bf16 (phase 12's shapes): kernel "
                     f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  bound "
                     f"{r['bound_ms']:.5f} ms ({r['bound_by']})  max_abs_err "
                     f"{r['max_abs_err']:.3g}")
    kernels["expert_stat"]["frontend_engine"] = fe_stat
    marks["2"] = round(time.perf_counter() - t_script, 1)
    print(f"phase 2 kernels vs plain versions ({card}):")
    for line in lines:
        print("  " + line)

    t0 = time.perf_counter()
    tiny_counts, streams = phase_tinylm(torch, np, dev)
    marks["3"] = round(time.perf_counter() - t_script, 1)
    print(f"phase 3 tinylm fused == gather == CPU plain, fp32/int8/fp8 pools: "
          f"{time.perf_counter() - t0:.1f} s, launches {tiny_counts}, rid 0 "
          + ", ".join(f"{k} {v[0]}" for k, v in streams.items()))

    t0 = time.perf_counter()
    cfg, params, prompts, model = yi9b_model(torch, np, dev)
    yi, yi_streams = serve_paged(torch, np, dev, cfg, params, prompts, "fp32",
                                args.profile)
    marks["4"] = round(time.perf_counter() - t_script, 1)
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
        res, out = serve_paged(torch, np, dev, cfg, params, prompts, kvd,
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
        again, _ = serve_paged(torch, np, dev, cfg, params, prompts, "fp32")
        print("phase 5 bracket: yi-9b bf16 pools again: "
              + ", ".join(f"{k} {again[k]}" for k in
                          ("tokens_per_s", "ttft_p50_s", "tpot_p50_s")))

    t0 = time.perf_counter()
    ff_counts, ff = phase_ffn_entry_points(torch, dev, cfg, params)
    marks["6"] = round(time.perf_counter() - t_script, 1)
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
    spec_dense, dense_out = serve_paged(torch, np, dev, cfg, params, prompts,
                                       "fp32", args.profile, griffin=False)
    spec, spec_out = serve_paged(torch, np, dev, cfg, params, prompts, "fp32",
                                args.profile, spec_k=4)
    spec["token_match_vs_dense"] = match_rate(spec_out, dense_out)
    marks["7"] = round(time.perf_counter() - t_script, 1)
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
    marks["8"] = round(time.perf_counter() - t_script, 1)
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
    marks["9"] = round(time.perf_counter() - t_script, 1)
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
            ("moonshot-v1-16b-a3b", "10b", {}, FAMILY_BATCHER["lens"]),
            ("deepseek-v3-671b", "10c", dict(num_layers=4, mtp_depth=0), None)):
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
    marks["10"] = round(time.perf_counter() - t_script, 1)
    print(f"phase 10 total: {time.perf_counter() - t10:.1f} s")

    t11 = t0 = time.perf_counter()
    rec_smoke_counts, rec_smoke = phase_families_smoke(torch, np, dev, RECURRENT,
                                                       "11a", scale=2.0)
    print(f"phase 11a recurrentgemma/mamba2 smoke configs, GenerationEngine "
          f"(dense/GRIFFIN 0.5), ContinuousBatcher and launch.serve slot "
          f"fallback, card == CPU: {time.perf_counter() - t0:.1f} s, launches "
          f"{rec_smoke_counts}")
    for k, v in rec_smoke.items():
        print(f"  {k}: {v}")
    for arch, tag in zip(RECURRENT, ("11b", "11c")):
        t0 = time.perf_counter()
        before_gb = torch.cuda.memory_allocated() / 1e9
        fcfg, fparams, fmodel = family_model(torch, dev, arch)
        # at the init's scale RecurrentGemma's greedy streams repeat one
        # token (as the smoke config's do), which would make GRIFFIN 0.0
        # == dense hold trivially
        scale_matrices(fparams, 2.0)
        counts, res = phase_family_full(torch, np, dev, fcfg, fparams, tag,
                                        RECURRENT_BATCHER_LENS, args.profile)
        del fparams
        gc.collect()
        torch.cuda.empty_cache()
        if not fcfg.has_ffn:
            check(sum(counts.values()) == 0, f"{tag} {arch} launched {counts}")
        family[tag] = dict(arch=arch, model=fmodel, launches=counts, **res)
        print(f"{tag} {arch} {fcfg.num_layers} layers, "
              f"{fmodel['params'] / 1e9:.2f}B params ({fmodel['weights_gb']:.1f} GB "
              f"on the card, {before_gb:.2f} GB before the draw), init "
              f"{fmodel['init_s']:.1f} s; GenerationEngine B={FAMILY_ENGINE['B']} "
              f"prompt {FAMILY_ENGINE['S']} + {FAMILY_ENGINE['steps']} new, "
              f"ContinuousBatcher prompts {RECURRENT_BATCHER_LENS} + "
              f"{FAMILY_BATCHER['new']} new ({card}): "
              f"{time.perf_counter() - t0:.1f} s, launches {counts}")
        for k, v in res.items():
            print(f"  {k}: {v}")
    marks["11"] = round(time.perf_counter() - t_script, 1)
    print(f"phase 11 total: {time.perf_counter() - t11:.1f} s")

    t12 = t0 = time.perf_counter()
    fe_smoke_counts, fe_smoke = phase_frontends_smoke(torch, np, dev)
    print(f"phase 12a gemma3/command-r+/llava-next/hubert smoke configs, "
          f"PagedServer fused and gather, prefix prefill + decode, encoder "
          f"flocking, launch.serve, card == CPU: {time.perf_counter() - t0:.1f} s, "
          f"launches {fe_smoke_counts}")
    for k, v in fe_smoke.items():
        print(f"  {k}: {v}")
    frontends = {}
    runs = (
        ("12b", "gemma3-27b whole, PagedServer 1 slot GRIFFIN 0.5 then dense, "
         f"prompts {GEMMA_LENS} + 32 new",
         lambda: phase_paged_family(torch, np, dev, "gemma3-27b", GEMMA_LENS, 1,
                                    GEMMA_MAX_LEN)),
        ("12c", "command-r-plus-104b full width, 8 layers, PagedServer 2 slots "
         f"GRIFFIN 0.5 then dense, prompts {YI_PROMPT_LENS} + 32 new",
         lambda: phase_paged_family(torch, np, dev, "command-r-plus-104b",
                                    YI_PROMPT_LENS, 2, 640, num_layers=8)),
        ("12d", f"llava-next-34b full width, 30 layers, prefix prefill "
         f"{LLAVA_PREFILL} dense and GRIFFIN 0.5, ContinuousBatcher prompts "
         f"{LLAVA_BATCHER_LENS} + {FAMILY_BATCHER['new']} new",
         lambda: phase_llava(torch, np, dev, args.profile)),
        ("12e", f"hubert-xlarge whole, forward over {HUBERT_FRAMES} frames "
         "with statistics, per-layer flocking",
         lambda: phase_hubert(torch, np, dev)))
    for tag, what, run in runs:
        t0 = time.perf_counter()
        before_gb = torch.cuda.memory_allocated() / 1e9
        counts, res = run()
        frontends[tag] = dict(launches=counts, **res)
        model = res.pop("model")
        print(f"{tag} {what} ({card}): {model['params'] / 1e9:.2f}B params "
              f"({model['weights_gb']:.1f} GB on the card, {before_gb:.2f} GB "
              f"before the draw), init {model['init_s']:.1f} s; "
              f"{time.perf_counter() - t0:.1f} s, launches {counts}")
        for k, v in res.items():
            print(f"  {k}: {v}")
    marks["12"] = round(time.perf_counter() - t_script, 1)
    print(f"phase 12 total: {time.perf_counter() - t12:.1f} s")

    t13 = t0 = time.perf_counter()
    train_counts, train_smoke = phase_train_smoke(torch, np, dev)
    print(f"phase 13a train steps, every smoke arch + tinylm (adamw; tinylm "
          f"also adam8bit and accum 2), card == CPU: "
          f"{time.perf_counter() - t0:.1f} s, launches {train_counts}")
    for k, v in train_smoke.items():
        print(f"  {k}: {v}")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        train_tiny = phase_train_tinylm(torch, np, dev, Path(tmp))
        print(f"phase 13b tinylm, the reference's recipe ({TINY_RECIPE['steps']} steps "
              f"adamw warmup_cosine, batch {TINY_RECIPE['batch']} x "
              f"{TINY_RECIPE['seq']}), preempted at {TINY_RECIPE['preempt_at']} and "
              f"resumed, served, generation_ppl ({card}): "
              f"{time.perf_counter() - t0:.1f} s")
        for k, v in train_tiny.items():
            print(f"  {k}: {v}")
        t0 = time.perf_counter()
        examples_counts, examples = phase_examples(torch, np, dev, Path(tmp))
    print(f"phase 13d the examples (quickstart as python -m; serve_batched, "
          f"flocking_analysis --emit-profile served at tier 0.5, train_lm 3 steps) "
          f"from 13b's model, serve_batched and the profile card == CPU ({card}): "
          f"{time.perf_counter() - t0:.1f} s, launches {examples_counts}")
    for k, v in examples.items():
        print(f"  {k}: {v}")
    t0 = time.perf_counter()
    yi_train_counts, yi_train = phase_train_yi9b(torch, np, dev)
    print(f"phase 13c yi-9b whole, bf16, remat, adam8bit, {YI_TRAIN['steps']} steps "
          f"on {YI_TRAIN['B']} x {YI_TRAIN['S']} tokens ({card}): "
          f"{time.perf_counter() - t0:.1f} s, launches {yi_train_counts}")
    for k, v in yi_train.items():
        print(f"  {k}: {v}")
    marks["13"] = round(time.perf_counter() - t_script, 1)
    print(f"phase 13 total: {time.perf_counter() - t13:.1f} s")

    free(torch)
    t14 = t0 = time.perf_counter()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    tp_stat, tp_attn, tp_lines = phase_tp_kernels(torch, dev, flush)
    del flush
    kernels["paged_attn"]["tp_local"] = tp_attn
    for name, cases in tp_stat.items():
        kernels[name] = dict(cases[0], cases=cases)
    print(f"phase 14a expert_stat_row_sq / expert_stat_from_norm and paged_attn "
          f"at the ranks' local head counts vs plain versions ({card}): "
          f"{time.perf_counter() - t0:.1f} s")
    for line in tp_lines:
        print("  " + line)
    t0 = time.perf_counter()
    tp_paths, tp_tiny = phase_tp_tinylm(torch, np, dev)
    print(f"phase 14b tinylm-tp fp32 TP=2 and TP=4, ranks on one card over gloo "
          f"(gather: spec_k 0/4 x fp32/int8 pools; fused at head_dim 32: "
          f"fp32/int8) == one rank == CPU; 14c NCCL world 1 == plain server "
          f"({card}): {time.perf_counter() - t0:.1f} s, launches {tp_paths}")
    for k, v in tp_tiny.items():
        print(f"  {k}: {v}")
    free(torch)
    t0 = time.perf_counter()
    yi_tp_counts, yi_tp = phase_tp_yi9b(torch, np, dev, yi)
    tp_paths["tp2_yi9b"] = yi_tp_counts
    print(f"phase 14d yi-9b at {TP_YI_LAYERS} layers, bf16, GRIFFIN 0.5, TP=2 over "
          f"gloo on one card, "
          f"phase 4's prompts, {TP_YI_NEW} new tokens each, prefill chunks of "
          f"{TP_YI_CHUNK}, beside one rank with tp_shards=2, then the ranks behind "
          f"the mesh frontend (8b's four POSTs, SSE == the drain) ({card}): "
          f"{time.perf_counter() - t0:.1f} s, launches {yi_tp_counts}")
    for k, v in yi_tp.items():
        print(f"  {k}: {v}")
    marks["14"] = round(time.perf_counter() - t_script, 1)
    print(f"phase 14 total: {time.perf_counter() - t14:.1f} s")

    free(torch)
    t0 = time.perf_counter()
    # 15d's one-rank gradients stay for 17e
    mesh_tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    atexit.register(shutil.rmtree, mesh_tmp, True)
    mesh_counts, mesh_train = phase_mesh_train(torch, np, dev, Path(mesh_tmp))
    marks["15"] = round(time.perf_counter() - t_script, 1)
    print(f"phase 15 sharded training, ranks on one card over gloo, TF32 off: "
          f"15a yi/tinylm smoke (2, 2) FSDP == one rank on the card == CPU; 15b "
          f"routed EP (Moonshot smoke) and 2-D EP (DeepSeek-V3 smoke) card == "
          f"CPU; 15c compression on 4 data ranks, elastic (2, 2) -> (1, 2) == one "
          f"rank resumed; 15d "
          f"yi-9b {MESH_YI['layers']} layers full width bf16 remat (2, 2) FSDP "
          f"AdamW, {MESH_YI['steps']} steps of {MESH_YI['B']} x {MESH_YI['S']}; "
          f"15e moonshot {MESH_MOON['layers']} layers full width routed EP "
          f"(1, 2); 15f its MoE block over {MOE_CHUNKS['B']} x {MOE_CHUNKS['S']} "
          f"tokens, several global chunks, without EP on 4 data ranks and "
          f"routed EP at (2, 2) vs one rank ({card}): "
          f"{time.perf_counter() - t0:.1f} s, launches "
          f"{mesh_counts}")
    for k, v in mesh_train.items():
        print(f"  {k}: {v}")

    free(torch)
    t16 = t0 = time.perf_counter()
    cells_counts, cells_one, cells_ref = phase_cells_one(torch, np, dev)
    marks["16b"] = round(time.perf_counter() - t_script, 1)
    print(f"phase 16b yi-9b at {CELL_LAYERS} layers, bf16, GRIFFIN 0.5, random "
          f"weights from seed 0, "
          f"cells at (1, 1) from cells.build_cell + materialize: prefill "
          f"{CELL_PREFILL[2]} x {CELL_PREFILL[1]} (cut from 32 x 32,768), decode "
          f"{CELL_DECODE[2]} sequences over a {CELL_DECODE[1]}-token cache at pos "
          f"{CELL_DECODE[1] - 1} (cut from 128), == GenerationEngine ({card}): "
          f"{time.perf_counter() - t0:.1f} s, launches {cells_counts}")
    for k, v in cells_one.items():
        print(f"  {k}: {v}")
    t0 = time.perf_counter()
    cells_mesh_counts, cells_mesh = phase_cells_mesh(torch, np, cells_ref, dev)
    marks["16c"] = round(time.perf_counter() - t_script, 1)
    print(f"phase 16c the same cells at (2, 2), four gloo ranks on the one card "
          f"(decode twice: kv_seq split under policy_for's rules, head_dim split "
          f"under the fallback with kv_heads off model), mutants "
          f"{list(CELL_MUTANTS)} ({card}): {time.perf_counter() - t0:.1f} s, "
          f"launches {cells_mesh_counts}")
    for k, v in cells_mesh.items():
        print(f"  {k}: {v}")
    # phase 17: the production mesh whole
    free(torch)
    t17 = time.perf_counter()
    whole_counts, whole = phase_whole(
        torch, np, dev, cells_ref, str(Path(mesh_tmp) / "yi_grads.pt"),
        {"first_loss": mesh_train["15d_yi9b"]["one_rank_first_loss"]})
    tm = whole["timing"]
    print(f"phase 17a smoke setups card == CPU: DeepSeek-V3 (capacity 0.5) "
          f"experts over (data, model) without a group limit, train step and "
          f"prefill / decode cells at (2, 2); Yi-9B sequence-parallel train "
          f"step and prefill cell at (2, 2); Mamba2 and RecurrentGemma cells "
          f"split over model and tinylm's int8 cache over head_dim at (1, 2); "
          f"each beside one rank ({card}): {tm['17a_s']} s")
    print(f"phase 17b-e one rank each here, then one (1, 2) spawn (17c "
          f"{', '.join(f'{a} {d}' for a, d in WHOLE_REC['runs'])} whole, prefill "
          f"{WHOLE_REC['prefill']} decode {WHOLE_REC['decode']}, mutant "
          f"{list(WHOLE_MUTANTS['17c'])}; 17e yi-9b sequence-parallel prefill "
          f"cell vs 16b): {tm['12_spawn_s']} s, and one (2, 2) spawn (17b "
          f"deepseek-v3 full width, {WHOLE_DS['layers']} layers, no MTP, bf16, "
          f"GRIFFIN 0.5, prefill {WHOLE_DS['prefill']} and decode "
          f"{WHOLE_DS['decode']}, mutants {list(WHOLE_MUTANTS['17b'])}; 17d "
          f"yi-9b int8 decode over head_dim; 17e the {WHOLE_YI_TRAIN['layers']}"
          f"-layer FSDP train step's loss and gradients vs 15d's one rank, "
          f"mutant {list(WHOLE_MUTANTS['17e'])}) ({card}): {tm['22_spawn_s']} s")
    for k, v in whole.items():
        print(f"  {k}: {v}")
    marks["17"] = round(time.perf_counter() - t_script, 1)
    print(f"phase 17 total: {time.perf_counter() - t17:.1f} s, launches "
          f"{whole_counts}")
    # 16a: the dry-runs started after the build, now on every core
    t0 = time.perf_counter()
    left = sorted(n for n, (p, _) in dry_procs.items() if p.poll() is None)
    widen_dryrun(dry_procs, all_cores)
    dry_counts, dry_lines = phase_dryrun(dry_procs, dry_dir, t0)
    print(f"phase 16a dry-run --all --pods 1 and 2 ({DRYRUN_JOBS} jobs each), "
          f"DeepSeek-V3 with --moe-group-limit {DRYRUN_GROUP_LIMIT} at both, "
          f"--seq-parallel at one pod over {list(DRYRUN_SP_SHAPES)} of "
          f"{list(DRYRUN_SP_ARCHS)}, on cores {dry_cores} beside phases 2-17 "
          f"(on {cores}) from the build on, still running after phase 17: "
          f"{left}: waited {time.perf_counter() - t0:.1f} s after phase 17, "
          f"{time.perf_counter() - dry_start:.1f} s since they started, "
          f"{dry_counts}; not ported: {sorted(DRYRUN_NOT_PORTED)}")
    for line in dry_lines:
        print("  " + line)
    marks["16a"] = round(time.perf_counter() - t_script, 1)
    print(f"phase 16 total: {time.perf_counter() - t16:.1f} s; script "
          f"{time.perf_counter() - t_script:.1f} s since the build began")

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
             "deepseek_v3": family["10c"]["launches"],
             "recurrent_smoke": rec_smoke_counts,
             "recurrentgemma": family["11b"]["launches"],
             "mamba2": family["11c"]["launches"],
             "frontends_smoke": fe_smoke_counts,
             "gemma3": frontends["12b"]["launches"],
             "command_r_plus": frontends["12c"]["launches"],
             "llava_next": frontends["12d"]["launches"],
             "hubert": frontends["12e"]["launches"],
             "examples_tinylm": examples_counts, **tp_paths,
             "cells_yi9b": cells_counts, "cells_yi9b_22": cells_mesh_counts,
             "mesh_whole": tp_counts(whole_counts)}
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
        # the statistic's two steps under tensor parallelism (phase 14)
        "expert_stat_row_sq": ("src/repro_torch/csrc/expert_stat.cu",
                               "src/repro/kernels/expert_stat.py:47"),
        "expert_stat_from_norm": ("src/repro_torch/csrc/expert_stat.cu",
                                  "src/repro/kernels/expert_stat.py:47"),
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
            entry["recurrent_engine"] = r["recurrent_engine"]  # and phase 11's
            entry["frontend_engine"] = r["frontend_engine"]  # and phase 12's
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
            # phase 12's shapes: Gemma-3's window, Command-R+'s group of 12
            for case, p in r.get("phase12", {}).items():
                entry.update({f"{case}_{k}": v for k, v in p.items()})
            # phase 14's local head counts: Yi-9B at TP=2, one KV head
            for case, p in r.get("tp_local", {}).items():
                entry.update({f"{case}_{k}": v for k, v in p.items()})
        if "cases" in r:  # the two-step statistic at all of 14a's shapes
            entry["cases"] = r["cases"]
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
             "families_smoke": fam_smoke, "recurrent_smoke": rec_smoke,
             "families": family, "frontends_smoke": fe_smoke,
             "frontends": frontends, "train_smoke": train_smoke,
             "train_tinylm": train_tiny, "examples": examples,
             "train_yi9b": yi_train,
             "tp_tinylm": tp_tiny, "tp_yi9b": yi_tp, "mesh_train": mesh_train,
             "cells_one": cells_one, "cells_mesh": cells_mesh,
             "mesh_whole": whole,
             "dryrun": dry_lines,
             "tinylm_launches": tiny_counts, "lines": lines,
             "phase_marks_s": marks}, indent=1,
            default=str))
    print("phase marks, s since the build began: " + json.dumps(marks))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
