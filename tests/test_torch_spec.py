"""The port's self-speculative serving on the CPU, held against the JAX
package.

* ``draft_loop_paged``, ``verify_step_paged`` and ``draft_verify_paged``
  against the reference's on the same pools, block tables, positions,
  per-slot compacted FF weights, ``k_r = [2, 0, 3]`` and ``row_live =
  [T, T, F]``: drafts equal, logits within 1e-5, int8/fp8 page bits
  identical and fp32 pools and scales within 1e-5, except the trash page.
* ``sampling``: the acceptance walks equal the reference's (the
  speculative rule draw for draw from the same ``np.random`` seed);
  ``sample`` is exact when greedy or ``top_k=1`` and right in
  distribution otherwise (torch cannot reproduce ``jax.random``).
* ``PagedServer(spec_k=...)`` on the traces of ``tests/test_speculative.py``
  (basic, vanilla fallback, oversized ``spec_k``, preemption, adaptive
  drafting through preemption and prefix hits, rounds capped while a
  prompt prefills): token streams identical to the JAX spec server's and
  to the port's dense (``gcfg=None``) server, the speculative counters
  and modeled attention bytes equal to the JAX server's, the allocator
  consistent and empty after ``flush_prefix``; ``spec_impl="fused"``
  equals ``"per_token"`` on both backends; int8 and fp8 pools match the
  JAX spec server too.  The parameters are the scaled tinylm draw of
  ``tests/test_torch_server.py`` (the reference's tests use a trained
  checkpoint, which a fresh checkout may lack).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core import griffin as jg  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serving import sampling as jsampling  # noqa: E402
from repro.serving.server import PagedServer as JaxServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import griffin as tg  # noqa: E402
from repro_torch.kernels import kv_quant as tq  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.server import PagedServer  # noqa: E402
from test_torch_kv_quant import _bits, _to_jax_pool  # noqa: E402
from test_torch_server import _record_margins, params  # noqa: E402,F401

CFG = get_config("tinylm")
TCFG = tget("tinylm")
TOL = dict(rtol=1e-5, atol=1e-5)
SPEC_KEYS = ("spec_rounds", "draft_tokens", "acceptance_rate",
             "tokens_per_verify", "spec_capped_rounds", "attn_bytes_read_total")


def _gj():
    return jg.GriffinConfig(sparsity=0.5, per_shard_topk=False)


def _gt():
    return tg.GriffinConfig(sparsity=0.5, per_shard_topk=False)


# ---------------------------------------------------------------------------
# decoder: draft loop, verify step, fused round
# ---------------------------------------------------------------------------

PAGE, P, SPEC_K = 8, 12, 3
K_R = np.array([2, 0, 3], np.int32)
LIVE = np.array([True, True, False])
POS = np.array([13, 7, 20], np.int32)


def _pools(rng, kvd):
    """Per-layer pools of random cached rows (fp32), or those rows
    quantized page by page (int8/fp8: live bits under grown scales)."""
    KV, hd = CFG.num_kv_heads, CFG.head_dim
    pools = []
    for _ in range(CFG.num_layers):
        layer = {}
        for name in ("k", "v"):
            f = torch.from_numpy(
                rng.normal(size=(P + 1, PAGE, KV, hd)).astype(np.float32))
            if kvd == "fp32":
                layer[name] = f
                continue
            zero = torch.zeros(f.shape, dtype=tq.pool_torch_dtype(kvd, "float32"))
            layer[name], layer[name + "_scale"] = tq.quantize_scatter_ref(
                zero, torch.zeros((P + 1, 1, KV, 1)),
                torch.arange(P + 1).repeat_interleave(PAGE),
                torch.arange(PAGE).repeat(P + 1), f.reshape(-1, KV, hd), kvd)
        pools.append(layer)
    return pools


def _jax_tree(per_layer):
    """``{li: x}`` -> the reference's segment tree (scan leaves stacked)."""
    out = {}
    for li, (path, inst, _) in enumerate(tdec.layer_paths(TCFG)):
        seg, name = path.split("/")
        out.setdefault(seg, {}).setdefault(name, []).append(per_layer[li])
    return {seg: {name: jax.tree.map(lambda *a: jnp.stack(a), *xs)
                  if name.startswith("pos") else xs[0]
                  for name, xs in d.items()} for seg, d in out.items()}


def _jax_pools(tpools):
    return _jax_tree([{k: _to_jax_pool(v) if v.dtype != torch.float32
                       else jnp.asarray(v.numpy()) for k, v in layer.items()}
                      for layer in tpools])


def _assert_pools(tpools, jpools, what):
    """Port pools against the reference's, except the trash page: int8 /
    fp8 page bits identical, fp32 leaves (pages, scales) within 1e-5.  A
    scale is an fp32 activation maximum, and the port's activations differ
    from XLA's by ulps (RoPE's cos/sin), which can move a scale by ulps
    without moving a code."""
    for li, (path, inst, _) in enumerate(tdec.layer_paths(TCFG)):
        seg, name = path.split("/")
        for key, t in tpools[li].items():
            j = np.asarray(jpools[seg][name][key])
            j = j[inst] if name.startswith("pos") else j
            if t.element_size() == 1:
                np.testing.assert_array_equal(_bits(t)[:-1], _bits(j)[:-1],
                                              err_msg=f"{what} layer {li} {key}")
            else:
                np.testing.assert_allclose(t.numpy()[:-1], j[:-1], **TOL,
                                           err_msg=f"{what} layer {li} {key}")


@pytest.fixture(scope="module")
def round_inputs(params):
    """Block tables, tokens, and per-slot compacted FF (each slot's own
    selection, from the statistics of its own random prompt)."""
    jp, tp = params["scaled"]
    rng = np.random.default_rng(7)
    B = len(POS)
    bt = np.full((B, 4), -1, np.int32)
    perm, c = rng.permutation(P), 0
    for b in range(B):
        need = -(-(int(POS[b]) + SPEC_K + 1) // PAGE)
        bt[b, :need] = perm[c : c + need]
        c += need
    token = rng.integers(0, CFG.vocab_size, size=(B, 1)).astype(np.int32)
    chunk = rng.integers(0, CFG.vocab_size, size=(B, 16)).astype(np.int32)
    scratch = jdec.init_paged_pools(CFG, 2 * B + 1, PAGE)
    _, _, st = jdec.decode_step_paged(
        jax.tree.map(jnp.asarray, jp), CFG, scratch,
        jnp.asarray(np.arange(2 * B, dtype=np.int32).reshape(B, 2)),
        jnp.asarray(chunk), jnp.zeros((B,), jnp.int32), collect_stats=True)
    st = jdec.prune_stats_tree(st, CFG)
    ffn = jdec.extract_ffn_tree(jax.tree.map(jnp.asarray, jp), CFG)
    per_slot = []
    for b in range(B):
        sb = jax.tree.map(lambda a: a[:, b : b + 1], {
            seg: {n: {"s_sq": leaf["s_sq"]} for n, leaf in d.items()}
            for seg, d in st.items()})
        pj, _ = jg.select_and_compact(sb, ffn, _gj())
        per_slot.append(jax.tree.map(np.asarray, pj))
    pruned_j = jax.tree.map(lambda *a: jnp.stack(a, axis=1), *per_slot)
    slots_t = [bridge.tree_from_jax(pj, TCFG, "cpu") for pj in per_slot]
    pruned_t = {li: {k: torch.stack([s[li][k] for s in slots_t])
                     for k in slots_t[0][li]} for li in slots_t[0]}
    return dict(bt=bt, token=token, pruned_j=pruned_j, pruned_t=pruned_t)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_round(jpj, r, host, jargs, kvd):
    """The reference's draft loop, then its standalone verify on the
    drafts, and its fused round, each from the same pools."""
    jd, jpools = jdec.draft_loop_paged(
        jpj, CFG, _jax_pools(host), *jargs, r["pruned_j"], num_steps=SPEC_K,
        backend="gather", kv_dtype=kvd)
    vt = np.zeros((3, SPEC_K + 1), np.int32)
    vt[:, 0] = r["token"][:, 0]
    vt[:, 1:] = np.asarray(jd)
    vm = LIVE[:, None] & (np.arange(SPEC_K + 1)[None] <= K_R[:, None])
    jl, jpools = jdec.verify_step_paged(
        jpj, CFG, jpools, jnp.asarray(r["bt"]), jnp.asarray(vt),
        jnp.asarray(POS), jnp.asarray(vm), backend="gather", kv_dtype=kvd)
    # the fused round from the same pools
    jd2, jl2, jpools2 = jdec.draft_verify_paged(
        jpj, CFG, _jax_pools(host), *jargs, jnp.asarray(LIVE), r["pruned_j"],
        num_steps=SPEC_K, spec_k=SPEC_K, backend="gather", kv_dtype=kvd)
    return jd, jl, jpools, jd2, jl2, jpools2, vt, vm


@pytest.mark.parametrize("kvd", ["fp32", "int8", "fp8"])
def test_draft_verify_matches_jax(params, round_inputs, kvd):
    jp, tp = params["scaled"]
    jpj = jax.tree.map(jnp.asarray, jp)
    r = round_inputs
    host = _pools(np.random.default_rng(8), kvd)
    jargs = (jnp.asarray(r["bt"]), jnp.asarray(r["token"]), jnp.asarray(POS),
             jnp.asarray(K_R))
    targs = (_t(r["bt"]), _t(r["token"]), _t(POS), _t(K_R))

    def fresh():
        return [{k: v.clone() for k, v in layer.items()} for layer in host]

    jd, jl, jpools, jd2, jl2, jpools2, vt, vm = _jax_round(jpj, r, host,
                                                           jargs, kvd)
    for backend in ("gather", "fused"):
        what = f"{kvd} {backend}"
        tpools = fresh()
        td, tpools = tdec.draft_loop_paged(
            tp, TCFG, tpools, *targs, r["pruned_t"], num_steps=SPEC_K,
            backend=backend, kv_dtype=kvd)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd), err_msg=what)
        tl, tpools = tdec.verify_step_paged(
            tp, TCFG, tpools, _t(r["bt"]), _t(vt), _t(POS), _t(vm),
            backend=backend, kv_dtype=kvd)
        np.testing.assert_allclose(tl.numpy()[vm], np.asarray(jl)[vm],
                                   **TOL, err_msg=what)
        _assert_pools(tpools, jpools, what)

        tpools = fresh()
        td2, tl2, tpools = tdec.draft_verify_paged(
            tp, TCFG, tpools, *targs, _t(LIVE), r["pruned_t"],
            num_steps=SPEC_K, spec_k=SPEC_K, backend=backend, kv_dtype=kvd)
        np.testing.assert_array_equal(td2.numpy(), np.asarray(jd2), err_msg=what)
        np.testing.assert_allclose(tl2.numpy()[vm], np.asarray(jl2)[vm],
                                   **TOL, err_msg=what)
        _assert_pools(tpools, jpools2, what + " fused round")
    assert len(set(np.asarray(jd)[[0, 2]].ravel().tolist())) > 1  # not degenerate


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _logits_for(tokens, V=8, lo=-4.0, hi=4.0):
    out = np.full((len(tokens), V), lo, np.float32)
    for i, t in enumerate(tokens):
        out[i, t] = hi
    return out


@pytest.mark.parametrize("draft,target", [
    ([3, 1, 4], [3, 1, 4, 2]),   # all accepted, bonus
    ([3, 1, 4], [3, 7, 6, 2]),   # first mismatch at 1
    ([5], [0, 1]),               # immediate rejection
    ([], [6]),                   # nothing drafted: one dense token
])
def test_greedy_verify_matches_jax(draft, target):
    logits = _logits_for(target)
    logits[0, 7] = logits[0, target[0]]  # a tie: the first maximum wins
    assert sampling.greedy_verify(logits, draft) == \
        jsampling.greedy_verify(logits, draft)


def test_speculative_verify_matches_jax_draw_for_draw():
    rng = np.random.default_rng(0)
    V, k = 16, 4
    for trial in range(200):
        target = rng.normal(size=(k + 1, V)).astype(np.float32) * 2
        draft_l = rng.normal(size=(k, V)).astype(np.float32) * 2
        if trial % 3 == 0:
            draft_l = target[:k].copy()  # p == q: accept everything
        draft = rng.integers(0, V, size=k).tolist()
        temp = (1.0, 0.7, 1.5)[trial % 3]
        got = sampling.speculative_verify(
            target, draft_l, draft, np.random.default_rng(trial), temp)
        want = jsampling.speculative_verify(
            target, draft_l, draft, np.random.default_rng(trial), temp)
        assert got == want, trial


def test_sample_greedy_and_top1_exact():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(6, 50)).astype(np.float32)
    logits[2, 10] = logits[2, 40] = logits[2].max() + 1  # tie: first wins
    want = np.asarray(jsampling.sample(jnp.asarray(logits), None,
                                       jsampling.SamplingConfig()))
    got = sampling.sample(_t(logits), None, sampling.SamplingConfig())
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and int(got[2]) == 10
    gen = torch.Generator().manual_seed(0)
    sc = sampling.SamplingConfig(temperature=0.8, top_k=1)
    want = np.asarray(jsampling.sample(
        jnp.asarray(np.delete(logits, 2, 0)), jax.random.PRNGKey(0),
        jsampling.SamplingConfig(temperature=0.8, top_k=1)))
    for _ in range(5):
        got = sampling.sample(_t(np.delete(logits, 2, 0)), gen, sc)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sc", [
    dict(temperature=0.7),
    dict(temperature=1.0, top_k=3),
    dict(temperature=1.3, top_p=0.6),
])
def test_sample_distribution(sc):
    """Empirical token frequencies over many draws against the tempered,
    truncated softmax the reference samples from."""
    logits = np.log(np.array([0.35, 0.25, 0.15, 0.1, 0.08, 0.07]))
    x = logits / sc["temperature"]
    if sc.get("top_k"):
        x = np.where(x >= np.sort(x)[-sc["top_k"]], x, -np.inf)
    if sc.get("top_p"):
        srt = np.sort(x)[::-1]
        cum = np.cumsum(np.exp(srt - srt.max()) / np.exp(srt - srt.max()).sum())
        x = np.where(x >= srt[int((cum < sc["top_p"]).sum())], x, -np.inf)
    want = np.exp(x - x.max())
    want /= want.sum()
    n = 20000
    gen = torch.Generator().manual_seed(3)
    draws = sampling.sample(_t(np.tile(logits, (n, 1)).astype(np.float32)),
                            gen, sampling.SamplingConfig(**sc))
    emp = np.bincount(draws.numpy(), minlength=6) / n
    np.testing.assert_allclose(emp, want, atol=0.015)
    assert (emp[want == 0] == 0).all()
    # the reference's draws, from its own generator, land on the same law
    jd = np.asarray(jsampling.sample(
        jnp.asarray(np.tile(logits, (n, 1)).astype(np.float32)),
        jax.random.PRNGKey(3), jsampling.SamplingConfig(**sc)))
    np.testing.assert_allclose(np.bincount(jd, minlength=6) / n, want, atol=0.015)


# ---------------------------------------------------------------------------
# the spec server
# ---------------------------------------------------------------------------

def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _head_prompts():
    rng = np.random.default_rng(31)
    head = rng.integers(0, CFG.vocab_size, size=16).astype(np.int32)
    return [np.concatenate([head, rng.integers(0, CFG.vocab_size, size=8)
                            .astype(np.int32)]) for _ in range(3)]


def _capped_schedule():
    p0, p1 = _prompts(41, (12, 40))
    return [([(p0, 10)], 1), ([(p1, 10)], None)]


# name -> (server kwargs, spec kwargs, schedule: [(requests, steps after
# submitting them; None = drain)], checks on the port's summary)
SPEC_TRACES = {
    "basic": (dict(page_size=8, num_pages=48, n_slots=3, prefill_chunk=16,
                   max_len=64), dict(spec_k=3),
              [([(p, 10) for p in _prompts(11, (9, 21, 14))], None)],
              {"spec_rounds": (">", 0)}),
    "vanilla_fallback": (dict(page_size=8, num_pages=24, n_slots=3,
                              prefill_chunk=16, max_len=48), dict(spec_k=4),
                         [([(p, 2) for p in _prompts(13, (16, 16, 16))], None)],
                         {"spec_rounds": ("==", 0)}),
    "oversized_spec_k": (dict(page_size=8, num_pages=24, n_slots=2,
                              prefill_chunk=16, max_len=48), dict(spec_k=40),
                         [([(p, 8) for p in _prompts(15, (16, 16))], None)],
                         {"spec_rounds": (">", 0)}),
    "preemption": (dict(page_size=8, num_pages=8, n_slots=3, prefill_chunk=16,
                        max_len=64), dict(spec_k=4),
                   [([(p, 12) for p in _prompts(14, (24, 24, 24))], None)],
                   {"preemptions": (">", 0), "spec_rounds": (">", 0)}),
    "adaptive_preempt_prefix": (dict(page_size=8, num_pages=8, n_slots=3,
                                     prefill_chunk=16, max_len=64),
                                dict(spec_k=4, adaptive_spec=True),
                                [([(p, 12) for p in _head_prompts()], None)],
                                {"preemptions": (">", 0),
                                 "prefix_hit_rate": (">", 0.0),
                                 "spec_rounds": (">", 0)}),
    "capped_prefill": (dict(page_size=8, num_pages=48, n_slots=2,
                            prefill_chunk=16, max_len=64, prefix_cache=False),
                       dict(spec_k=4, adaptive_spec=False, spec_prefill_cap=1),
                       _capped_schedule(),
                       {"spec_capped_rounds": (">", 2)}),
}


def _drive(srv, schedule):
    rid = 0
    for reqs, steps in schedule:
        for prompt, max_new in reqs:
            srv.submit(prompt, max_new, rid=rid)
            rid += 1
        if steps is None:
            srv.drain()
        else:
            for _ in range(steps):
                srv.step()
    return {r: q.generated for r, q in srv.sched.finished.items()
            if not q.aborted}


_JAX_RUNS = {}


def _jax_spec(params, trace, kvd="fp32"):
    """The JAX spec server's streams and summary (each run once)."""
    key = (trace, kvd)
    if key not in _JAX_RUNS:
        jp, _ = params["scaled"]
        kw, spec, schedule, _ = SPEC_TRACES[trace]
        srv = JaxServer(CFG, jax.tree.map(jnp.asarray, jp), gcfg=_gj(),
                        kv_dtype=kvd, **kw, **spec)
        _JAX_RUNS[key] = (_drive(srv, schedule), srv.metrics.summary())
    return _JAX_RUNS[key]


def _port(params, trace, gcfg, kvd="fp32", **extra):
    _, tp = params["scaled"]
    kw, spec, schedule, _ = SPEC_TRACES[trace]
    if gcfg is None:
        spec = {}
    srv = PagedServer(TCFG, tp, gcfg=gcfg, device="cpu", kv_dtype=kvd, **kw,
                      **spec, **extra)
    # the dense server's top-2 margins tell a near-tie from a fault
    margins = _record_margins(srv) if gcfg is None else None
    return srv, _drive(srv, schedule), margins


def _assert_streams(got, want, margins, what):
    assert sorted(got) == sorted(want), what
    for rid in want:
        if got[rid] != want[rid]:
            i = next(i for i, (a, b) in enumerate(zip(got[rid], want[rid]))
                     if a != b)
            pytest.fail(f"{what}: rid {rid} differs at token {i}: "
                        f"{got[rid]} vs {want[rid]}; dense top-2 margin "
                        f"there {margins[rid][i]:.3g}")


def _assert_clean(srv):
    srv.sched.alloc.check()
    srv.sched.flush_prefix()
    assert srv.sched.alloc.num_in_use == 0


@pytest.mark.parametrize("trace", sorted(SPEC_TRACES))
def test_spec_server_matches_jax_and_dense(params, trace):
    want, sj = _jax_spec(params, trace)
    _, dense, margins = _port(params, trace, None)
    srv, got, _ = _port(params, trace, _gt())
    _assert_streams(dense, want, margins, f"{trace}: dense port vs jax spec")
    _assert_streams(got, want, margins, f"{trace}: port spec vs jax spec")
    st = srv.metrics.summary()
    for key in SPEC_KEYS + ("generated_tokens", "preemptions", "steps"):
        assert st[key] == sj[key], key
    for key, (op, v) in SPEC_TRACES[trace][3].items():
        assert (st[key] > v) if op == ">" else (st[key] == v), (key, st[key])
    assert len({t for s in got.values() for t in s}) > 4  # not degenerate
    _assert_clean(srv)


@pytest.mark.parametrize("backend", ["gather", "fused"])
@pytest.mark.parametrize("trace", ["basic", "preemption"])
def test_spec_fused_round_equals_per_token(params, trace, backend):
    """The one-call round against the host loop it replaced, for streams
    and for the acceptance bookkeeping."""
    outs, sums = {}, {}
    for impl in ("fused", "per_token"):
        srv, outs[impl], _ = _port(params, trace, _gt(), spec_impl=impl,
                                   kernel_backend=backend)
        sums[impl] = srv.metrics.summary()
        _assert_clean(srv)
    assert outs["fused"] == outs["per_token"]
    for key in SPEC_KEYS:
        assert sums["fused"][key] == sums["per_token"][key], key
    assert sums["fused"]["spec_rounds"] > 0


@pytest.mark.parametrize("kvd,trace", [("int8", "basic"), ("fp8", "basic"),
                                       ("int8", "preemption")])
def test_spec_server_quantized_matches_jax(params, kvd, trace):
    want, sj = _jax_spec(params, trace, kvd)
    srv, got, _ = _port(params, trace, _gt(), kvd=kvd)
    _, dense, margins = _port(params, trace, None, kvd=kvd)
    assert srv.pools[0]["k"].dtype == tq.pool_torch_dtype(kvd, "float32")
    _assert_streams(got, want, margins, f"{kvd} {trace}: port spec vs jax spec")
    st = srv.metrics.summary()
    for key in SPEC_KEYS + ("generated_tokens", "attn_bytes_per_token"):
        assert st[key] == sj[key], key
    _assert_clean(srv)


def test_spec_fp8_drafts_leave_dense_like_jax():
    """With quantized pools a draft row can grow its page's scale, which
    the dense verify keeps, so a spec server need not commit the dense
    stream.  On ``chip_smoke.py`` phase 7a's trace (tinylm drawn by the
    port from seed 0, projections scaled by 2) the fp8 spec server leaves
    the dense stream, and the JAX spec server commits the same tokens as
    the port: the reference's semantics, kept on purpose."""
    tp = tdec.init_params(TCFG, seed=0, device="cpu")
    for lp in tp["layers"]:
        for group in ("mixer", "ffn"):
            for k, v in lp[group].items():
                if k.startswith("w"):
                    v.mul_(2.0)
    to_np = lambda t: {k: to_np(v) for k, v in t.items()} \
        if isinstance(t, dict) else t.numpy()  # noqa: E731
    jp = {"embed": to_np(tp["embed"]), "final_norm": to_np(tp["final_norm"])}
    jp.update(_jax_tree([to_np(layer) for layer in tp["layers"]]))
    rng = np.random.default_rng(3)
    shared = rng.integers(0, CFG.vocab_size, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, CFG.vocab_size, n)
                               .astype(np.int32)]) for n in (5, 14)]
    prompts += [rng.integers(0, CFG.vocab_size, n).astype(np.int32)
                for n in (11, 27)]
    kw = dict(page_size=8, num_pages=24, n_slots=2, prefill_chunk=16,
              max_len=64, kv_dtype="fp8")
    schedule = [([(p, 12) for p in prompts], None)]
    js = JaxServer(CFG, jax.tree.map(jnp.asarray, jp), gcfg=_gj(), spec_k=3,
                   **kw)
    srv = PagedServer(TCFG, tp, gcfg=_gt(), spec_k=3, device="cpu", **kw)
    dense = PagedServer(TCFG, tp, gcfg=None, device="cpu", **kw)
    got = _drive(srv, schedule)
    assert got == _drive(js, schedule)
    assert got != _drive(dense, schedule)


def test_spec_needs_gcfg(params):
    _, tp = params["plain"]
    with pytest.raises(ValueError, match="spec_k"):
        PagedServer(TCFG, tp, gcfg=None, spec_k=4, device="cpu")


def test_bad_spec_impl_rejected(params):
    _, tp = params["plain"]
    with pytest.raises(ValueError, match="spec_impl"):
        PagedServer(TCFG, tp, gcfg=_gt(), spec_k=2, spec_impl="turbo",
                    device="cpu")
