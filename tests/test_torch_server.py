"""The port's serving slice on the CPU, held against the JAX package.

* ``decode_step_paged`` logits (and the streamed GRIFFIN statistics) of
  the port equal the reference's within 1e-5 at fp32, for a prefill
  chunk with ``collect_stats`` and for a decode on compacted FF weights.
* ``PagedServer`` token streams are identical to the JAX ``PagedServer``
  on traces that exercise GRIFFIN at 0.5, a shared prefix with
  copy-on-write, a starved pool with preemption (before and after
  compaction), and mixed tiers.  The parameters are tinylm's
  ``PRNGKey(0)`` draw with the projection matrices scaled by 2 (the
  unscaled draw repeats one token per prompt, which would make stream
  identity a weak check); both servers get the same tree.  When a stream
  differs the assertion reports the port's top-2 logit margin at the
  first differing token, so a true near-tie is told apart from a bug.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core import griffin as jg  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serving.server import PagedServer as JaxServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import griffin as tg  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serving.server import PagedServer  # noqa: E402

CFG = get_config("tinylm")
TCFG = tget("tinylm")
TOL = dict(rtol=1e-5, atol=1e-5)
_MATS = ("wq", "wk", "wv", "wo", "w1", "wg", "w2")


def _scaled(tree, s):
    return {k: _scaled(v, s) if isinstance(v, dict)
            else (v * s if k in _MATS else v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def params():
    jp = jax.tree.map(np.asarray, jdec.init_params(CFG, jax.random.PRNGKey(0)))
    js = _scaled(jp, np.float32(2.0))
    return {"plain": (jp, bridge.params_from_jax(jp, TCFG, "cpu")),
            "scaled": (js, bridge.params_from_jax(js, TCFG, "cpu"))}


# ---------------------------------------------------------------------------
# decode_step_paged
# ---------------------------------------------------------------------------

def test_decode_step_paged_matches_jax(params):
    jp, tp = params["plain"]
    rng = np.random.default_rng(0)
    page, num_pages, chunk = 8, 12, 16
    jpools = jdec.init_paged_pools(CFG, num_pages, page)
    tpools = tdec.init_paged_pools(TCFG, num_pages, page, device="cpu")
    # prefill chunk: 13 real tokens + 3 padded, with the statistics
    toks = np.zeros((1, chunk), np.int32)
    toks[0, :13] = rng.integers(0, CFG.vocab_size, 13)
    mask = np.zeros((1, chunk), bool)
    mask[0, :13] = True
    bt = np.array([[3, 7, -1, -1]], np.int32)
    pos = np.array([0], np.int32)
    lj, jpools, sj = jdec.decode_step_paged(
        jp, CFG, jpools, jnp.asarray(bt), jnp.asarray(toks), jnp.asarray(pos),
        write_mask=jnp.asarray(mask), collect_stats=True)
    lt, tpools, st = tdec.decode_step_paged(
        tp, TCFG, tpools, torch.from_numpy(bt), torch.from_numpy(toks),
        torch.from_numpy(pos), write_mask=torch.from_numpy(mask),
        collect_stats=True)
    np.testing.assert_allclose(lt.numpy()[:, :13], np.asarray(lj)[:, :13], **TOL)
    sj = jax.tree.map(np.asarray, jdec.prune_stats_tree(sj, CFG))
    sj_t = bridge.tree_from_jax(sj, TCFG, "cpu")
    st = tdec.prune_stats_tree(st, TCFG)
    assert sorted(st) == sorted(sj_t)
    for li in st:
        for k in ("s_sq", "x_sq", "z_sq"):
            np.testing.assert_allclose(st[li][k].numpy(), sj_t[li][k].numpy(),
                                       rtol=1e-5, atol=1e-4)

    # decode on per-slot compacted weights selected from the JAX stats
    gj = jg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    pruned_j, _ = jg.select_and_compact(
        jax.tree.map(jnp.asarray, sj), jdec.extract_ffn_tree(jp, CFG), gj)
    pruned_t = {li: {k: v[None] for k, v in leaf.items()} for li, leaf in
                bridge.tree_from_jax(jax.tree.map(np.asarray, pruned_j),
                                     TCFG, "cpu").items()}
    pruned_jb = jax.tree.map(lambda a: jnp.expand_dims(a, 1), pruned_j)
    tok = np.array([[int(np.argmax(np.asarray(lj)[0, 12]))]], np.int32)
    pos = np.array([13], np.int32)
    mask = np.ones((1, 1), bool)
    lj, _, _ = jdec.decode_step_paged(
        jp, CFG, jpools, jnp.asarray(bt), jnp.asarray(tok), jnp.asarray(pos),
        write_mask=jnp.asarray(mask), pruned=pruned_jb)
    lt, _, _ = tdec.decode_step_paged(
        tp, TCFG, tpools, torch.from_numpy(bt), torch.from_numpy(tok),
        torch.from_numpy(pos), write_mask=torch.from_numpy(mask),
        pruned=pruned_t)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


# ---------------------------------------------------------------------------
# PagedServer token streams
# ---------------------------------------------------------------------------

def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, size=n).astype(np.int32)
            for n in lens]


def _shared_prefix_trace():
    rng = np.random.default_rng(22)
    prompt = rng.integers(0, CFG.vocab_size, size=20).astype(np.int32)
    diverge = np.concatenate(
        [prompt, rng.integers(0, CFG.vocab_size, size=9).astype(np.int32)])
    # drained one after another: donor, a hit that COWs the boundary
    # page, then the donor's prompt again
    return [[(prompt, 8, None)], [(diverge, 8, None)], [(prompt.copy(), 8, None)]]


def _mixed_tier_trace():
    rng = np.random.default_rng(9)
    shared = rng.integers(0, CFG.vocab_size, size=16).astype(np.int32)
    ps = [np.concatenate([shared, rng.integers(0, CFG.vocab_size, size=8)
                          .astype(np.int32)]),
          np.concatenate([shared, rng.integers(0, CFG.vocab_size, size=10)
                          .astype(np.int32)]),
          rng.integers(0, CFG.vocab_size, size=24).astype(np.int32),
          rng.integers(0, CFG.vocab_size, size=19).astype(np.int32)]
    return [[(p, 8, t) for p, t in zip(ps, (0.25, 0.5, 1.0, None))]]


# name -> (server kwargs, drains: [[(prompt, max_new, tier)]], checks)
TRACES = {
    "griffin": (dict(page_size=8, num_pages=32, n_slots=2, prefill_chunk=16,
                     max_len=64),
                [[(p, 8, None) for p in _prompts(3, (11, 25, 18))]], {}),
    "shared_prefix_cow": (dict(page_size=8, num_pages=48, n_slots=2,
                               prefill_chunk=16, max_len=64),
                          _shared_prefix_trace(),
                          {"cow_copies": 1, "prefix_hits": 1}),
    "starved_pool": (dict(page_size=8, num_pages=10, n_slots=3,
                          prefill_chunk=16, max_len=64),
                     [[(p, 10, None) for p in _prompts(4, (24, 24, 24))]],
                     {"preemptions": 1}),
    "mid_decode_preemption": (dict(page_size=8, num_pages=8, n_slots=2,
                                   prefill_chunk=16, max_len=40),
                              [[(p, 16, None) for p in _prompts(5, (20, 20))]],
                              {"preemptions": 1}),
    "mixed_tiers": (dict(page_size=8, num_pages=32, n_slots=3,
                         prefill_chunk=16, max_len=64, default_tier=0.75),
                    _mixed_tier_trace(), {"prefix_hits": 1}),
}


def _record_margins(srv):
    """Top-2 logit margin of every token the port server commits."""
    margins = {}
    last = {}
    step_model = srv._step_model
    finish_decode = srv.sched.finish_decode_token
    finish_prefill = srv.sched.finish_prefill_chunk

    def margin(row):
        top = torch.topk(row, 2).values
        return float(top[0] - top[1])

    def step(bt, toks, pos, mask, pruned, collect=False):
        out = step_model(bt, toks, pos, mask, pruned, collect)
        for s in np.nonzero(mask.any(axis=1))[0]:
            last[int(s)] = out[0][s, int(mask[s].sum()) - 1]
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


def _serve(server_cls, cfg, params, gcfg, kw, drains, **extra):
    srv = server_cls(cfg, params, gcfg=gcfg, **kw, **extra)
    margins = _record_margins(srv) if server_cls is PagedServer else None
    out, rid = {}, 0
    for batch in drains:
        for prompt, max_new, tier in batch:
            srv.submit(prompt, max_new, rid=rid, tier=tier)
            rid += 1
        out.update(srv.drain())
    return srv, out, margins


@pytest.mark.parametrize("trace", sorted(TRACES))
def test_server_streams_match_jax(params, trace):
    jp, tp = params["scaled"]
    kw, drains, checks = TRACES[trace]
    gj = jg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    gt = tg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    js, want, _ = _serve(JaxServer, CFG, jax.tree.map(jnp.asarray, jp), gj,
                         kw, drains)
    ts, got, margins = _serve(PagedServer, TCFG, tp, gt, kw, drains,
                              device="cpu")
    assert sorted(got) == sorted(want)
    for rid in want:
        if got[rid] != want[rid]:
            i = next(i for i, (a, b) in enumerate(zip(got[rid], want[rid]))
                     if a != b)
            pytest.fail(f"{trace}: rid {rid} differs at token {i}: port "
                        f"{got[rid]} vs jax {want[rid]}; port top-2 margin "
                        f"there {margins[rid][i]:.3g}")
    assert len(set(t for s in got.values() for t in s)) > 4  # not degenerate
    sj, st = js.metrics.summary(), ts.metrics.summary()
    for key in ("preemptions", "cow_copies", "saved_prefill_tokens",
                "generated_tokens", "prefill_chunks", "steps",
                "attn_bytes_read_total"):
        assert st[key] == sj[key], key
    assert ts.metrics.prefix_hits == js.metrics.prefix_hits
    for key, least in checks.items():
        v = ts.metrics.prefix_hits if key == "prefix_hits" else st[key]
        assert v >= least, (key, v)
    ts.sched.alloc.check()


def test_server_tracer_and_tier_dense(params):
    """Spans are recorded and tier 1.0 decodes exactly like no GRIFFIN."""
    _, tp = params["scaled"]
    kw, drains, _ = TRACES["griffin"]
    tr = Tracer()
    _, dense, _ = _serve(PagedServer, TCFG, tp, None, kw, drains, device="cpu")
    ts = PagedServer(TCFG, tp, gcfg=tg.GriffinConfig(sparsity=0.5), **kw,
                     device="cpu", tracer=tr, default_tier=1.0)
    for i, (p, n, _) in enumerate(drains[0]):
        ts.submit(p, n, rid=i)
    assert ts.drain() == dense
    names = {e["name"] for e in tr.events}
    assert {"tick", "plan", "prefill_chunk", "decode"} <= names


@pytest.mark.parametrize("kw", [dict(mesh=object())])
def test_server_rejects_later_slices(params, kw):
    _, tp = params["plain"]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedServer(TCFG, tp, gcfg=tg.GriffinConfig(), device="cpu", **kw)


def test_server_bf16_pools_run(params):
    """kv_dtype='bf16' on an fp32 model: pools hold bf16, both backends
    agree token for token."""
    _, tp = params["scaled"]
    kw, drains, _ = TRACES["griffin"]
    outs = []
    for backend in ("gather", "fused"):
        srv, out, _ = _serve(PagedServer, TCFG, tp, tg.GriffinConfig(sparsity=0.5),
                             kw, drains, device="cpu", kv_dtype="bf16",
                             kernel_backend=backend)
        assert srv.pools[0]["k"].dtype == torch.bfloat16
        outs.append(out)
    assert outs[0] == outs[1]
