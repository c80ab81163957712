"""The port's serving edge on the CPU, held against the JAX package.

* **Host-only parity** — ``ServingFrontend`` over ``SimServer`` on a
  ``FakeClock``: the same scripted trace (SLO classes, EDF order,
  deadline shedding, 429 back-pressure, cancels of pending and active
  requests) gives the same handle states, tokens, trace events,
  ``summary()`` and Prometheus text in both packages; so does a
  closed-loop ``loadgen`` run (Zipf system prompts, Poisson sessions,
  multi-turn chat) and the HTTP surface's raw responses
  (200/400/404/429 and an SSE stream).
* **SSE over the model** — ``handle_connection`` over the port's
  ``PagedServer(device="cpu")``: the SSE token streams equal a plain
  ``drain()`` of the same trace, and the JAX server's, with preemption
  and with a prefix warm start; a client disconnect mid-decode cancels
  the request, frees its pages and leaves the survivors' streams alone.
* **Flocking probe** — every pool and scale pool is bit-identical
  around a probe (fp32, int8, fp8; a probe that did not restore would
  change them), streams with ``flocking_every=2`` equal those with 0,
  and per-request Jaccard / angular distance and the gauge labels match
  the JAX server's.

The model parameters are tinylm's ``PRNGKey(0)`` draw with the
projection matrices scaled by 2, as in ``test_torch_server.py``.
"""
import asyncio
import importlib
import json
from types import SimpleNamespace

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
from repro_torch.kernels import kv_quant  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.obs.flocking import layer_names  # noqa: E402
from repro_torch.obs.registry import validate_prometheus_text  # noqa: E402
from repro_torch.serving.clock import FakeClock  # noqa: E402
from repro_torch.serving.frontend import (CANCELLED, FINISHED,  # noqa: E402
                                          ServingFrontend)
from repro_torch.serving.metrics import ServingMetrics  # noqa: E402
from repro_torch.serving.server import PagedServer  # noqa: E402

CFG = get_config("tinylm")
TCFG = tget("tinylm")
_MATS = ("wq", "wk", "wv", "wo", "w1", "wg", "w2")


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(
        clock=mod("serving.clock"), frontend=mod("serving.frontend"),
        sim=mod("serving.sim"), loadgen=mod("serving.loadgen"),
        metrics=mod("serving.metrics"), trace=mod("obs.trace"))


PKGS = {"jax": _pkg("repro"), "port": _pkg("repro_torch")}



@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """tinylm-size work gains nothing from many intra-op threads, and the
    suite runs several workers on one host: two threads per worker here
    keep this module from crowding the others off the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)

def _scaled(tree, s):
    return {k: _scaled(v, s) if isinstance(v, dict)
            else (v * s if k in _MATS else v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def params():
    jp = _scaled(jax.tree.map(np.asarray,
                              jdec.init_params(CFG, jax.random.PRNGKey(0))),
                 np.float32(2.0))
    return jax.tree.map(jnp.asarray, jp), bridge.params_from_jax(jp, TCFG, "cpu")


# ---------------------------------------------------------------------------
# host-only parity: SimServer frontend, loadgen, HTTP surface
# ---------------------------------------------------------------------------

def _sim_frontend(p, *, max_pending=4, **kw):
    clk = p.clock.FakeClock()
    tr = p.trace.Tracer(clock=clk)
    srv = p.sim.SimServer(metrics=p.metrics.ServingMetrics(clock=clk, tracer=tr),
                          **kw)
    return p.frontend.ServingFrontend(srv, max_pending=max_pending, clock=clk), \
        srv, clk, tr


def _sim_scenario(p):
    """SLO order, shedding, 429, cancels of a pending and an active
    request, all on the fake clock; returns everything observable."""
    fe, srv, clk, tr = _sim_frontend(p, num_pages=12, n_slots=2,
                                     page_size=4, max_pages_per_request=6)
    fe.queue_depth = 2
    rng = np.random.default_rng(5)
    prompt = lambda n: rng.integers(0, 500, n).astype(np.int32)  # noqa: E731
    hs, rejected = [], 0
    for slo, n, gen, dl in (("batch", 9, 6, None), ("interactive", 5, 4, None),
                            ("standard", 7, 5, 0.002), ("interactive", 3, 8, 0.02),
                            ("batch", 6, 3, None)):
        try:
            hs.append(fe.submit(prompt(n), gen, slo=slo, deadline_s=dl))
        except p.frontend.QueueFull:
            rejected += 1
    events = []
    for tick in range(60):
        if tick == 2:
            hs[-1].cancel()  # still pending
        if tick == 4:
            hs[1].cancel()  # active
        if tick == 6:
            hs.append(fe.submit(prompt(4), 5, slo="interactive", tier=None))
        more = fe.tick()
        events.append((tick, [h.state for h in hs], len(fe._pending)))
        clk.advance(0.003)
        if not more and tick > 6:
            break
    srv.sched.alloc.check()
    return dict(rejected=rejected, events=events,
                handles=[(h.rid, h.state, h.finish_reason, tuple(h.tokens),
                          h.slo_met) for h in hs],
                summary=fe.summary(), engine=srv.metrics.summary(),
                trace=tr.events, prom=srv.metrics.prometheus_text(),
                in_use=srv.sched.alloc.num_in_use)


def test_sim_frontend_matches_jax():
    got, want = _sim_scenario(PKGS["port"]), _sim_scenario(PKGS["jax"])
    assert got == want
    states = {s for _, s, *_ in got["handles"]}
    # the scenario really sheds, cancels, rejects and finishes
    assert {FINISHED, CANCELLED, "shed"} <= states, states
    assert got["rejected"] == 1 and got["in_use"] == 0
    assert validate_prometheus_text(got["prom"]) == []


def _loadgen_run(p):
    fe, srv, clk, tr = _sim_frontend(p, max_pending=6, num_pages=48,
                                     n_slots=3, page_size=8,
                                     max_pages_per_request=16,
                                     prefix_cache=True)
    sessions = p.loadgen.chat_sessions(10, rate=40.0, seed=4, vocab=600,
                                       n_system=3, system_len=20, max_turns=3,
                                       gen_cap=12)
    res = p.loadgen.run_closed_loop(fe, sessions, clock=clk,
                                    advance=clk.advance, tick_s=0.004)
    turns = [(t.sid, t.turn, t.slo, t.state, t.prompt, t.max_new, t.tokens,
              t.ttft, t.slo_met) for t in res.turns]
    return dict(summary=res.summary(), turns=turns,
                truncated=res.truncated_sessions, fe=fe.summary(),
                engine=srv.metrics.summary(), trace=tr.events,
                pairs=res.identity_pairs(), in_use=srv.sched.alloc.num_in_use,
                prefix_hits=srv.metrics.prefix_hits)


def test_loadgen_fake_clock_matches_jax():
    got, want = _loadgen_run(PKGS["port"]), _loadgen_run(PKGS["jax"])
    assert got == want
    assert got["summary"]["finished"] >= 10 and got["prefix_hits"] > 0
    # deterministic: a replay gives the same log
    assert _loadgen_run(PKGS["port"])["trace"] == got["trace"]


class _MemWriter:
    """Capture-only StreamWriter stand-in for handler tests."""

    def __init__(self):
        self.buf = bytearray()
        self.closed = False

    def write(self, b: bytes) -> None:
        self.buf.extend(b)

    async def drain(self) -> None:
        pass

    def can_write_eof(self) -> bool:
        return False

    def close(self) -> None:
        self.closed = True


def _post(path: str, obj) -> bytes:
    body = json.dumps(obj).encode()
    return (f"POST {path} HTTP/1.1\r\nContent-Length: {len(body)}\r\n"
            f"\r\n").encode() + body


def _parse_sse(raw: bytes):
    """-> (status_line, [(event_or_None, data_dict), ...])"""
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


async def _serve_conns(fe, clk, raws, *, start_ticks=None, eof_at=None,
                       max_ticks=3000):
    """Run one ``handle_connection`` per raw request (the i-th starting at
    tick ``start_ticks[i]``) while ticking the frontend by hand; ``eof_at``
    = (i, tick): the i-th client hangs up at that tick."""
    start_ticks = start_ticks or [0] * len(raws)
    writers = [_MemWriter() for _ in raws]
    readers, tasks = {}, {}
    tick = 0
    while len(tasks) < len(raws) or not all(t.done() for t in tasks.values()) \
            or fe.has_work:
        for i, raw in enumerate(raws):
            if i not in tasks and start_ticks[i] <= tick:
                readers[i] = asyncio.StreamReader()
                readers[i].feed_data(raw)
                tasks[i] = asyncio.ensure_future(
                    fe.handle_connection(readers[i], writers[i]))
                await asyncio.sleep(0)  # submit in start order
        if eof_at is not None and tick == eof_at[1]:
            readers[eof_at[0]].feed_eof()
        fe.tick()
        clk.advance(0.001)
        await asyncio.sleep(0)
        tick += 1
        assert tick < max_ticks
    for t in tasks.values():
        await t
    return [bytes(w.buf) for w in writers]


def _http_roundtrips(p):
    fe, srv, clk, _ = _sim_frontend(p, max_pending=2)
    raws = [b"GET /healthz HTTP/1.1\r\n\r\n",
            _post("/v1/generate", {"max_new": 4}),
            _post("/v1/generate", {"prompt": [1] * 1000, "max_new": 4}),
            b"GET /nope HTTP/1.1\r\n\r\n",
            _post("/v1/generate", {"prompt": [1, 2, 3], "max_new": 7,
                                   "slo": "interactive"})]

    async def run():
        outs = [(await _serve_conns(fe, clk, [r]))[0] for r in raws]
        for _ in range(2):  # fill the admission queue: the next is a 429
            fe.submit(np.asarray([1, 2], np.int32), 4)
        w = _MemWriter()
        reader = asyncio.StreamReader()
        reader.feed_data(_post("/v1/generate", {"prompt": [1, 2], "max_new": 4}))
        await fe.handle_connection(reader, w)
        outs.append(bytes(w.buf))
        fe.run_until_idle()
        outs.append((await _serve_conns(fe, clk, [b"GET /metrics HTTP/1.1\r\n\r\n"]))[0])
        return outs

    return asyncio.run(run())


def test_http_surface_matches_jax():
    got, want = _http_roundtrips(PKGS["port"]), _http_roundtrips(PKGS["jax"])
    assert got == want
    statuses = [r.split(b"\r\n")[0].decode() for r in got]
    assert statuses == ["HTTP/1.1 200 OK", "HTTP/1.1 400 Bad Request",
                        "HTTP/1.1 400 Bad Request", "HTTP/1.1 404 Not Found",
                        "HTTP/1.1 200 OK", "HTTP/1.1 429 Too Many Requests",
                        "HTTP/1.1 200 OK"]
    _, frames = _parse_sse(got[4])
    from repro_torch.serving.sim import sim_token
    rid = frames[0][1]["rid"]
    assert [d["token"] for _, d in frames[1:-1]] == [sim_token(rid, i)
                                                      for i in range(7)]
    assert frames[-1][0] == "done"
    body = got[-1].partition(b"\r\n\r\n")[2].decode()
    assert validate_prometheus_text(body) == []


# ---------------------------------------------------------------------------
# SSE over the port's PagedServer (mirrors tests/test_frontend_stream.py)
# ---------------------------------------------------------------------------

def _trace(shared_prefix: bool):
    rng = np.random.default_rng(7)
    sys_p = rng.integers(0, CFG.vocab_size, size=24).astype(np.int32)
    out = []
    for _ in range(5):
        tail = rng.integers(0, CFG.vocab_size,
                            size=int(rng.integers(4, 10))).astype(np.int32)
        if shared_prefix:
            out.append(np.concatenate([sys_p, tail]))
        else:
            out.append(rng.integers(0, CFG.vocab_size,
                                    size=int(rng.integers(12, 24))
                                    ).astype(np.int32))
    return list(zip(out, [8, 6, 10, 7, 9]))


def _server_kw(prefix, num_pages):
    return dict(page_size=8, num_pages=num_pages, n_slots=2, prefill_chunk=8,
                max_len=64, prefix_cache=prefix)


def _drain(cls, cfg, prm, gcfg, trace, **kw):
    srv = cls(cfg, prm, gcfg=gcfg, **kw)
    for i, (p, m) in enumerate(trace):
        srv.submit(p, m, rid=i)
    out = srv.drain()
    return {i: tuple(out[i]) for i in out}


@pytest.mark.parametrize("case", ["preemption", "prefix_warm_start"])
def test_sse_streams_equal_drain(params, case):
    jp, tp = params
    prefix = case == "prefix_warm_start"
    kw = _server_kw(prefix, 5 if case == "preemption" else 40)
    trace = _trace(prefix)
    gt = tg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    oracle = _drain(PagedServer, TCFG, tp, gt, trace, device="cpu", **kw)
    want = _drain(JaxServer, CFG, jp,
                  jg.GriffinConfig(sparsity=0.5, per_shard_topk=False), trace,
                  **kw)
    assert oracle == want
    clk = FakeClock()
    srv = PagedServer(TCFG, tp, gcfg=gt, device="cpu",
                      metrics=ServingMetrics(clock=clk), **kw)
    fe = ServingFrontend(srv, queue_depth=4, clock=clk)
    raws = [_post("/v1/generate", {"prompt": p.tolist(), "max_new": m,
                                   "slo": "batch"}) for p, m in trace]
    if prefix:
        # wave 2 re-uses wave 1's system prefix from the radix cache
        async def run():
            return (await _serve_conns(fe, clk, raws[:2])) \
                + (await _serve_conns(fe, clk, raws[2:]))
        outs = asyncio.run(run())
        assert srv.metrics.prefix_hits > 0
    else:
        # late arrivals join the running batch; the pool forces preemption
        outs = asyncio.run(_serve_conns(fe, clk, raws,
                                        start_ticks=[0, 0, 3, 5, 7]))
        assert srv.metrics.preemptions > 0
    for i, raw in enumerate(outs):
        status, frames = _parse_sse(raw)
        assert status == "HTTP/1.1 200 OK"
        assert frames[0] == ("accepted", {"rid": i, "slo": "batch"})
        assert tuple(d["token"] for _, d in frames[1:-1]) == oracle[i], i
        assert frames[-1][0] == "done"
    srv.sched.alloc.check()


def test_sse_disconnect_cancels_and_frees_pages(params):
    _, tp = params
    kw = _server_kw(False, 40)
    trace = _trace(False)
    gt = tg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    oracle = _drain(PagedServer, TCFG, tp, gt, trace, device="cpu", **kw)
    clk = FakeClock()
    srv = PagedServer(TCFG, tp, gcfg=gt, device="cpu",
                      metrics=ServingMetrics(clock=clk), flocking_every=2, **kw)
    fe = ServingFrontend(srv, queue_depth=4, clock=clk)
    raws = [_post("/v1/generate", {"prompt": p.tolist(), "max_new": m})
            for p, m in trace]
    outs = asyncio.run(_serve_conns(fe, clk, raws, eof_at=(2, 12)))
    h = fe.handles[2]
    assert h.state == CANCELLED and 0 < len(h.tokens) < trace[2][1]
    assert srv.metrics.cancelled_aborts == 1
    assert srv.metrics.cancel_latency.count == 1
    assert 2 not in srv.flocking.live_rids()  # cancel ended its telemetry
    # finished and cancelled requests hold no compacted FF copy
    assert all(r.pruned_host is None for r in srv.sched.finished.values())
    assert srv._compacted == {}
    srv.sched.alloc.check()
    assert srv.sched.alloc.num_in_use == 0
    for i, raw in enumerate(outs):
        if i == 2:
            continue
        _, frames = _parse_sse(raw)
        assert tuple(d["token"] for _, d in frames[1:-1]) == oracle[i], i


@pytest.mark.parametrize("backend", ["fused", "gather"])
def test_block_table_width_per_backend(params, backend):
    """The fused kernel's split plan follows the table width, so the
    fused backend gets every table at full width and a request's stream
    cannot depend on who shares its ticks; the gather path narrows to the
    batch.  Streams served together equal those served one at a time."""
    _, tp = params
    trace = _trace(False)
    gt = tg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    kw = dict(_server_kw(False, 40), kernel_backend=backend)
    srv = PagedServer(TCFG, tp, gcfg=gt, device="cpu", **kw)
    widths = set()
    step_model = srv._step_model

    def recorded(bt, *a, **k):
        widths.add(bt.shape[1])
        return step_model(bt, *a, **k)

    srv._step_model = recorded
    for i, (p, m) in enumerate(trace):
        srv.submit(p, m, rid=i)
    together = {i: tuple(v) for i, v in srv.drain().items()}
    full = srv.pcfg.max_pages_per_request
    assert widths == {full} if backend == "fused" else full not in widths
    alone = {i: _drain(PagedServer, TCFG, tp, gt, [(p, m)], device="cpu",
                       **kw)[0] for i, (p, m) in enumerate(trace)}
    assert together == alone


def test_reset_metrics_keeps_serving_state(params):
    _, tp = params
    trace = _trace(True)
    srv = PagedServer(TCFG, tp, gcfg=tg.GriffinConfig(sparsity=0.5),
                      device="cpu", flocking_every=2, **_server_kw(True, 40))
    for i, (p, m) in enumerate(trace[:2]):
        srv.submit(p, m, rid=i)
    srv.drain()
    old = srv.metrics
    fresh = srv.reset_metrics()
    assert fresh is srv.metrics and fresh is not old
    assert srv.flocking.registry is fresh.registry
    assert fresh.summary()["generated_tokens"] == 0
    srv.submit(*trace[2], rid=2)
    srv.drain()
    assert fresh.prefix_hits == 1  # the prefix cache survived the reset
    srv.submit(*trace[3], rid=3)
    with pytest.raises(RuntimeError):
        srv.reset_metrics()


# ---------------------------------------------------------------------------
# flocking telemetry
# ---------------------------------------------------------------------------

def _flock_trace():
    rng = np.random.default_rng(19)
    return [(rng.integers(0, CFG.vocab_size, n).astype(np.int32), 10)
            for n in (13, 22, 17)]


FLOCK_KW = dict(page_size=8, num_pages=48, n_slots=2, prefill_chunk=16,
                max_len=96)


def _pool_bits(pools):
    return [{k: kv_quant.as_bytes(v).clone() for k, v in p.items()}
            for p in pools]


@pytest.mark.parametrize("kv_dtype", ["fp32", "int8", "fp8"])
def test_flocking_probe_leaves_pools_bit_identical(params, kv_dtype):
    _, tp = params
    gt = tg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    trace = _flock_trace()
    off = _drain(PagedServer, TCFG, tp, gt, trace, device="cpu",
                 kv_dtype=kv_dtype, **FLOCK_KW)
    srv = PagedServer(TCFG, tp, gcfg=gt, device="cpu", kv_dtype=kv_dtype,
                      flocking_every=2, **FLOCK_KW)
    probe = srv._run_flocking_probe
    seen = {"probes": 0, "naive_changed": 0}

    def checked(reqs):
        before = _pool_bits(srv.pools)
        # what an unrestored probe would leave behind: the same step on a
        # copy of the pools
        probed = [r for r in reqs if r.compacted and r.generated]
        if probed:
            toks, pos, mask, bts, _ = srv._decode_inputs(probed)
            copy = [{k: v.clone() for k, v in p.items()} for p in srv.pools]
            tdec.decode_step_paged(
                srv.params, TCFG, copy, torch.from_numpy(bts),
                torch.from_numpy(toks), torch.from_numpy(pos),
                write_mask=torch.from_numpy(mask), collect_stats=True,
                backend=srv.backend, kv_dtype=srv.kv_dtype)
            seen["naive_changed"] += any(
                not torch.equal(kv_quant.as_bytes(c[k]), b[k])
                for c, b in zip(copy, before) for k in b)
        probe(reqs)
        seen["probes"] += bool(probed)
        after = _pool_bits(srv.pools)
        for li, (b, a) in enumerate(zip(before, after)):
            for k in b:
                assert torch.equal(b[k], a[k]), (kv_dtype, li, k)

    srv._run_flocking_probe = checked
    for i, (p, m) in enumerate(trace):
        srv.submit(p, m, rid=i)
    on = {i: tuple(v) for i, v in srv.drain().items()}
    assert on == off
    assert seen["probes"] > 0 and seen["naive_changed"] == seen["probes"]
    assert srv.flocking.probes.value == seen["probes"]
    assert srv.flocking.live_rids() == []


def test_flocking_matches_jax(params):
    jp, tp = params
    trace = _flock_trace()
    js = JaxServer(CFG, jp, gcfg=jg.GriffinConfig(sparsity=0.5,
                                                  per_shard_topk=False),
                   flocking_every=2, **FLOCK_KW)
    ts = PagedServer(TCFG, tp, gcfg=tg.GriffinConfig(sparsity=0.5,
                                                     per_shard_topk=False),
                     flocking_every=2, device="cpu", **FLOCK_KW)
    # keep the port's running decode statistics at every probe, to tell a
    # top-k near-tie from a fault
    acc_log = []
    on_probe = ts.flocking.on_probe

    def logged(rows, stats):
        out = on_probe(rows, stats)
        acc_log.append({rid: {n: v.copy() for n, v in
                              ts.flocking._decode_s_sq.get(rid, {}).items()}
                        for rid in rows})
        return out

    ts.flocking.on_probe = logged
    for srv in (js, ts):
        for i, (p, m) in enumerate(trace):
            srv.submit(p, m, rid=i)
    assert {i: tuple(v) for i, v in ts.drain().items()} == \
        {i: tuple(v) for i, v in js.drain().items()}
    assert js.flocking.probes.value == ts.flocking.probes.value > 0
    assert sorted(js.flocking.last) == sorted(ts.flocking.last) == [0, 1, 2]

    def near_tie(rid):
        for snap in acc_log:
            for name, acc in snap.get(rid, {}).items():
                s = np.sort(np.sqrt(np.maximum(acc, 0.0)))[::-1]
                k = ts.gcfg.k_of(len(s))
                if k < len(s) and s[k - 1] - s[k] <= 1e-5 * abs(s[k - 1]):
                    return name
        return None

    ties = []
    for rid, want in js.flocking.last.items():
        got = ts.flocking.last[rid]
        assert got["probes"] == want["probes"]
        assert abs(got["angular"] - want["angular"]) <= 1e-5, rid
        if got["jaccard"] != want["jaccard"]:
            layer = near_tie(rid)
            assert layer is not None, (rid, got, want)
            ties.append(layer)
            print(f"rid {rid}: Jaccard differs at a top-k near-tie in "
                  f"{layer}: port {got['jaccard']} jax {want['jaccard']}")

    def gauges(srv):
        return {(m.name, dict(m.labels)["layer"]): m.value
                for m in srv.metrics.registry
                if m.name in ("flocking_jaccard", "flocking_angular")}

    gj, gt_ = gauges(js), gauges(ts)
    assert sorted(gj) == sorted(gt_)
    assert {layer for _, layer in gt_} == set(layer_names(TCFG).values())
    for key in gj:
        if key[0] == "flocking_angular":
            assert abs(gj[key] - gt_[key]) <= 1e-5, key
        elif key[1] not in ties:
            assert gj[key] == gt_[key], key


def test_flocking_requires_griffin(params):
    _, tp = params
    with pytest.raises(ValueError, match="gcfg"):
        PagedServer(TCFG, tp, gcfg=None, flocking_every=4, device="cpu")
