"""The serving frontend over the port's tensor-parallel mesh on the CPU,
held against the mesh ``drain()`` and the JAX package's single-device
frontend.

* **Rank 0 leads, rank 1 replays** — one 2-rank gloo spawn of tinylm-tp
  (fp32, the reference's ``PRNGKey(0)`` draw with the projections scaled
  by 2, ``GriffinConfig(tp_shards=2)``): rank 0's ``ServingFrontend``
  over a ``relay.MeshLeader`` serves five ``POST /v1/generate`` through
  ``handle_connection`` on a ``FakeClock``, one client hanging up
  mid-decode (a cancel) and one queued request past its deadline (a
  shed); rank 1 runs ``relay.follow``.  The SSE streams equal the
  reference's ``ServingFrontend`` over its single-device ``PagedServer``
  on the same script frame for frame, the survivors' tokens equal a
  mesh ``drain()`` of the same trace (the same spawn), and rank 1's
  finished and aborted requests, abort reasons and free pages equal
  rank 0's.
* **The launcher** — ``python -m repro_torch.launch.serve --arch
  tinylm-tp --device cpu --mesh model=2 --http 127.0.0.1:PORT`` in a
  subprocess: one POST over a socket gives an SSE stream equal to the
  one-process launcher's tokens for that prompt (the same weights), an
  idle period passes (the follower waits in its control receive), and a SIGINT
  gives exit code 0, the reference's ``http:`` summary line and no rank
  left running; a second launcher beside it, whose follower is killed
  while it idles, fails (no rank serves on alone).

Rank functions live in this module, which imports no JAX at the top:
the spawned ranks import it by name.
"""
import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import griffin as tg  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.serving import relay  # noqa: E402
from repro_torch.serving.clock import FakeClock  # noqa: E402
from repro_torch.serving.frontend import ServingFrontend  # noqa: E402
from repro_torch.serving.metrics import ServingMetrics  # noqa: E402
from repro_torch.serving.server import PagedServer  # noqa: E402

TCFG = tget("tinylm-tp")
_MATS = ("wq", "wk", "wv", "wo", "w1", "wg", "w2")
SRC = str(Path(__file__).parent.parent / "src")
KW = dict(page_size=8, num_pages=24, n_slots=2, prefill_chunk=8, max_len=64)


def _trace():
    """Five requests: two interactive, then a batch request with a short
    deadline that waits in the scheduler's queue behind them (shed), two
    standard ones (the first cancelled mid-decode)."""
    rng = np.random.default_rng(3)
    out = []
    for slo, n, gen, dl in (("interactive", 20, 9, None), ("interactive", 17, 8, None),
                            ("batch", 12, 6, 0.004), ("standard", 14, 12, None),
                            ("standard", 10, 7, None)):
        prompt = rng.integers(0, TCFG.vocab_size, n).astype(np.int32)
        out.append((prompt, gen, slo, dl))
    return out


#: the i-th request arrives at START[i]; request 3's client hangs up at
#: tick HANGUP
START = [0, 0, 0, 4, 6]
HANGUP = (3, 14)


def _post(obj) -> bytes:
    body = json.dumps(obj).encode()
    return (f"POST /v1/generate HTTP/1.1\r\nContent-Length: {len(body)}\r\n"
            f"\r\n").encode() + body


def _raws():
    return [_post({"prompt": p.tolist(), "max_new": m, "slo": slo,
                   **({} if dl is None else {"deadline_s": dl})})
            for p, m, slo, dl in _trace()]


class _MemWriter:
    def __init__(self):
        self.buf = bytearray()

    def write(self, b: bytes) -> None:
        self.buf.extend(b)

    async def drain(self) -> None:
        pass

    def can_write_eof(self) -> bool:
        return False

    def close(self) -> None:
        pass


async def _serve_conns(fe, clk, raws, max_ticks=400):
    """One ``handle_connection`` per raw request, started at ``START``,
    the client of ``HANGUP`` hanging up at its tick; the frontend ticked
    by hand, the clock advanced 1 ms a tick."""
    writers = [_MemWriter() for _ in raws]
    readers, tasks = {}, {}
    tick = 0
    while len(tasks) < len(raws) or not all(t.done() for t in tasks.values()) \
            or fe.has_work:
        for i, raw in enumerate(raws):
            if i not in tasks and START[i] <= tick:
                readers[i] = asyncio.StreamReader()
                readers[i].feed_data(raw)
                tasks[i] = asyncio.ensure_future(
                    fe.handle_connection(readers[i], writers[i]))
                await asyncio.sleep(0)  # submit in start order
        if tick == HANGUP[1]:
            readers[HANGUP[0]].feed_eof()
        fe.tick()
        clk.advance(0.001)
        await asyncio.sleep(0)
        tick += 1
        assert tick < max_ticks
    for t in tasks.values():
        await t
    return [bytes(w.buf) for w in writers]


def _frames(raw: bytes):
    """-> (status line, [(event or None, data)])"""
    head, _, body = raw.partition(b"\r\n\r\n")
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
    return head.split(b"\r\n")[0].decode(), frames


def _gcfg(pkg):
    return pkg.GriffinConfig(sparsity=0.5, per_shard_topk=True, tp_shards=2)


def _frontend_rank(mesh, params):
    """Rank 0: the frontend session over the leader; rank 1: the
    follower.  Then both: a mesh ``drain()`` of the same trace."""
    torch.set_num_threads(1)
    clk = FakeClock()
    srv = PagedServer(TCFG, params, _gcfg(tg), mesh=mesh, device="cpu",
                      metrics=ServingMetrics(clock=clk), **KW)
    ch = relay.ControlChannel()
    raws = None
    if mesh.rank == 0:
        leader = relay.MeshLeader(srv, ch)
        fe = ServingFrontend(leader, queue_depth=4, clock=clk)
        raws = asyncio.run(_serve_conns(fe, clk, _raws()))
        leader.stop()
        out = relay.outcome(srv)
    else:
        out = relay.follow(srv, ch)
    srv.sched.alloc.check()
    drain = PagedServer(TCFG, params, _gcfg(tg), mesh=mesh, device="cpu", **KW)
    for i, (p, m, _, _) in enumerate(_trace()):
        drain.submit(p, m, rid=i)
    return {"raws": raws, "outcome": out, "drain": drain.drain(),
            "messages": ch.messages}


def _jax_sse(js):
    """The reference's frontend over its single-device server, the same
    script on its own ``FakeClock``."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config
    from repro.core import griffin as jg
    from repro.serving.clock import FakeClock as JClock
    from repro.serving.frontend import ServingFrontend as JFrontend
    from repro.serving.metrics import ServingMetrics as JMetrics
    from repro.serving.server import PagedServer as JServer

    clk = JClock()
    srv = JServer(get_config("tinylm-tp"), jax.tree.map(jnp.asarray, js),
                  gcfg=_gcfg(jg), metrics=JMetrics(clock=clk), **KW)
    fe = JFrontend(srv, queue_depth=4, clock=clk)
    return asyncio.run(_serve_conns(fe, clk, _raws()))


def _scaled(tree, s):
    return {k: _scaled(v, s) if isinstance(v, dict)
            else (v * s if k in _MATS else v) for k, v in tree.items()}


def test_mesh_frontend_equals_drain_and_reference():
    from concurrent.futures import ThreadPoolExecutor

    import jax

    from repro.configs.registry import get_config
    from repro.models import decoder as jdec

    js = _scaled(jax.tree.map(np.asarray, jdec.init_params(
        get_config("tinylm-tp"), jax.random.PRNGKey(0))), np.float32(2.0))
    params = bridge.params_from_jax(js, TCFG, "cpu")
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_ranks, _frontend_rank, 2, backend="gloo",
                        device="cpu", args=(params,), timeout_s=240)
        want = _jax_sse(js)
        ranks, _ = fut.result()
    r0, r1 = ranks
    assert r1["outcome"] == r0["outcome"]
    assert r1["drain"] == r0["drain"]
    assert r0["messages"] == r1["messages"] > 10
    out = r0["outcome"]
    assert out["aborted"] == {2: "shed", HANGUP[0]: "cancelled"}, out["aborted"]
    assert len({t for s in out["streams"].values() for t in s}) > 4
    for i, (got, ref) in enumerate(zip(r0["raws"], want)):
        status, frames = _frames(got)
        assert status == "HTTP/1.1 200 OK", i
        assert frames == _frames(ref)[1], i
        toks = [d["token"] for e, d in frames if e is None]
        if i == 2:  # shed before it produced a token
            assert frames[-1][0] == "error" and not toks
        elif i == HANGUP[0]:  # cancelled mid-decode
            assert 0 < len(toks) < _trace()[i][1]
        else:
            assert frames[-1][0] == "done"
            assert toks == r0["drain"][i] == out["streams"][i], i


# ---------------------------------------------------------------------------
# the launcher: --mesh model=2 --http
# ---------------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post_sse(port: int, obj, timeout=120.0) -> bytes:
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(_post(obj))
        buf = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                return buf
            buf += chunk


def _children(pid: int):
    """Live processes whose parent is ``pid`` (from ``/proc``)."""
    out = []
    for d in Path("/proc").iterdir():
        try:
            fields = (d / "stat").read_text().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue
        if int(fields[1]) == pid and fields[0] != "Z":
            out.append(int(d.name))
    return out


def _ranks_of(proc):
    """The launcher's spawned ranks (rank 1 started after rank 0)."""
    return sorted(p for p in _children(proc.pid)
                  if b"spawn_main" in Path(f"/proc/{p}/cmdline").read_bytes())


def test_launcher_mesh_http(tmp_path):
    """Two launchers at once: the first serves a POST, idles and stops
    on SIGINT; the second's follower is killed
    while it idles, which must fail the launcher."""
    from repro_torch.launch import serve

    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    ports = [_free_port(), _free_port()]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "tinylm-tp",
         "--device", "cpu", "--mesh", "model=2", "--http", f"127.0.0.1:{port}",
         "--ckpt-dir", str(tmp_path / "none")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for port in ports]
    prompt = [5, 17, 99, 3, 250, 8, 41]
    try:
        raw = None
        deadline = time.monotonic() + 120
        while raw is None:
            assert all(p.poll() is None for p in procs), procs[0].communicate()
            assert time.monotonic() < deadline, "the server never listened"
            try:
                raw = _post_sse(ports[0], {"prompt": prompt, "max_new": 6})
            except OSError:
                time.sleep(0.2)
        while len(_ranks_of(procs[1])) < 2:  # the second one's ranks are up
            assert procs[1].poll() is None and time.monotonic() < deadline
            time.sleep(0.2)
        ranks = [_ranks_of(p) for p in procs]
        os.kill(ranks[1][1], signal.SIGKILL)  # the second one's follower
        time.sleep(1)  # idle: rank 1 waits for rank 0's next message
        assert procs[0].poll() is None
        procs[0].send_signal(signal.SIGINT)
        (out, err), (_, err1) = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert procs[0].returncode == 0, err[-3000:]
    assert procs[1].returncode != 0 and "run of 2 ranks on gloo failed" in err1, \
        err1[-3000:]
    for rs in ranks:  # no rank left running
        assert not [r for r in rs if Path(f"/proc/{r}").exists()
                    and "Z" not in (Path(f"/proc/{r}") / "stat").read_text().split()[2]]
    status, frames = _frames(raw)
    assert status == "HTTP/1.1 200 OK" and frames[-1][0] == "done"
    toks = [d["token"] for e, d in frames if e is None]
    # the one-process launcher's weights and server on the same prompt
    cfg = tget("tinylm-tp")
    params = serve.load_params(cfg, "tinylm-tp", str(tmp_path / "none"), "cpu")
    # (the mesh's selection: GRIFFIN over each rank's block, as forced)
    one = PagedServer(cfg, params, _gcfg(tg), device="cpu",
                      page_size=16, num_pages=64, n_slots=4, prefill_chunk=32,
                      max_len=128)
    one.submit(np.asarray(prompt, np.int32), 6, rid=0)
    assert toks == one.drain()[0]
    assert "[mesh] model=2: 2 ranks on gloo (cpu)" in out
    assert "http: accepted=1 completed=1 shed=0" in out, out
    assert out.count("http: serving on") == 1  # rank 0 only
