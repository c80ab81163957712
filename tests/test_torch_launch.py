"""The port's launcher and checkpoints on the CPU, held against the JAX
package.

* ``repro_torch.launch.serve.main([... "--device", "cpu", "--ckpt-dir",
  d])`` returns the token streams of the JAX ``PagedServer`` built as
  the JAX launcher builds it, from one checkpoint written by
  ``repro.checkpoint.checkpointer.save`` (tinylm's ``PRNGKey(0)`` draw
  with the projection matrices scaled by 2): fp32, int8, ``--spec-k 3``
  and ``--tier 0.5``.  The launcher's requests are the reference
  launcher's.
* The launcher prints the reference's summary lines; its trace passes
  ``validate_chrome_trace`` and its metrics snapshot parses.
* Checkpoints cross both ways bit for bit, bf16 leaves included; the
  port's parameters go back to the reference layout
  (``bridge.params_to_jax``) unchanged.
* ``--mesh`` with ``--http`` and a missing card without ``--device cpu``
  are refused (``tests/test_torch_tp.py`` runs ``--mesh`` itself).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.checkpoint import checkpointer as jckpt  # noqa: E402
from repro.configs.registry import get_config  # noqa: E402
from repro.core import GriffinConfig as JGriffin  # noqa: E402
from repro.data.pipeline import SyntheticCorpus as JCorpus  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.serving.server import PagedServer as JaxServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import checkpointer as tckpt  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs.export import validate_chrome_trace  # noqa: E402

CFG = get_config("tinylm")
TCFG = tget("tinylm")
_MATS = ("wq", "wk", "wv", "wo", "w1", "wg", "w2")
BASE = ["--arch", "tinylm", "--device", "cpu", "--requests", "4",
        "--max-len", "64"]



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
def ckpt(tmp_path_factory):
    """One checkpoint written by the JAX checkpointer."""
    jp = _scaled(jax.tree.map(np.asarray,
                              jdec.init_params(CFG, jax.random.PRNGKey(0))),
                 np.float32(2.0))
    d = tmp_path_factory.mktemp("ckpt")
    jckpt.save(str(d), 500, {"params": jp})
    return str(d)


def _jax_launcher_streams(ckpt_dir, *, kv_dtype="fp32", spec_k=0, tier=None,
                          requests=4, max_len=64):
    """The JAX launcher's server and requests at its default flags."""
    state, _ = jckpt.restore(ckpt_dir)
    params = jax.tree.map(jnp.asarray, state["params"])
    srv = JaxServer(CFG, params, gcfg=JGriffin(sparsity=0.5), page_size=16,
                    num_pages=64, n_slots=4, prefill_chunk=32, max_len=max_len,
                    spec_k=spec_k, spec_impl="fused", adaptive_spec=True,
                    prefix_cache=True, kernel_backend="auto",
                    kv_dtype=kv_dtype, default_tier=tier)
    corpus = JCorpus(vocab=CFG.vocab_size, seed=0)
    rng = np.random.default_rng(0)
    for rid in range(requests):
        prompt = corpus.sample(int(rng.integers(16, max_len // 2)),
                               seed=500 + rid)
        srv.submit(prompt, max_new=int(rng.integers(8, 32)), rid=rid)
    return srv.drain()


CASES = {"fp32": ([], {}),
         "int8": (["--kv-dtype", "int8"], {"kv_dtype": "int8"}),
         "spec_k3": (["--spec-k", "3"], {"spec_k": 3}),
         "tier_0.5": (["--tier", "0.5"], {"tier": 0.5})}


@pytest.mark.parametrize("case", sorted(CASES))
def test_launcher_streams_match_jax(ckpt, case, capsys):
    flags, kw = CASES[case]
    got = serve.main(BASE + ["--ckpt-dir", ckpt] + flags)
    want = _jax_launcher_streams(ckpt, **kw)
    assert {r: list(t) for r, t in got.items()} == \
        {r: list(t) for r, t in want.items()}
    assert len({t for s in got.values() for t in s}) > 4  # not degenerate
    out = capsys.readouterr().out
    assert f"[ckpt] loaded {ckpt} (step 500)" in out
    assert "paged: served 4 requests" in out


def test_launcher_requests_match_reference():
    for n, max_len in ((8, 128), (3, 64)):
        got = serve.synthetic_requests(TCFG, n, max_len)
        corpus = JCorpus(vocab=CFG.vocab_size, seed=0)
        rng = np.random.default_rng(0)
        for rid, (p, m) in enumerate(got):
            want = corpus.sample(int(rng.integers(16, max_len // 2)),
                                 seed=500 + rid)
            assert np.array_equal(p, want) and m == int(rng.integers(8, 32))
    tok = ByteTokenizer()
    assert tok.decode(tok.encode("flocking")) == "flocking"


def test_launcher_summary_trace_and_snapshot(tmp_path, capsys):
    trace, snap = tmp_path / "trace.json", tmp_path / "metrics.json"
    got = serve.main(BASE + ["--ckpt-dir", str(tmp_path / "none"),
                             "--spec-k", "3", "--kv-dtype", "int8",
                             "--trace-out", str(trace),
                             "--metrics-snapshot", str(snap),
                             "--flocking-telemetry", "2"])
    assert sorted(got) == [0, 1, 2, 3]
    out = capsys.readouterr().out
    for line in ("UNTRAINED init", "[GRIFFIN@50%+spec3] paged: served 4 "
                 "requests", "  ttft p50=", "  prefix: hit_rate=",
                 "  spec: acceptance=", "  flocking: jaccard=",
                 f"[obs] trace (", f"-> {trace}",
                 f"[obs] metrics snapshot -> {snap}"):
        assert line in out, line
    assert validate_chrome_trace(json.loads(trace.read_text())) == []
    snapshot = json.loads(snap.read_text())
    assert snapshot["summary"]["requests_finished"] == 4.0 and snapshot["metrics"]
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"tick", "flocking_probe", "spec_round"} <= names


@pytest.mark.parametrize("argv,needle", [
    # --mesh with --http serves (test_torch_mesh_frontend.py); its address
    # is checked before any rank starts
    (["--mesh", "model=2", "--http", "127.0.0.1"], "--http wants HOST:PORT"),
    (["--arch", "mamba2-1.3b", "--spec-k", "2"], "requires GRIFFIN"),
    (["--no-griffin", "--flocking-telemetry", "2"], "requires GRIFFIN"),
    (["--no-griffin", "--spec-k", "2"], "requires GRIFFIN"),
])
def test_launcher_refuses(argv, needle, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--device", "cpu"] + argv)
    assert e.value.code == 2
    assert needle in capsys.readouterr().err


def test_launcher_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "tinylm", "--requests", "1"])


def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {"/".join(path): tree}


def test_port_checkpoint_restores_through_jax_bit_for_bit(tmp_path):
    rng = np.random.default_rng(0)
    bf = torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)) \
        .to(torch.bfloat16)
    tree = {"params": {"w": torch.from_numpy(rng.standard_normal((4, 2))
                                             .astype(np.float32)),
                       "bf": bf},
            "step": np.asarray(7, np.int32), "ids": np.arange(5, dtype=np.int64)}
    tckpt.save(str(tmp_path), 3, tree)
    got, step = jckpt.restore(str(tmp_path))
    assert step == 3
    assert got["params"]["bf"].dtype == ml_dtypes.bfloat16
    assert np.array_equal(got["params"]["bf"].view(np.uint16),
                          bf.view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(got["params"]["w"], tree["params"]["w"].numpy())
    assert got["step"] == 7 and np.array_equal(got["ids"], tree["ids"])
    # and back: the port reads the bits as torch.bfloat16
    back, _ = tckpt.restore(str(tmp_path))
    assert back["params"]["bf"].dtype == torch.bfloat16
    assert torch.equal(back["params"]["bf"].view(torch.int16),
                       bf.view(torch.int16))


def test_jax_checkpoint_restores_through_port(tmp_path):
    jp = jax.tree.map(np.asarray, jdec.init_params(CFG, jax.random.PRNGKey(1)))
    bf = np.asarray(jnp.asarray(jp["embed"]["table"], jnp.bfloat16))
    jckpt.save(str(tmp_path), 2, {"params": jp, "bf": bf})
    mgr = CheckpointManager(str(tmp_path), interval=1)
    assert mgr.latest_step() == 2
    state, step = mgr.restore_latest()
    assert step == 2
    assert torch.equal(state["bf"].view(torch.int16),
                       torch.from_numpy(bf.view(np.int16).copy()))
    tp = bridge.params_from_jax(state["params"], TCFG, "cpu")
    back = _flat(bridge.params_to_jax(tp, TCFG))
    want = _flat(jp)
    assert sorted(back) == sorted(want)
    for k in want:
        assert np.array_equal(back[k].numpy(), want[k]), k
    # the manager on the port side: interval and keep-N rotation
    # (synchronous saves, so rotation never races a writer), then an
    # asynchronous save
    mgr2 = CheckpointManager(str(tmp_path / "m"), interval=2, keep=2,
                             use_async=False)
    assert not mgr2.save(1, {"x": torch.ones(2)})
    for step in (2, 4, 6):
        assert mgr2.save(step, {"x": torch.full((2,), float(step))})
    assert tckpt.available_steps(mgr2.dir) == [4, 6]
    mgr3 = CheckpointManager(str(tmp_path / "a"), interval=1)
    assert mgr3.save(3, {"x": torch.full((2,), 3.0)})
    mgr3.wait()
    got, step = mgr3.restore_latest()
    assert step == 3 and np.array_equal(got["x"], np.full((2,), 3.0, np.float32))
