"""The port's training path (``decoder.loss_fn`` and its gradients, the
train step, the loop, checkpoints, the launcher) held against the JAX
package on the CPU at fp32.

Parameters are the port's seeded draw handed to the reference in its
layout (``bridge.params_to_jax``), or the reference's ``PRNGKey(0)`` draw
bridged across; batches come from numpy seeds.

* ``loss_fn``'s loss within rtol 1e-5 and every gradient leaf within
  rtol 1e-4 / atol 1e-6 of ``jax.value_and_grad`` of the reference's, for
  the smoke config of every reference arch and tinylm (the batches of
  ``tests/test_archs_smoke.py``); the only leaf the loss does not read
  is an encoder's token table (its reference gradient is zero);
* remat on gives the gradients of remat off, bit for bit;
* 3 train steps with each optimizer, and AdamW with ``accum_steps=2``,
  on tinylm: losses within rtol 1e-5 and parameters within rtol 1e-4 /
  atol 1e-6 of the reference's ``build_train_step`` (the Adams: but for
  at most 0.1% of a leaf's elements, each within lr / 10, and 0.3% for
  8-bit Adam, each within lr: ``ADAM_TOL``, ``ADAM8_TOL``);
* preempt and resume as in ``tests/test_checkpoint.py``, and the resumed
  run ends where an uninterrupted run ends (equal parameters);
* checkpoints each way: the reference resumes what the port wrote and
  the port what the reference wrote, each ending within ``ADAM_TOL`` of
  an uninterrupted run of the writer; ``launch.serve`` serves a checkpoint
  the port trained;
* ``abstract_train_state`` against the reference's ``ShapeDtypeStruct``s
  for every full config (no allocation);
* ``launch.train.main`` on tinylm prints the reference launcher's loss
  lines (same init), and refuses ``--mesh pod``;
* the serving entry points build no autograd graph from parameters that
  require gradients.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.manager import CheckpointManager as JaxManager  # noqa: E402
from repro.configs import registry as jreg  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.training import loop as jloop  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro.training import train_step as jts  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.data.pipeline import ShardedLoader, SyntheticCorpus  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.runtime.preemption import PreemptionGuard  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402
from repro_torch.training.loop import train as ttrain  # noqa: E402

LOSS_TOL = dict(rtol=1e-5, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
#: Adam's first updates are lr * g / (|g| + eps): an element whose gradient
#: is a few ulps from 0 in either package moves by another share of lr.
#: At most 0.1% of a leaf's elements, each within lr / 10.
ADAM_TOL = dict(PARAM_TOL, few=1e-3, few_atol=3e-4)
#: 8-bit Adam adds moment codes that round apart (test_torch_training.py),
#: and a second-moment code of 0 against 1 moves an element by up to lr:
#: at most 0.3% of a leaf's elements, each within lr
ADAM8_TOL = dict(ADAM_TOL, few=3e-3, few_atol=3e-3)
ARCHS = jreg.ASSIGNED_ARCHS + ["tinylm"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _np(tree):
    """Torch leaves -> numpy copies (bf16 as ``ml_dtypes.bfloat16``, bit
    for bit): the port updates its parameters in place."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if tree.dtype == torch.bfloat16:
        return tree.view(torch.int16).numpy().view(ml_dtypes.bfloat16).copy()
    return tree.numpy().copy()


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _assert_trees_close(got, want, tol, what=""):
    """Leaf for leaf within ``tol`` (``rtol``, ``atol``); with ``few``
    and ``few_atol``, at most a share ``few`` of a leaf's elements may
    exceed it, by at most ``few_atol``."""
    tol = dict(tol)
    few, few_atol = tol.pop("few", 0.0), tol.pop("few_atol", 0.0)
    got = dict(_leaves(got))
    want = dict(_leaves(jax.tree.map(np.asarray, want)))
    assert sorted(got) == sorted(want), what
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and g.dtype == w.dtype, (what, path)
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        off = np.abs(g - w) > tol["atol"] + tol["rtol"] * np.abs(w)
        assert off.sum() <= few * w.size, (what, path, int(off.sum()), w.size)
        np.testing.assert_allclose(g, w, rtol=tol["rtol"],
                                   atol=max(tol["atol"], few_atol),
                                   err_msg=f"{what} {path}")


def _batch_for(cfg, seed, B=2, S=48):
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


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _models(arch):
    smoke = arch != "tinylm"
    cfg, tcfg = jreg.get_config(arch, smoke=smoke), tget(arch, smoke=smoke)
    tp = tdec.init_params(tcfg, 0, "cpu")
    return cfg, tcfg, tp, jax.tree.map(jnp.asarray, _np(bridge.params_to_jax(tp, tcfg)))


def _zero_filled(grads, params):
    flat, rebuild = tts._flatten(params)
    g, _ = tts._flatten(grads)
    return rebuild([torch.zeros_like(p) if x is None else x for p, x in zip(flat, g)])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    cfg, tcfg, tp, jp = _models(arch)
    b = _batch_for(cfg, 0)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, bb: jdec.loss_fn(p, bb, cfg), has_aux=True))(
        jp, jax.tree.map(jnp.asarray, b))
    loss, metrics, grads = tts.value_and_grad(tdec.loss_fn, tp, _torch_batch(b), tcfg)
    assert not loss.requires_grad
    np.testing.assert_allclose(float(loss), float(jl), **LOSS_TOL)
    for k, v in jm.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    unread = sorted(p for p, g in _leaves(bridge.ref_view(grads, tcfg))
                    if g is None or (isinstance(g, list) and g[0] is None))
    assert unread == (["embed/table"] if cfg.family == "encoder" else [])
    for p in unread:
        assert not np.asarray(jg["embed"]["table"]).any(), p
    _assert_trees_close(_np(bridge.params_to_jax(_zero_filled(grads, tp), tcfg)),
                        jg, GRAD_TOL, arch)


@pytest.mark.parametrize("arch", ["tinylm", "moonshot-v1-16b-a3b"])
def test_remat_gives_the_same_gradients(arch):
    smoke = arch != "tinylm"
    tcfg = tget(arch, smoke=smoke)
    assert not tcfg.remat
    tp = tdec.init_params(tcfg, 0, "cpu")
    b = _torch_batch(_batch_for(tcfg, 1))
    off = tts.value_and_grad(tdec.loss_fn, tp, b, tcfg)
    on = tts.value_and_grad(tdec.loss_fn, tp, b, tcfg.replace(remat=True))
    assert torch.equal(off[0], on[0])
    for (p, g0), (_, g1) in zip(_leaves(off[2]["layers"][0]), _leaves(on[2]["layers"][0])):
        assert torch.equal(g0, g1), p
    flat0, _ = tts._flatten(off[2])
    flat1, _ = tts._flatten(on[2])
    assert all(torch.equal(a, c) for a, c in zip(flat0, flat1))


TRAIN_CASES = [
    ("adamw", 1, ADAM_TOL),
    ("adamw", 2, ADAM_TOL),
    ("adam8bit", 1, ADAM8_TOL),
    ("adafactor", 1, PARAM_TOL),
    ("sgdm", 1, PARAM_TOL),
]


@pytest.mark.parametrize("name,accum,tol", TRAIN_CASES)
def test_train_steps_match_jax(name, accum, tol):
    cfg, tcfg, tp, jp = _models("tinylm")
    jo, to = jopt.get_optimizer(name, 3e-3), topt.get_optimizer(name, 3e-3)
    jstate = {"params": jp, "opt": jo.init(jp), "step": jnp.zeros((), jnp.int32)}
    tstate = {"params": tp, "opt": to.init(bridge.ref_view(tp, tcfg)),
              "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(jts.build_train_step(cfg, jo, accum_steps=accum))
    tstep = tts.build_train_step(tcfg, to, accum_steps=accum)
    rng = np.random.default_rng(3)
    for _ in range(3):
        b = {"tokens": rng.integers(0, 256, (4, 33)).astype(np.int32)}
        jstate, jm = jstep(jstate, jax.tree.map(jnp.asarray, b))
        tstate, tm = tstep(tstate, _torch_batch(b))
        assert sorted(tm) == sorted(jm)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **LOSS_TOL)
    assert int(tstate["step"]) == 3 and tstate["step"].dtype == torch.int32
    got = _np(bridge.train_state_to_jax(tstate, tcfg))
    _assert_trees_close(got["params"], jstate["params"], tol, name)
    if name != "adam8bit":  # int8 codes: test_torch_training.py
        _assert_trees_close(got["opt"], jstate["opt"], dict(PARAM_TOL, few=1e-3,
                                                            few_atol=1e-6), name)


def _tiny():
    return tget("tinylm").replace(num_layers=2, d_model=32, d_ff=64, num_heads=2,
                                  num_kv_heads=1, head_dim=16)


def _run(cfg, steps, mgr=None, guard=None, start=0, opt=None):
    loader = ShardedLoader(SyntheticCorpus(), batch=2, seq_len=32, start_step=start)
    try:
        return ttrain(cfg, opt or topt.adamw(1e-3), loader, steps, ckpt=mgr,
                      guard=guard, log_every=0, log_fn=lambda s: None, device="cpu")
    finally:
        loader.close()


def test_preemption_checkpoints_and_resume_ends_where_a_clean_run_ends(tmp_path):
    cfg = _tiny()
    mgr = CheckpointManager(str(tmp_path), interval=1000, keep=2, use_async=False)
    guard = PreemptionGuard(install_handlers=False)
    guard.simulate()  # preempt immediately after first step
    res = _run(cfg, 50, mgr, guard)
    assert res.preempted and res.steps_done == 1
    assert mgr.latest_step() == 1

    res2 = _run(cfg, 3, mgr, start=1)  # resumes from the checkpoint
    assert res2.steps_done == 2  # steps 1 -> 3
    assert int(res2.state["step"]) == 3
    clean = _run(cfg, 3)
    for (p, a), (_, c) in zip(_leaves(bridge.params_to_jax(res2.state["params"], cfg)),
                              _leaves(bridge.params_to_jax(clean.state["params"], cfg))):
        assert torch.equal(a, c), p


@pytest.mark.parametrize("name", ["adamw", "adam8bit"])
def test_checkpoints_cross_between_the_packages(tmp_path, name):
    jcfg = jreg.get_config("tinylm").replace(num_layers=2, d_model=32, d_ff=64,
                                             num_heads=2, num_kv_heads=1, head_dim=16)
    cfg = _tiny()
    to, jo = topt.get_optimizer(name, 1e-3), jopt.get_optimizer(name, 1e-3)

    def jrun(steps, mgr, start=0):
        loader = ShardedLoader(SyntheticCorpus(), batch=2, seq_len=32,
                               start_step=start)
        try:
            return jloop.train(jcfg, jo, loader, steps, ckpt=mgr, log_every=0,
                               log_fn=lambda s: None)
        finally:
            loader.close()

    # the port writes steps 0-1, the reference resumes to step 3
    _run(cfg, 2, CheckpointManager(str(tmp_path / "a"), interval=2, use_async=False),
         opt=to)
    restored, step = JaxManager(str(tmp_path / "a"), interval=2).restore_latest()
    assert step == 2
    port_clean = _run(cfg, 3, opt=topt.get_optimizer(name, 1e-3))
    ref_after = jrun(3, JaxManager(str(tmp_path / "a"), interval=100), start=2)
    assert ref_after.steps_done == 1
    _assert_trees_close(_np(bridge.params_to_jax(port_clean.state["params"], cfg)),
                        ref_after.state["params"], ADAM_TOL, "port -> reference")

    # the reference writes steps 0-1, the port resumes to step 3
    jmgr = JaxManager(str(tmp_path / "b"), interval=2, use_async=False)
    jrun(2, jmgr)
    jmgr.wait()
    ref_clean = jrun(3, None)
    port_after = _run(cfg, 3, CheckpointManager(str(tmp_path / "b"), interval=100),
                      start=2, opt=topt.get_optimizer(name, 1e-3))
    assert port_after.steps_done == 1 and int(port_after.state["step"]) == 3
    _assert_trees_close(_np(bridge.params_to_jax(port_after.state["params"], cfg)),
                        ref_clean.state["params"], ADAM_TOL, "reference -> port")


def test_launcher_serves_a_checkpoint_the_port_trained(tmp_path):
    cfg = tget("tinylm")
    mgr = CheckpointManager(str(tmp_path), interval=1, use_async=False)
    loader = ShardedLoader(SyntheticCorpus(), batch=2, seq_len=16)
    try:
        res = ttrain(cfg, topt.adamw(1e-3), loader, 1, ckpt=mgr, log_every=0,
                     log_fn=lambda s: None, device="cpu")
    finally:
        loader.close()
    served = serve.load_params(cfg, "tinylm", str(tmp_path), "cpu")
    want = bridge.params_to_jax(res.state["params"], cfg)
    for (p, a), (_, c) in zip(_leaves(bridge.params_to_jax(served, cfg)), _leaves(want)):
        assert torch.equal(a, c), p
    streams = serve.main(["--arch", "tinylm", "--device", "cpu", "--requests", "2",
                          "--ckpt-dir", str(tmp_path)])
    assert len(streams) == 2 and all(len(s) > 0 for s in streams.values())


@pytest.mark.parametrize("name", ["adamw", "adam8bit", "adafactor", "sgdm"])
def test_abstract_train_state_matches_jax(name):
    for arch in ARCHS:
        cfg, tcfg = jreg.get_config(arch), tget(arch)
        want = jts.abstract_train_state(cfg, jopt.get_optimizer(name, 1e-3))
        got = bridge.train_state_to_jax(
            tts.abstract_train_state(tcfg, topt.get_optimizer(name, 1e-3)), tcfg)
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert sorted(got) == sorted(want), arch
        for path, w in want.items():
            g = got[path]
            assert g.is_meta, (arch, path)
            assert tuple(g.shape) == tuple(w.shape), (arch, path)
            assert str(g.dtype).split(".")[-1] == str(w.dtype), (arch, path)


def test_default_optimizer_is_the_reference_policy():
    from repro.configs.shapes import ShapeConfig
    from repro.launch.policies import policy_for

    shape = ShapeConfig("cli", 128, 8, "train")
    for arch in ARCHS:
        for smoke in (False, True):
            cfg = jreg.get_config(arch, smoke=smoke)
            assert tlaunch.default_optimizer(tget(arch, smoke=smoke)) == \
                policy_for(cfg, shape).optimizer, (arch, smoke)


def _loss_lines(text):
    return {int(ln.split()[1]): float(ln.split()[3]) for ln in text.splitlines()
            if ln.startswith("step ")}


def test_launcher_prints_the_reference_losses(capsys, monkeypatch):
    import sys

    from repro.launch import train as jlaunch

    argv = ["--arch", "tinylm", "--steps", "12", "--batch", "4", "--seq", "32"]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    jlaunch.main()
    want = _loss_lines(capsys.readouterr().out)
    assert sorted(want) == [0, 10, 11]

    cfg = jreg.get_config("tinylm", smoke=True)
    jstate = jts.init_train_state(cfg, jopt.adamw(1e-3), jax.random.PRNGKey(0))

    def ref_init(tcfg, optimizer, seed, device):  # the reference's draw
        params = bridge.params_from_jax(jax.tree.map(np.asarray, jstate["params"]),
                                        tcfg, device)
        return {"params": params, "opt": optimizer.init(bridge.ref_view(params, tcfg)),
                "step": torch.zeros((), dtype=torch.int32)}

    monkeypatch.setattr(tlaunch, "init_train_state", ref_init)
    losses = tlaunch.main(argv + ["--device", "cpu"])
    got = _loss_lines(capsys.readouterr().out)
    assert len(losses) == 12 and sorted(got) == [0, 10, 11]
    for step, w in want.items():
        assert abs(got[step] - w) <= 1.5e-4, (step, got[step], w)
        assert abs(losses[step] - w) <= 1e-4, (step, losses[step], w)


def test_launcher_refuses_the_pod_meshes(capsys):
    for mesh in ("pod", "2pod"):
        with pytest.raises(SystemExit):
            tlaunch.main(["--mesh", mesh, "--device", "cpu"])
        assert "tensor parallelism" in capsys.readouterr().err


def test_serving_entry_points_build_no_graph():
    from repro_torch.serving import steps

    cfg = tget("tinylm")
    params = tdec.init_params(cfg, 0, "cpu")
    flat, rebuild = tts._flatten(params)
    params = rebuild([p.detach().requires_grad_(True) for p in flat])
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 9)))
    logits, aux = tdec.forward(params, cfg, toks, collect_stats=True, want_kv=True)
    assert not logits.requires_grad and not aux.kv[0]["k"].requires_grad
    assert not aux.stats[0]["s_sq"].requires_grad
    out = steps.build_prefill_step(cfg, None)(params, toks)
    assert not out["last_logits"].requires_grad
    cache = tdec.fill_cache_from_prefill(cfg, tdec.init_cache(cfg, 2, 16, "cpu"),
                                         aux.kv)
    logits, cache = tdec.decode_step(params, cfg, cache, toks[:, :1], 9)
    assert not logits.requires_grad and not cache[0]["k"].requires_grad
    pools = tdec.init_paged_pools(cfg, 8, 4, device="cpu")
    bt = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    logits, pools, _ = tdec.decode_step_paged(
        params, cfg, pools, bt, toks[:, :5], torch.zeros(2, dtype=torch.int32))
    assert not logits.requires_grad and not pools[0]["k"].requires_grad
    # and the training forward does build one
    x, _ = tdec.hidden_forward(params, cfg, toks)
    assert x.requires_grad
