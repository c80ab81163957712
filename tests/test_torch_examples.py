"""The port's examples (``python -m repro_torch.examples.<name>``) on the
CPU, held against the JAX package.

* ``common.trained_tiny`` trains tinylm with the reference's recipe for
  3 steps under a temporary ``ARTIFACTS`` (never ``artifacts/models/``),
  loads it on a second call without training, and a run interrupted
  after 2 steps resumes from its save to the clean run's parameters.
* ``quickstart``: the full and GRIFFIN 0.5 generations equal the
  reference's ``GenerationEngine`` on the same (bridged) parameters.
* ``serve_batched``: the streams equal the reference's ``PagedServer``.
* ``flocking_analysis --emit-profile``: the scores equal the reference's
  ``flocking_score`` on its own activations, the profile equals the
  reference's ``derive_profile`` to 1e-5, the heat map lands under the
  port's artifacts, and ``launch.serve --tier 0.5 --sparsity-profile``
  serves the profile.
* ``train_lm --steps 3`` (a small batch): the losses equal the
  reference's ``training.loop.train`` from the same (bridged) initial
  state, and its checkpoint restores in the reference's manager.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.examples import common  # noqa: E402
from repro_torch.examples import flocking_analysis, quickstart, serve_batched, train_lm  # noqa: E402,E501

STEPS = 3
DEV = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """``ARTIFACTS`` at a temporary root, ``trained_tiny`` at 3 steps,
    trained once: (root, cfg, port params, reference params)."""
    root = tmp_path_factory.mktemp("artifacts")
    mp = pytest.MonkeyPatch()
    mp.setattr(common, "ARTIFACTS", root)
    mp.setattr(common, "STEPS", STEPS)
    cfg, params = common.trained_tiny(device="cpu")
    yield root, cfg, params, jax.tree.map(jnp.asarray, bridge.params_to_jax(params, cfg))
    mp.undo()


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def test_trained_tiny_caches_and_resumes(tiny, tmp_path, monkeypatch):
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.training.loop import train

    root, cfg, params, _ = tiny
    assert common.ckpt_dir("tinylm", STEPS) == root / "models_torch" / f"tinylm-s{STEPS}"
    # the reference's manager reads the cache (its layout) at the final step
    assert JManager(str(common.ckpt_dir("tinylm", STEPS))).latest_step() == STEPS

    def no_training(*a, **kw):
        raise AssertionError("trained again")

    monkeypatch.setattr(common, "train", no_training)
    _, again = common.trained_tiny(device="cpu")
    for a, b in zip(jax.tree.leaves(_np(bridge.params_to_jax(again, cfg))),
                    jax.tree.leaves(_np(bridge.params_to_jax(params, cfg)))):
        np.testing.assert_array_equal(a, b)
    monkeypatch.undo()

    # an interrupted run: its save at step 2 of 3, then trained_tiny
    monkeypatch.setattr(common, "ARTIFACTS", tmp_path)
    mgr = CheckpointManager(str(common.ckpt_dir("tinylm", STEPS)), interval=100, keep=2)
    loader = common.recipe_loader(cfg)
    res = train(cfg, common.recipe_optimizer(STEPS), loader, 2, ckpt=mgr,
                log_every=0, device="cpu")
    loader.close()
    mgr.save(2, bridge.train_state_to_jax(res.state, cfg), force=True)
    mgr.wait()
    _, resumed = common.trained_tiny(STEPS, device="cpu")
    for a, b in zip(jax.tree.leaves(_np(bridge.params_to_jax(resumed, cfg))),
                    jax.tree.leaves(_np(bridge.params_to_jax(params, cfg)))):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_quickstart_matches_reference(tiny, capsys):
    from repro.configs.registry import get_config
    from repro.core import GriffinConfig
    from repro.serving.engine import GenerationEngine

    _, _, _, jp = tiny
    out_full, out_griffin = quickstart.main(DEV)
    text = capsys.readouterr().out
    assert "GRIFFIN@50% vs full model — token agreement:" in text
    assert text.count("griffin50 : ") == 2
    cfg = get_config("tinylm")
    prompts = jnp.asarray(common.eval_sequences(cfg, 2, 96, device="cpu").numpy(),
                          jnp.int32)
    for gcfg, got in ((None, out_full),
                      (GriffinConfig(sparsity=0.5, per_shard_topk=False), out_griffin)):
        want = np.asarray(GenerationEngine(cfg, jp, gcfg=gcfg, max_len=160)
                          .generate(prompts, steps=32))
        np.testing.assert_array_equal(got, want)


def test_serve_batched_matches_reference(tiny, capsys):
    from repro.configs.registry import get_config
    from repro.core import GriffinConfig
    from repro.serving.server import PagedServer

    _, _, _, jp = tiny
    got = serve_batched.main(DEV)
    text = capsys.readouterr().out
    assert "served 10 requests / " in text and "on 1 CPU core, 4 slots" in text
    assert "preemptions=" in text and text.count("  req ") == 10
    cfg = get_config("tinylm")
    srv = PagedServer(cfg, jp, gcfg=GriffinConfig(sparsity=0.5, per_shard_topk=False),
                      page_size=16, num_pages=48, n_slots=4, prefill_chunk=32,
                      max_len=128)
    for rid, (prompt, gen) in enumerate(serve_batched.requests(cfg)):
        srv.submit(prompt, max_new=gen, rid=rid)
    assert got == srv.drain()


def test_flocking_analysis_profile_serves(tiny, tmp_path, capsys):
    from repro.analysis.profile import derive_profile
    from repro.configs.registry import get_config
    from repro.core.flocking import flocking_score
    from repro_torch.launch import serve

    root, _, _, jp = tiny
    dest = tmp_path / "profile.json"
    out = flocking_analysis.main(DEV + ["--emit-profile", str(dest),
                                        "--profile-seqs", "2"])
    text = capsys.readouterr().out
    assert "layer,real,permuted,random" in text and "intra-sequence=" in text
    assert (root / "flocking_torch" / "heatmap_layer2.csv").exists()
    cfg = get_config("tinylm")
    seqs = jnp.asarray(common.eval_sequences(cfg, 2, 192, device="cpu").numpy(),
                       jnp.int32)
    want = derive_profile(cfg, jp, seqs)
    got = out["profile"]
    assert [p for p, _ in got.weights] == [p for p, _ in want.weights]
    for (_, a), (_, b) in zip(got.weights, want.weights):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    # the real sequence's scores against the reference's on its activations
    jz = _jax_layer_z(cfg, jp, seqs[:1])
    np.testing.assert_allclose([s[0] for s in out["scores"]],
                               [flocking_score(z) for z in jz], atol=1e-5)
    assert sum(len(ws) for _, ws in got.weights) == cfg.num_layers
    streams = serve.main(["--arch", "tinylm", "--device", "cpu", "--requests", "2",
                          "--tier", "0.5", "--sparsity-profile", str(dest),
                          "--ckpt-dir", str(common.ckpt_dir("tinylm", STEPS))])
    text = capsys.readouterr().out
    assert f"[profile] {dest}" in text and "GRIFFIN tier=0.5+profile" in text
    assert sorted(streams) == [0, 1] and all(streams.values())


def _jax_layer_z(cfg, jp, tokens):
    from repro.models import decoder as jdec

    _, aux = jdec.forward(jp, cfg, tokens, collect_stats=True, want_z=True,
                          remat=False, logits_mode="last")
    st = jdec.prune_stats_tree(aux.stats, cfg)
    zs = []
    for leaf in jax.tree.leaves(jax.tree.map(
            lambda d: d["z"], st, is_leaf=lambda x: isinstance(x, dict) and "z" in x)):
        zs.extend(leaf[i, 0] for i in range(leaf.shape[0])) if leaf.ndim == 4 \
            else zs.append(leaf[0])
    return zs


def test_train_lm_matches_reference(tmp_path, capsys):
    from repro.checkpoint.manager import CheckpointManager as JManager
    from repro.configs.registry import get_config
    from repro.data.pipeline import ShardedLoader, SyntheticCorpus
    from repro.training import optimizer as jopt
    from repro.training.loop import train as jtrain
    from repro.training.schedule import warmup_cosine
    from repro_torch.configs.registry import get_config as tget
    from repro_torch.training import optimizer as topt
    from repro_torch.training import schedule as tsched
    from repro_torch.training.train_step import init_train_state

    ck = tmp_path / "ckpt"
    flags = ["--steps", "3", "--batch", "2", "--seq", "32", "--ckpt-dir", str(ck)]
    res = train_lm.main(DEV + flags)
    text = capsys.readouterr().out
    assert "model=tinylm params=" in text and "done: steps=3 loss" in text
    assert JManager(str(ck)).latest_step() == 3
    # the reference's loop from the same initial state (the port's seed-0
    # draw, bridged), optimizer, schedule and batches
    tcfg = tget("tinylm")
    sched = tsched.warmup_cosine(3e-3, warmup_steps=10, total_steps=3)
    st0 = bridge.train_state_to_jax(
        init_train_state(tcfg, topt.get_optimizer("adamw", sched), 0, "cpu"), tcfg)
    cfg = get_config("tinylm")
    opt = jopt.get_optimizer("adamw", warmup_cosine(3e-3, warmup_steps=10,
                                                    total_steps=3))
    state = {"params": jax.tree.map(jnp.asarray, st0["params"]),
             "opt": jax.tree.map(jnp.asarray, st0["opt"]),
             "step": jnp.asarray(st0["step"])}
    loader = ShardedLoader(SyntheticCorpus(vocab=cfg.vocab_size, seed=0), batch=2,
                           seq_len=32, seed=1)
    ref = jtrain(cfg, opt, loader, 3, state=state, log_every=0)
    loader.close()
    np.testing.assert_allclose(res.losses, ref.losses, rtol=2e-4, atol=2e-4)
