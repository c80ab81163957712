"""Sharded training of the port on the CPU (fp32, gloo ranks), held
against the JAX package.

* ``make_rules``, ``describe``, ``policy_for`` and the training spec
  trees equal the reference's for every arch (full and smoke) and every
  shape of ``configs/shapes.py``, on the pod and two-pod meshes (no
  spawn); ``decoder.train_specs`` is that tree.  ``TrainTP`` takes
  sequence-parallel rules.
* One (2, 2) spawn, the reference's ``prog_train_mesh.py`` setup: the
  ``yi-9b`` smoke config at ``d_model=64, d_ff=128``, heads 4/2, vocab
  256, AdamW 1e-2, 3 steps on one batch, FSDP on and off, and tinylm
  (tied, vocab-split table; KV heads not divisible by the axis) the same
  way: losses within the reference's ``rtol=atol=2e-4`` of the JAX
  single-device step on the bridged state, each rank's step-1 gradients
  within 1e-5 of each leaf's largest |g| of the JAX gradient's block,
  parameters after step 3 within ``ADAM_TOL``; per-rank bytes.  The
  other three optimizers (2 steps) against the port's one-rank update.
  Remat's gradients equal the ones without it, also with the backward
  (and its recompute's gathers) on another thread, as on the card.
  Every family with layers of its own (FSDP on; the SSM and RG-LRU
  mixers split over ``model``; DeepSeek-V3's MLA and MTP; the VLM's and
  the encoder's frontends) trains 2 steps with the losses of the port's
  one rank.
  Routed EP (Moonshot smoke) and 2-D EP (``moe_group_limit=1``) on the
  MoE block: outputs and gradients against JAX's dispatch over each data
  row's tokens, 2-D EP's output also against the reference's
  ``moe_forward`` under ``axis_rules`` on a 4-device host mesh (one JAX
  subprocess).  An elastic run's first half: one step, a checkpoint.
* One (4,) data spawn: the reference's 20-step compressed all-reduce
  check with error feedback, the first step against JAX's quantizers.
* One (1, 2) spawn: routed EP at data 1, and the elastic run's second
  half: ``plan_remesh`` to (1, 2), restore, reshard, one step, whose loss
  equals the port's one-rank run from the same checkpoint.
* ``launch.train --device cpu --mesh-shape 1x2 --tp-backend gloo``
  (the fourth spawn) against the one-device launcher.
"""
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import checkpointer as tckpt  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.configs.shapes import SHAPES as TSHAPES  # noqa: E402
from repro_torch.distributed import sharding as tshl  # noqa: E402
from repro_torch.distributed.tp import TrainTP, tree_bytes  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import policies as tpol  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402
from repro_torch.models.layers import moe as tmoe  # noqa: E402
from repro_torch.runtime import elastic as tel  # noqa: E402
from repro_torch.training import compression as tcomp  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

# The ranks import this module by name in spawned processes: the JAX
# package (the references) is imported only by the test functions, in the
# test process (``_jax``), so a rank starts with torch alone.
_J = None


def _jax():
    """The reference's modules, imported on first use."""
    global _J
    if _J is None:
        import types

        import jax
        import jax.numpy as jnp
        from jax.sharding import AbstractMesh

        from repro.configs import registry as jreg
        from repro.configs.shapes import SHAPES as JSHAPES
        from repro.distributed import sharding as jshl
        from repro.launch import policies as jpol
        from repro.models import decoder as jdec
        from repro.models.layers import ffn as jffn
        from repro.models.layers import moe as jmoe
        from repro.runtime import elastic as jel
        from repro.training import compression as jcomp
        from repro.training import optimizer as jopt
        from repro.training import train_step as jts
        from test_torch_train_step import ADAM_TOL, _assert_trees_close, _np

        _J = types.SimpleNamespace(**{k: v for k, v in locals().items()
                                      if k != "types"})
    return _J


def _use(*names):
    """Names from ``_jax()``'s namespace."""
    j = _jax()
    return tuple(getattr(j, n) for n in names)


def _cfg_pair(tag: str):
    """(reference config, port config) of a job's tag."""
    return _cfg(tag, _jax().jreg.get_config), _cfg(tag)

#: the reference's prog_train_mesh.py tolerance on the losses
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
#: a rank's gradient against the one-device gradient's block, relative to
#: the leaf's largest |g|
GRAD_REL = 1e-5
LR = 1e-2
#: ``test_torch_train_step.ADAM_TOL``'s rule (at most 0.1% of a leaf's
#: elements, each within lr / 10) at this lr
LR_ADAM_TOL = dict(rtol=1e-4, atol=1e-6, few=1e-3, few_atol=LR / 10)
#: tinylm after 3 steps at this lr falls to a loss of 0.73 on its one
#: batch, and many elements' gradients come near 0, where Adam's first
#: updates round apart: the one-device port already differs from the
#: reference on 0.18-0.36% of each matrix's elements (at most 6.4e-4),
#: beyond ``ADAM_TOL``'s 0.1%; the mesh's summation order moves the same
#: kind of elements (0.28-0.49% against the reference).  Each stays
#: within lr / 10
TINY_ADAM_TOL = dict(LR_ADAM_TOL, few=1e-2)
SRC = str(Path(__file__).parent.parent / "src")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfg(tag: str, get=tget):
    """The configs of the spawned jobs, by name (``get``: either
    package's ``get_config``)."""
    if tag == "yi":  # prog_train_mesh.py's
        return get("yi-9b", smoke=True).replace(
            d_model=64, d_ff=128, num_heads=4, num_kv_heads=2,
            vocab_size=256, dtype="float32")
    if tag == "tiny":
        return get("tinylm")
    if tag == "elastic":  # prog_elastic.py's
        return get("tinylm").replace(
            num_layers=2, d_model=32, d_ff=64, num_heads=2,
            num_kv_heads=2, head_dim=16, vocab_size=256)
    if tag == "moe":
        return get("moonshot-v1-16b-a3b", smoke=True)
    if tag == "moe2d":
        return get("moonshot-v1-16b-a3b", smoke=True).replace(moe_group_limit=1)
    if tag == "moe-drop":  # capacity that drops assignments
        return get("moonshot-v1-16b-a3b", smoke=True).replace(capacity_factor=0.5)
    if tag == "moe-drop7":  # experts not divisible by ``model``: mlp split
        return get("moonshot-v1-16b-a3b", smoke=True).replace(
            capacity_factor=0.5, num_experts=7)
    raise KeyError(tag)


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_np(v) for v in tree]
    return tree.detach().numpy().copy()


def _tree_torch(tree):
    if isinstance(tree, dict):
        return {k: _tree_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


# ---------------------------------------------------------------------------
# (a) rules, policies and spec trees (no spawn)
# ---------------------------------------------------------------------------

def _pad(spec, n):
    return tuple(spec) + (None,) * (n - len(spec))


def _ref_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _ref_leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def test_rules_policies_and_spec_trees_match_the_reference():
    jax, jreg, JSHAPES, jshl, jpol, jdec, AbstractMesh = _use(
        "jax", "jreg", "JSHAPES", "jshl", "jpol", "jdec", "AbstractMesh")
    ARCHS = jreg.ASSIGNED_ARCHS + ["tinylm"]
    for kw in (dict(phase="train"), dict(phase="train", fsdp=True),
               dict(phase="serve", seq_parallel=True, expert_2d=True,
                    kv_seq_model=True, head_dim_fallback=True)):
        assert tshl.make_rules(**kw) == jshl.make_rules(**kw)
        assert tshl.describe(tshl.make_rules(**kw)) == \
            jshl.describe(jshl.make_rules(**kw))
    n_leaves = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for arch in ARCHS:
            for smoke in ((False,) if arch == "tinylm" else (False, True)):
                cfg, tcfg = jreg.get_config(arch, smoke=smoke), \
                    tget(arch, smoke=smoke)
                jspecs, tspecs = jdec.model_specs(cfg), tdec.model_specs(tcfg)
                for name, shape in JSHAPES.items():
                    jp = jpol.policy_for(cfg, shape)
                    tp = tpol.policy_for(tcfg, TSHAPES[name])
                    assert tp.rules == jp.rules, (arch, name)
                    assert (tp.optimizer, tp.accum_steps, tp.q_chunk,
                            tp.moe_chunk_tokens) == (
                        jp.optimizer, jp.accum_steps, jp.q_chunk,
                        jp.moe_chunk_tokens), (arch, name)
                    assert (tp.griffin is None) == (jp.griffin is None)
                    if tp.griffin is not None:
                        assert (tp.griffin.sparsity, tp.griffin.tp_shards,
                                tp.griffin.per_shard_topk) == (
                            jp.griffin.sparsity, jp.griffin.tp_shards,
                            jp.griffin.per_shard_topk)
                    if shape.kind != "train":
                        continue
                    for dims, axes in (((16, 16), ("data", "model")),
                                       ((2, 16, 16), ("pod", "data", "model"))):
                        jm = AbstractMesh(dims, axes)
                        tm = tmesh.abstract_train_mesh(dims, axes)
                        want = dict(_ref_leaves(jax.tree.map(
                            lambda s: tuple(jshl.spec_for(s.axes, jp.rules, jm,
                                                          s.shape)),
                            jspecs, is_leaf=lambda x: hasattr(x, "axes"))))
                        got = bridge.ref_view(
                            tshl.tree_specs(tspecs, tm, tp.rules), tcfg)
                        shapes = dict(_ref_leaves(jax.tree.map(
                            lambda s: s.shape, jspecs,
                            is_leaf=lambda x: hasattr(x, "axes"))))
                        got = dict(_ref_leaves(got))
                        assert sorted(got) == sorted(want), (arch, dims)
                        for path, w in want.items():
                            g = got[path]
                            nd = len(shapes[path])
                            if isinstance(g, list):  # a scan-stacked leaf
                                g = (None,) + _pad(g[0], nd - 1)
                            assert _pad(g, nd) == _pad(w, nd), (arch, dims, path)
                            n_leaves += 1
                        # train_specs: the same, the SSM / RG-LRU mixers
                        # split over 'model' as the reference's rules say
                        ts = tdec.train_specs(tcfg, tm, tp.rules)
                        rs = tshl.tree_specs(tspecs, tm, tp.rules)
                        for li, d in enumerate(tdec.layer_descs(tcfg)):
                            for k, s in ts["layers"][li]["mixer"].items():
                                assert s == rs["layers"][li]["mixer"][k]
    assert n_leaves > 1000


def test_mesh_shapes_refusals_and_plans():
    (jel,) = _use("jel")
    m = tmesh.abstract_train_mesh((2, 3), ("data", "model"))
    assert m.shape == {"data": 2, "model": 3} and m.size == 6
    coords = [tmesh.TrainMesh(dims=(2, 3), rank=r).coords for r in range(6)]
    assert coords[4] == {"data": 1, "model": 1}  # row-major, as jax.make_mesh
    assert tmesh.TrainMesh(dims=(2, 3), rank=5).coord(("data", "model")) == 5
    with pytest.raises(RuntimeError, match="needs 256 cards"):
        tmesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 cards"):
        tmesh.make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="gloo"):
        tmesh.make_host_mesh((2, 2), backend="nccl", device="cpu")
    # sequence parallelism: the train step takes the rules (seq on model)
    sp = TrainTP(_cfg("yi"), m, tshl.make_rules(phase="train", seq_parallel=True))
    assert sp.rules["seq"] == ("model",) and not sp.global_experts
    x = torch.ones(2, 3)
    with tshl.axis_rules(m, tshl.make_rules(phase="train")):
        assert tshl.constrain(x, ("batch", "embed")) is x
        with pytest.raises(ValueError, match="rank"):
            tshl.constrain(x, ("batch",))
    for shape, failed in (((4, 2), [1, 3]), ((2, 2), [0]), ((2, 16, 16), [5])):
        axes = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
        assert tel.plan_remesh(shape, axes, failed).__dict__ == \
            jel.plan_remesh(shape, axes, failed).__dict__
    for mod in (tel, jel):
        with pytest.raises(RuntimeError, match="no healthy"):
            mod.plan_remesh((2, 2), ("data", "model"), [0, 1])
    assert tel.build_mesh(tel.plan_remesh((4, 2), ("data", "model"), [1, 3])) \
        == (4, (2, 2), ("data", "model"))


def test_quantizers_match_the_reference():
    jcomp, jnp = _use("jcomp", "jnp")
    rng = np.random.default_rng(0)
    for x in (rng.normal(size=(64, 64)), rng.normal(size=(7,)) * 1e-3,
              np.zeros((3, 5))):
        x = x.astype(np.float32)
        jq, js = jcomp._quantize_leaf(jnp.asarray(x))
        tq, ts = tcomp._quantize_leaf(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tcomp._dequantize_leaf(tq, ts).numpy(),
            np.asarray(jcomp._dequantize_leaf(jq, js)))


# ---------------------------------------------------------------------------
# spawned jobs (run in the ranks; everything returned is numpy)
# ---------------------------------------------------------------------------

def _paths(tree, path=()):
    """{path: leaf} of a per-layer tree (lists indexed by position)."""
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k], path + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree)
                for p, v in _paths(t, path + (str(i),)).items()}
    return {"/".join(path): tree}


def _rank(mesh, jobs):
    # the configs are tiny: one thread a rank keeps the ranks (and the
    # test workers beside them) off each other's cores
    torch.set_num_threads(1)
    return {name: globals()[fn](mesh, *args) for name, (fn, args) in jobs.items()}


def _block_slices(tp):
    shapes = _paths(tp.param_shapes)
    return {k: tp.slices(s, shapes[k].shape) for k, s in _paths(tp.param_specs).items()}


def _job_train(mesh, tag, params_np, tokens, fsdp, optname, steps, grads):
    cfg = _cfg(tag)
    rules = tshl.make_rules(phase="train", fsdp=fsdp)
    tp = TrainTP(cfg, mesh, rules)
    params = tp.shard_params(_tree_torch(params_np))
    opt = topt.get_optimizer(optname, LR)
    state = {"params": params,
             "opt": opt.init(bridge.ref_view(params, cfg), shard=tp.leaf_shards()),
             "step": torch.zeros((), dtype=torch.int32)}
    batch = {"tokens": torch.from_numpy(tokens)}
    out = {}
    if grads:
        rows = tts._rows(mesh, rules, 1)
        with tshl.axis_rules(mesh, rules):
            _, _, g = tts.value_and_grad(tdec.loss_fn, params,
                                         {"tokens": rows(batch["tokens"], 0)}, cfg)
        flat, rebuild = tts._flatten(params)
        gflat = [torch.zeros_like(p) if x is None else x
                 for p, x in zip(flat, tts._flatten(g)[0])]
        g = tp.sync_grads(rebuild(gflat))
        out["grads"] = {k: x.numpy().copy() for k, x in _paths(g).items()}
        out["slices"] = _block_slices(tp)
        out["bytes"] = (tree_bytes(params), tree_bytes(state["opt"]))
    step = tts.build_train_step(cfg, opt, mesh=mesh, rules=rules)
    losses = []
    for _ in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    full = tp.gather_params(state["params"])
    if mesh.rank == 0:
        out["params"] = _tree_np(full)
    return out


def _job_remat(mesh, params_np, tokens):
    """The yi setup with remat, FSDP on: its gradients equal the ones
    without remat, also when the backward (with the recompute's gathers)
    runs on another thread outside the mesh scope, as the card's autograd
    thread does."""
    import threading

    cfg = _cfg("yi")
    rules = tshl.make_rules(phase="train", fsdp=True)
    tp = TrainTP(cfg, mesh, rules)
    params = tp.shard_params(_tree_torch(params_np))
    batch = {"tokens": tts._rows(mesh, rules, 1)(torch.from_numpy(tokens), 0)}
    flat, rebuild = tts._flatten(params)
    out = []
    for remat, threaded in ((False, False), (True, False), (True, True)):
        leaves = [p.detach().requires_grad_(True) for p in flat]
        with tshl.axis_rules(mesh, rules):
            loss, _ = tdec.loss_fn(rebuild(leaves), batch, cfg.replace(remat=remat))
        box = []

        def back():
            box.extend(torch.autograd.grad(loss, leaves, allow_unused=True))

        if threaded:
            t = threading.Thread(target=back)
            t.start()
            t.join()
        else:
            with tshl.axis_rules(mesh, rules):
                back()
        out.append([None if g is None else g.numpy().copy() for g in box])
    return out


#: the families whose layers the other checks do not train on the mesh
#: (smollm and Command-R+ are GQA decoders, as yi)
FAMILIES = ("gemma3-27b", "mamba2-1.3b", "llava-next-34b", "recurrentgemma-9b",
            "hubert-xlarge", "deepseek-v3-671b")


def _family_batch(cfg, B=4, S=32):
    """Tokens (after prefix embeddings for a VLM; frames and targets for
    an encoder), from numpy."""
    rng = np.random.default_rng(5)
    if cfg.family == "encoder":
        return {"prefix_emb": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
                "targets": rng.integers(0, cfg.vocab_size, (B, S))}
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S))}
    if cfg.family == "vlm":
        P = cfg.num_prefix_embeddings
        out["prefix_emb"] = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    return out


def _family_losses(mesh=None, steps=2):
    """Each family's smoke config, AdamW 1e-3 from seed 0, ``steps`` steps
    on one batch: the losses (on ``mesh`` with FSDP, or one rank)."""
    out = {}
    for arch in FAMILIES:
        cfg = tget(arch, smoke=True)
        params = tdec.init_params(cfg, 0, "cpu")
        opt = topt.adamw(1e-3)
        rules = shard = None
        if mesh is not None:
            rules = tshl.make_rules(phase="train", fsdp=True)
            tp = TrainTP(cfg, mesh, rules)
            params, shard = tp.shard_params(params), tp.leaf_shards()
        state = {"params": params,
                 "opt": opt.init(bridge.ref_view(params, cfg), shard=shard),
                 "step": torch.zeros((), dtype=torch.int32)}
        step = tts.build_train_step(cfg, opt, mesh=mesh, rules=rules)
        batch = {k: torch.from_numpy(v) for k, v in _family_batch(cfg).items()}
        out[arch] = []
        for _ in range(steps):
            state, m = step(state, batch)
            out[arch].append(float(m["loss"]))
    return out


def _job_families(mesh):
    with warnings.catch_warnings():  # divisibility drops
        warnings.simplefilter("ignore")
        return _family_losses(mesh)


def _old_row_grouping(idx, chunk, cfg, mesh, rules):
    """The mutant of ``moe._global_chunks``: each data row's own stream in
    pieces of ``chunk / n_rows``, each with its own capacity."""
    n_rows = mesh.extent(tshl.batch_axes(mesh, rules))
    w = chunk // n_rows
    return [(i, i + w, w, None) for i in range(0, idx.shape[0], w)]


def _job_moe(mesh, tag, rules_kw, params_np, x_np, ct_np, chunk=16_384,
             mutant=False):
    """The MoE block on this rank's rows: y, aux, d(sum(y*ct) +
    0.01 aux)/d(x, params), parameter gradients summed over the data
    axis where the leaf is replicated over it; with ``mutant``, also y
    with the old per-row grouping of the dispatch without EP."""
    from repro_torch.distributed.tp import block_of, block_slices

    cfg = _cfg(tag)
    rules = tshl.make_rules(phase="train", **rules_kw)
    specs = _paths(tshl.tree_specs(tmoe.moe_specs(cfg), mesh, rules))
    full = _paths(_tree_torch(params_np))
    keys = sorted(full)
    local = {k: block_of(full[k], specs[k], mesh).requires_grad_(True) for k in keys}
    tree = {}
    for k, v in local.items():  # back to the nested tree
        node, parts = tree, k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    axes = tshl.batch_axes(mesh, rules)
    nd, r = mesh.extent(axes), mesh.coord(axes)
    w = x_np.shape[0] // nd
    rows = slice(r * w, (r + 1) * w)
    x = torch.from_numpy(x_np[rows]).requires_grad_(True)
    ct = torch.from_numpy(ct_np[rows])
    with tshl.axis_rules(mesh, rules):
        y, aux, _ = tmoe.moe_forward(tree, x, cfg, chunk_tokens=chunk)
        loss = (y * ct).sum() + 0.01 * aux
        gs = torch.autograd.grad(loss, [x] + [local[k] for k in keys])
        y_mut = None
        if mutant:
            good, tmoe._global_chunks = tmoe._global_chunks, _old_row_grouping
            try:
                y_mut = tmoe.moe_forward(tree, x, cfg, chunk_tokens=chunk)[0]
            finally:
                tmoe._global_chunks = good
            y_mut = y_mut.detach().numpy()
    gp = {}
    for k, g in zip(keys, gs[1:]):
        if "data" not in str(specs[k]) and nd > 1:
            g = tshl.all_reduce_(g.contiguous(), mesh.group("data"))
        gp[k] = g.numpy()
    return {"y": y.detach().numpy(), "aux": float(aux.detach()), "y_mut": y_mut,
            "gx": gs[0].numpy(), "gp": gp, "rows": rows,
            "slices": {k: block_slices(specs[k], full[k].shape, mesh) for k in keys}}


def _job_elastic_save(mesh, ckdir, params_np, tokens):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.training.loop import train

    cfg = _cfg("elastic")
    rules = tshl.make_rules(phase="train", fsdp=False)
    tp = TrainTP(cfg, mesh, rules)
    params = tp.shard_params(_tree_torch(params_np))
    opt = topt.adamw(LR)
    state = {"params": params,
             "opt": opt.init(bridge.ref_view(params, cfg), shard=tp.leaf_shards()),
             "step": torch.zeros((), dtype=torch.int32)}
    mgr = CheckpointManager(ckdir, interval=1, use_async=False)
    res = train(cfg, opt, [{"tokens": tokens}], 1, ckpt=mgr, state=state,
                log_every=0, mesh=mesh, rules=rules)
    return res.losses


def _job_elastic_resume(mesh, ckdir, tokens):
    cfg = _cfg("elastic")
    rules = tshl.make_rules(phase="train", fsdp=False)
    plan = tel.plan_remesh((2, 2), ("data", "model"), failed_data_rows=[1])
    assert tel.build_mesh(plan)[1:] == (mesh.dims, mesh.axes)
    restored, step_n = tckpt.restore(ckdir)
    tp = TrainTP(cfg, mesh, rules)
    state = bridge.train_state_from_jax(restored, cfg, "cpu", tp=tp)
    cut = tel.reshard(bridge.params_from_jax(restored["params"], cfg, "cpu"),
                      tdec.model_specs(cfg), mesh, rules)
    same = all(torch.equal(a, b) for a, b in zip(tts._flatten(cut)[0],
                                                 tts._flatten(state["params"])[0]))
    nb = int(tokens.shape[0] * plan.global_batch_scale)
    step = tts.build_train_step(cfg, topt.adamw(LR), mesh=mesh, rules=rules)
    _, m = step(state, {"tokens": torch.from_numpy(tokens[:nb])})
    return {"loss": float(m["loss"]), "step": step_n, "reshard_same": same}


def _job_compression(mesh, steps):
    rng = np.random.default_rng(0)
    g_host = rng.normal(size=(64, 64)).astype(np.float32)
    allreduce = tcomp.make_compressed_allreduce(mesh, "data")
    r = mesh.coord("data")
    out = {}
    for same in (True, False):  # the reference's identical grads, then distinct
        residual = tcomp.init_residual({"w": torch.zeros(64, 64)})
        true_acc = np.zeros_like(g_host)
        comp_acc = np.zeros_like(g_host)
        first = None
        for step in range(steps):
            base = g_host * (1 + 0.1 * step)
            mine = base if same else base + 0.05 * r
            mean, residual = allreduce({"w": torch.from_numpy(mine)}, residual)
            true_acc += base if same else base + 0.05 * (mesh.shape["data"] - 1) / 2
            comp_acc += mean["w"].numpy()
            if first is None:
                first = mean["w"].numpy().copy()
        out[same] = (float(np.abs(comp_acc - true_acc).max() / np.abs(true_acc).max()),
                     first)
    return out


def _spawn(shape, axes, jobs):
    res, _ = tmesh.run_ranks(_rank, int(np.prod(shape)), backend="gloo",
                             device="cpu", shape=shape, axes=axes, args=(jobs,),
                             timeout_s=300)
    return res


# ---------------------------------------------------------------------------
# JAX references (the single device)
# ---------------------------------------------------------------------------

def _init(tag):
    jax, jnp, _np = _use("jax", "jnp", "_np")
    cfg, tcfg = _cfg_pair(tag)
    tp = tdec.init_params(tcfg, 0, "cpu")
    return cfg, tcfg, tp, jax.tree.map(jnp.asarray, _np(bridge.params_to_jax(tp, tcfg)))


def _jax_run(cfg, jp, tokens, steps, lr=LR):
    jax, jnp, jopt, jdec, jts = _use("jax", "jnp", "jopt", "jdec", "jts")
    opt = jopt.adamw(lr)
    b = {"tokens": jnp.asarray(tokens)}
    g = jax.jit(jax.grad(lambda p: jdec.loss_fn(p, b, cfg)[0]))(jp)
    st = {"params": jp, "opt": opt.init(jp), "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jts.build_train_step(cfg, opt))
    losses = []
    for _ in range(steps):
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    return losses, g, st["params"]


def _moe_ref(cfg, p, x, ct, nd, ep2d=False):
    """JAX: the MoE block with each data row's tokens dispatched on their
    own (``_dispatch_combine``; 2-D EP: within the row's experts), the
    router's loss over the whole batch (2-D EP: the mean of the rows')."""
    jax, jnp, jmoe, jffn = _use("jax", "jnp", "jmoe", "jffn")
    def f(p, x):
        B, S, D = x.shape
        E, k = cfg.num_experts, cfg.experts_per_token
        xt = x.reshape(B * S, D)
        T = xt.shape[0] // nd
        ys, auxes = [], []
        if not ep2d:
            gate, idx, aux = jmoe._route(p, xt, cfg)
        for r in range(nd):
            sl = slice(r * T, (r + 1) * T)
            if not ep2d:
                ys.append(jmoe._dispatch_combine(p, xt[sl], gate[sl], idx[sl], cfg))
                continue
            E_row = E // nd
            ids = r * E_row + jnp.arange(E_row)
            logits = jnp.einsum("td,de->te", xt[sl].astype(jnp.float32), p["router"])
            probs = jax.nn.softmax(logits[:, ids], -1)
            g, i = jax.lax.top_k(probs, k)
            g = g / jnp.maximum(jnp.sum(g, -1, keepdims=True), 1e-9)
            me = jnp.mean(jax.nn.softmax(logits, -1), 0)
            fe = jnp.mean(jax.nn.one_hot(ids[i[:, 0]], E, dtype=jnp.float32), 0)
            auxes.append(E * jnp.sum(me * fe))
            wp = {kk: p[kk][ids] for kk in ("w1", "w2", "wg") if kk in p}
            ys.append(jmoe._dispatch_combine_local(wp, xt[sl], g, i, cfg, 0, E_row,
                                                   cap_experts=E_row))
        if ep2d:
            aux = jnp.mean(jnp.stack(auxes))
        y = jnp.concatenate(ys).reshape(B, S, D)
        y = y + jffn.ffn_forward(p["shared"], x, cfg)[0]
        return jnp.sum(y * ct) + 0.01 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    return np.asarray(y), float(aux), jax.tree.map(np.asarray, gp), np.asarray(gx)


_MESH_MOE_PROG = r'''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"
import jax, numpy as np
from repro.distributed import sharding as shlib
from repro.models.layers import moe
from repro.configs.registry import get_config
d = np.load(sys.argv[1], allow_pickle=True)
out = {}
for name, s in d["setups"].item().items():
    cfg = get_config("moonshot-v1-16b-a3b", smoke=True).replace(**s["cfg"])
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(s["shape"]), s["axes"])
    rules = shlib.make_rules(phase="train", **s["rules"])
    def f(p, x):
        with shlib.axis_rules(mesh, rules):
            y, aux, _ = moe.moe_forward(p, x, cfg, chunk_tokens=s["chunk"])
        return jax.numpy.sum(y * s["ct"]) + 0.01 * aux, (y, aux)
    (_, (y, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jax.tree.map(jax.numpy.asarray, s["params"]),
                                          s["x"])
    out[name] = np.array(dict(y=np.asarray(y), aux=float(aux), gx=np.asarray(gx),
                              gp=jax.tree.map(np.asarray, gp)), dtype=object)
np.savez(sys.argv[2], **out)
'''


def _moe_on_jax_mesh(tmp_path, setups):
    """The reference's ``moe_forward`` under ``axis_rules`` on host meshes
    of 4 CPU devices, for each of ``setups`` (``{name: {cfg, shape,
    axes, rules, chunk, params, x, ct}}``), in one subprocess."""
    inp, out = tmp_path / "moe_in.npz", tmp_path / "moe_out.npz"
    np.savez(inp, setups=np.array(setups, dtype=object))
    env = dict(os.environ, PYTHONPATH=SRC)
    env.pop("XLA_FLAGS", None)
    return subprocess.Popen([sys.executable, "-c", _MESH_MOE_PROG, str(inp), str(out)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True), out


def _n_dropped(cfg, params_np, x, width, n_cap):
    """Assignments beyond their expert's capacity when the token stream of
    ``x`` is dispatched in groups of ``width`` tokens at the capacity of
    ``n_cap`` tokens (the port's router: the reference's)."""
    xt = torch.from_numpy(x.reshape(-1, x.shape[-1]))
    idx = tmoe._route(_tree_torch(params_np), xt, cfg, want_aux=False)[1].numpy()
    C = tmoe._capacity(n_cap, cfg)
    groups = idx.reshape(-1, width * cfg.experts_per_token)
    counts = np.stack([np.bincount(g, minlength=cfg.num_experts) for g in groups])
    return int(np.maximum(counts - C, 0).sum())


def _check_grads(res, jg_port, what):
    """Each rank's gradient of each leaf within ``GRAD_REL`` of the leaf's
    largest |g| of the one-device gradient's block."""
    want = {k: x.numpy() for k, x in _paths(jg_port).items()}
    for r, out in enumerate(res):
        assert sorted(out["grads"]) == sorted(want), what
        for i, (g, sl, w) in enumerate((out["grads"][k], out["slices"][k], want[k])
                                       for k in sorted(want)):
            blk = w[sl]
            assert g.shape == blk.shape, (what, r, i)
            scale = max(np.abs(w).max(), 1e-30)
            np.testing.assert_allclose(g, blk, rtol=0, atol=GRAD_REL * scale,
                                       err_msg=f"{what} rank {r} leaf {i}")


def _check_moe(outs, y, aux, gp, gx):
    (jax,) = _use("jax")
    want = {k: np.asarray(v) for k, v in _paths(jax.tree.map(np.asarray, gp)).items()}
    for o in outs:
        np.testing.assert_allclose(o["y"], y[o["rows"]], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["aux"], aux, rtol=1e-5)
        np.testing.assert_allclose(o["gx"], gx[o["rows"]], rtol=1e-4, atol=1e-6)
        assert sorted(o["gp"]) == sorted(want)
        for k, w in want.items():
            np.testing.assert_allclose(o["gp"][k], w[o["slices"][k]], rtol=0,
                                       atol=GRAD_REL * np.abs(w).max(), err_msg=k)


# ---------------------------------------------------------------------------
# the spawned checks
# ---------------------------------------------------------------------------

def test_sharded_training_matches_the_reference(tmp_path):
    jax, jnp, jcomp, _np, _assert_trees_close, ADAM_TOL = _use(
        "jax", "jnp", "jcomp", "_np", "_assert_trees_close", "ADAM_TOL")
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (4, 32)).astype(np.int64)
    inits = {tag: tdec.init_params(_cfg(tag), 0, "cpu")
             for tag in ("yi", "tiny", "elastic")}
    jobs = {}
    for tag in ("yi", "tiny"):
        for fsdp in (True, False):
            jobs[f"{tag}-{fsdp}"] = ("_job_train", (tag, _tree_np(inits[tag]),
                                                    tokens, fsdp, "adamw", 3, True))
    for name in ("adafactor", "adam8bit", "sgdm"):
        jobs[f"yi-{name}"] = ("_job_train", ("yi", _tree_np(inits["yi"]), tokens,
                                             True, name, 2, False))
    jobs["remat"] = ("_job_remat", (_tree_np(inits["yi"]), tokens))
    jobs["families"] = ("_job_families", ())
    # MoE blocks: routed EP, and 2-D EP (moe_group_limit=1, experts over
    # (data, model))
    mcfg, mtcfg = _cfg_pair("moe")
    mp = _tree_np(tparam.init_params(tmoe.moe_specs(mtcfg), 0, "float32", "cpu"))
    x = rng.normal(size=(4, 8, 64)).astype(np.float32)
    ct = rng.normal(size=(4, 8, 64)).astype(np.float32)
    jobs["ep"] = ("_job_moe", ("moe", {}, mp, x, ct))
    jobs["ep2d"] = ("_job_moe", ("moe2d", {"expert_2d": True}, mp, x, ct))
    # the global stream in several chunks (of 64 or 128 of its 256 tokens)
    # with assignments dropped: routed EP at (2, 2); the dispatch without
    # EP with the experts' hidden width over ``model`` (7 experts) at
    # (2, 2), and on the data-parallel (4,) mesh with chunks across rows
    xd = rng.normal(size=(4, 64, 64)).astype(np.float32)
    ctd = rng.normal(size=(4, 64, 64)).astype(np.float32)
    pd = {tag: _tree_np(tparam.init_params(tmoe.moe_specs(_cfg(tag)), 1,
                                           "float32", "cpu"))
          for tag in ("moe-drop", "moe-drop7")}
    jobs["ep-chunks"] = ("_job_moe", ("moe-drop", {}, pd["moe-drop"], xd, ctd, 64))
    jobs["partial-chunks"] = ("_job_moe", ("moe-drop7", {}, pd["moe-drop7"], xd,
                                           ctd, 64, True))
    dp_jobs = {"c": ("_job_compression", (20,)),
               "dp-chunks": ("_job_moe", ("moe-drop", {}, pd["moe-drop"], xd, ctd,
                                          128, True))}
    chunked = {"ep-chunks": ("moe-drop", (2, 2), ("data", "model"), 64),
               "partial-chunks": ("moe-drop7", (2, 2), ("data", "model"), 64),
               "dp-chunks": ("moe-drop", (4,), ("data",), 128)}
    overrides = {"moe-drop": dict(capacity_factor=0.5),
                 "moe-drop7": dict(capacity_factor=0.5, num_experts=7)}
    setups = {"ep2d": dict(cfg=dict(moe_group_limit=1), shape=(2, 2),
                           axes=("data", "model"), rules=dict(expert_2d=True),
                           chunk=16_384, params=mp, x=x, ct=ct)}
    for name, (tag, shape, axes, chunk) in chunked.items():
        setups[name] = dict(cfg=overrides[tag], shape=shape, axes=axes, rules={},
                            chunk=chunk, params=pd[tag], x=xd, ct=ctd)
    # the elastic run's first half
    etok = rng.integers(0, 256, (8, 32)).astype(np.int64)
    ck = str(tmp_path / "ckpt")
    jobs["elastic"] = ("_job_elastic_save", (ck, _tree_np(inits["elastic"]), etok))

    # the (2, 2) and (4,) meshes, the reference's 2-D EP on a JAX mesh and
    # the single-device references run at the same time
    proc, mesh_out = _moe_on_jax_mesh(tmp_path, setups)
    with ThreadPoolExecutor(2) as ex:
        f22 = ex.submit(_spawn, (2, 2), ("data", "model"), jobs)
        f4 = ex.submit(_spawn, (4,), ("data",), dp_jobs)
        refs, one_rank = {}, {}
        for tag in ("yi", "tiny"):
            cfg, tcfg, _, jp = _init(tag)
            refs[tag] = (tcfg, _jax_run(cfg, jp, tokens, 3))
        tcfg = refs["yi"][0]
        for name in ("adafactor", "adam8bit", "sgdm"):
            opt = topt.get_optimizer(name, LR)
            p1 = tdec.init_params(tcfg, 0, "cpu")
            st = {"params": p1, "opt": opt.init(bridge.ref_view(p1, tcfg)),
                  "step": torch.zeros((), dtype=torch.int32)}
            step = tts.build_train_step(tcfg, opt)
            ls = []
            for _ in range(2):
                st, m = step(st, {"tokens": torch.from_numpy(tokens)})
                ls.append(float(m["loss"]))
            one_rank[name] = (ls, _tree_np(p1))
        families = _family_losses()
        moe_refs = {ep2d: _moe_ref(mcfg, mp, x, ct, 2, ep2d) for ep2d in (False, True)}
        moe_ref1 = _moe_ref(mcfg, mp, x, ct, 1)
        res, comp = f22.result(), f4.result()

    for tag in ("yi", "tiny"):
        tcfg, (jl, jg, jparams) = refs[tag]
        jg_port = bridge.params_from_jax(jax.tree.map(np.asarray, jg), tcfg, "cpu")
        for fsdp in (True, False):
            outs = [r[f"{tag}-{fsdp}"] for r in res]
            for o in outs:
                np.testing.assert_allclose(o["losses"], jl, **LOSS_TOL)
            _check_grads(outs, jg_port, f"{tag} fsdp={fsdp}")
            got = bridge.params_to_jax(_tree_torch(outs[0]["params"]), tcfg)
            _assert_trees_close(_np(got), jparams,
                                TINY_ADAM_TOL if tag == "tiny" else LR_ADAM_TOL,
                                f"{tag} fsdp={fsdp}")
            if tag == "yi" and fsdp:
                # every matrix of the layers is split on both axes: ~1/4
                whole = sum(p.numel() * 4 for p in tts._flatten(
                    tdec.init_params(tcfg, 0, "cpu"))[0])
                pb, ob = outs[0]["bytes"]
                assert whole / 4 <= pb < whole / 3, (pb, whole)
                assert ob == 2 * pb + 4  # AdamW's m and v in fp32, the step
    for r in res:  # remat, and its recompute on another thread, change nothing
        base, remat, threaded = r["remat"]
        assert len(base) == len(remat) == len(threaded) and len(base) > 10
        for a, b, c in zip(base, remat, threaded):
            assert (a is None) == (b is None) == (c is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(b, c)
    for arch, ls in families.items():  # every other family on the mesh
        for r in res:
            np.testing.assert_allclose(r["families"][arch], ls, err_msg=arch,
                                       **LOSS_TOL)
    tcfg = refs["yi"][0]
    for name, (ls, p1) in one_rank.items():
        o = res[0][f"yi-{name}"]
        np.testing.assert_allclose(o["losses"], ls, rtol=1e-5, atol=1e-6)
        tol = dict(rtol=1e-4, atol=1e-6)
        if name == "adam8bit":  # codes of a block that rounds apart
            tol = dict(ADAM_TOL, few=3e-3, few_atol=3e-3)
        _assert_trees_close(_np(bridge.params_to_jax(_tree_torch(o["params"]), tcfg)),
                            _np(bridge.params_to_jax(_tree_torch(p1), tcfg)), tol, name)

    for job, ep2d in (("ep", False), ("ep2d", True)):
        _check_moe([r[job] for r in res], *moe_refs[ep2d])
    _, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    jm = {k: v.item() for k, v in np.load(mesh_out, allow_pickle=True).items()}
    for r in res:
        o = r["ep2d"]
        np.testing.assert_allclose(o["y"], jm["ep2d"]["y"][o["rows"]], rtol=1e-5,
                                   atol=1e-6)
    # several global chunks, assignments dropped: routed EP's blocks of
    # chunk / n_data tokens, the dispatch without EP's global chunks
    for name, (tag, shape, _, chunk) in chunked.items():
        cfg, ref, n_data = _cfg(tag), jm[name], shape[0]
        width = chunk // n_data if name == "ep-chunks" else chunk
        assert _n_dropped(cfg, pd[tag], xd, width, width) > 0, name
        outs = [r[name] for r in (comp if name == "dp-chunks" else res)]
        _check_moe(outs, ref["y"], ref["aux"], ref["gp"], ref["gx"])
        if name != "ep-chunks":  # the old per-row grouping misses y
            for o in outs:
                assert not np.allclose(o["y_mut"], ref["y"][o["rows"]],
                                       rtol=1e-5, atol=1e-6), name

    # elastic, the second half: (1, 2) after losing data row 1; and routed
    # EP at data 1; then the port's one rank from the same checkpoint
    etcfg = _cfg("elastic")
    res12 = _spawn((1, 2), ("data", "model"), {
        "resume": ("_job_elastic_resume", (ck, etok)),
        "ep": ("_job_moe", ("moe", {}, mp, x, ct))})
    restored, n = tckpt.restore(ck)
    assert n == 1
    # the checkpoint is the gathered state of the one-device step
    st = {"params": tdec.init_params(etcfg, 0, "cpu")}
    opt = topt.adamw(LR)
    st = {"params": st["params"], "opt": opt.init(bridge.ref_view(st["params"], etcfg)),
          "step": torch.zeros((), dtype=torch.int32)}
    st, m = tts.build_train_step(etcfg, opt)(st, {"tokens": torch.from_numpy(etok)})
    for r in res:
        np.testing.assert_allclose(r["elastic"], [float(m["loss"])], **LOSS_TOL)
    _assert_trees_close(_np(bridge.train_state_to_jax(st, etcfg)["params"]),
                        restored["params"], LR_ADAM_TOL, "checkpoint")
    one = bridge.train_state_from_jax(restored, etcfg, "cpu")
    _, m1 = tts.build_train_step(etcfg, topt.adamw(LR))(
        one, {"tokens": torch.from_numpy(etok[:4])})
    for r in res12:
        assert r["resume"]["step"] == 1 and r["resume"]["reshard_same"]
        np.testing.assert_allclose(r["resume"]["loss"], float(m1["loss"]), rtol=1e-5)
    _check_moe([r["ep"] for r in res12], *moe_ref1)

    # compression: the reference's check, and the first mean of distinct
    # gradients against JAX's quantizers
    g_host = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    want = np.mean([np.asarray(jcomp._dequantize_leaf(*jcomp._quantize_leaf(
        jnp.asarray(g_host + 0.05 * r)))) for r in range(4)], axis=0)
    for r in comp:
        rel_same, _ = r["c"][True]
        rel_diff, first = r["c"][False]
        assert rel_same < 2e-2 and rel_diff < 2e-2, (rel_same, rel_diff)
        np.testing.assert_allclose(first, want, rtol=1e-6, atol=1e-6)


def test_mesh_launcher_matches_the_one_device_launcher(capsys):
    argv = ["--arch", "tinylm", "--steps", "3", "--batch", "4", "--seq", "16",
            "--device", "cpu"]
    one = tlaunch.main(argv)
    mesh = tlaunch.main(argv + ["--mesh-shape", "1x2", "--tp-backend", "gloo"])
    out = capsys.readouterr().out
    assert "[mesh] data=1 model=2: 2 ranks on gloo (cpu)" in out
    assert len(mesh) == 3
    np.testing.assert_allclose(mesh, one, **LOSS_TOL)
    with pytest.raises(SystemExit):
        tlaunch.main(["--mesh", "pod", "--device", "cpu"])
    assert "needs 256 cards" in capsys.readouterr().err
