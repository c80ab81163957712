"""The production mesh's remaining layouts in the port, on the CPU (fp32,
gloo ranks), held against the JAX package.

* Experts over ``(data, model)`` without a group limit (DeepSeek-V3's
  production rules): the MoE block at (2, 2), with a capacity factor that
  drops assignments, in one chunk and in chunks of 64 tokens (each a
  data row's), equals the reference's single-device ``moe_forward``:
  outputs, the router's loss and the gradients of each rank's blocks.
  A train step of the smoke config at (2, 2) gives the loss and, on
  every rank, the synced gradient blocks of the reference's
  single-device step; two mutants of the gradients' ownership (the
  token gather's backward without its sum, the MTP block's 1/n dropped)
  miss them.
* Init on the mesh: each rank's blocks of every leaf are bit-equal to the
  one-device draw, with the slicing threshold lowered so that the smoke
  config's leaves are drawn in slices (no spawn).
* The SSM and RG-LRU mixers split over ``model`` at (1, 2): Mamba2's and
  RecurrentGemma's smoke configs, prefill and three decode steps against
  the reference's forward and decode (``TOL``).  A Mamba2 variant whose
  3 heads do not divide over ``model`` while its conv, norm and
  out-projection do (``ODD_SSM``): those leaves are gathered and each
  rank runs the mixer whole: its logits, and a train step's loss and
  gradient blocks (with and without sequence parallelism), against the
  reference's forward, decode and single-device step (the gradients
  also against the port's one rank); Mamba2's smoke cells (8 heads, 160
  conv columns) step on the dry mesh at (1, 16) and (16, 16).
* An int8 cache split over ``head_dim``: a block's codes and scales equal
  the reference's ``quantize_kv`` of the whole head, and a decode step
  of tinylm at (1, 2) under the decode fallback writes the one-device
  codes and scales.
* Sequence parallelism at (2, 2): train steps (Yi-9B's smoke setup with
  FSDP, and DeepSeek-V3's smoke config with its experts over (data,
  model), MLA and MTP) against the reference's single-device step, losses
  and gradients, every other family's stack against the port's one rank, and a prefill
  cell's logits against the one-device prefill.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig  # noqa: E402
from repro_torch.core.griffin import GriffinConfig  # noqa: E402
from repro_torch.distributed import sharding as tshl  # noqa: E402
from repro_torch.distributed.tp import TrainTP, block_of, block_slices  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import policies as tpol  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402
from repro_torch.models.layers import moe as tmoe  # noqa: E402
from repro_torch.serving import steps as tsteps  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.training import train_step as tts  # noqa: E402

#: the reference's prog_train_mesh.py tolerance on the losses
LOSS_TOL = dict(rtol=2e-4, atol=2e-4)
#: the MoE block against the reference (``test_torch_train_mesh``'s)
MOE_TOL = dict(rtol=1e-5, atol=1e-6)
#: fp32 on the CPU: the mesh sums partial products in another order
TOL = dict(rtol=1e-4, atol=1e-5)
#: a rank's gradient against the one-device gradient's block, relative to
#: the leaf's largest |g|
GRAD_REL = 1e-5
#: a leaf's gradient below this share of the tree's largest |g| is held
#: to ``GRAD_REL`` of that share (a key bias's gradient is zero: softmax
#: ignores what it adds to every score of a query)
ZERO_GRAD = 1e-3
#: a rank's gradient against the reference's single-device gradient where
#: the leaves are small enough that ``GRAD_REL`` of their own largest |g|
#: is float32 rounding (``ODD_SSM``'s 3-element ``dt_bias``): the one
#: device's tolerance (``test_torch_train_step.GRAD_TOL``)
JAX_GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LR = 1e-2
MOE_CHUNKS = (64, 16_384)
#: gradients of DeepSeek-V3's smoke step with their ownership broken, each
#: of which must miss the reference's: (job, rules, ``_job_train`` mutant)
GRAD_MUTANTS = (("train2d", {"expert_2d": True}, "no_gather_sum"),
                ("sp_ds", {"expert_2d": True, "seq_parallel": True}, "no_grad_scale"))
RECURRENT = ("mamba2-1.3b", "recurrentgemma-9b")
#: Mamba2's smoke config at d_model 48, head_dim 32: 3 heads (whole at
#: (1, 2)), conv_dim 128 and d_in 96 (split), w_in's 227 columns (whole)
ODD_SSM = "mamba2-odd-heads"
#: ``ODD_SSM``'s train steps at (1, 2): rules of each
ODD_TRAIN = {"odd_train": {}, "odd_train_sp": {"seq_parallel": True}}
REC_PROMPT, REC_STEPS = 12, 3


def _cfg(tag: str, get=tget):
    if tag == "ds":  # drops assignments: 8 slots an expert for 128 of 8 experts
        return get("deepseek-v3-671b", smoke=True).replace(capacity_factor=0.5)
    if tag == "yi":  # prog_train_mesh.py's
        return get("yi-9b", smoke=True).replace(
            d_model=64, d_ff=128, num_heads=4, num_kv_heads=2,
            vocab_size=256, dtype="float32")
    if tag == "tiny8":
        return get("tinylm").replace(kv_cache_int8=True)
    if tag == ODD_SSM:
        return get("mamba2-1.3b", smoke=True).replace(d_model=48, ssm_head_dim=32)
    return get(tag, smoke=True)


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


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return {p: v for k in tree for p, v in _paths(tree[k], path + (k,)).items()}
    if isinstance(tree, list):
        return {p: v for i, t in enumerate(tree)
                for p, v in _paths(t, path + (str(i),)).items()}
    return {"/".join(path): tree}


# ---------------------------------------------------------------------------
# spawned jobs (everything returned is numpy)
# ---------------------------------------------------------------------------

def _rank(mesh, jobs):
    torch.set_num_threads(1)
    return {name: globals()[fn](mesh, *args) for name, (fn, args) in jobs.items()}


def _job_moe(mesh, params_np, x_np, ct_np, chunk):
    """DeepSeek-V3's MoE block on this rank's rows, experts over (data,
    model): y, aux, d(sum(y*ct) + 0.01 aux)/d(x, params), the parameter
    gradients summed over ``data`` where the leaf is replicated over it."""
    cfg = _cfg("ds")
    rules = tshl.make_rules(phase="train", expert_2d=True)
    specs = _paths(tshl.tree_specs(tmoe.moe_specs(cfg), mesh, rules))
    full = _paths(_tree_torch(params_np))
    keys = sorted(full)
    local = {k: block_of(full[k], specs[k], mesh).requires_grad_(True) for k in keys}
    tree = {}
    for k, v in local.items():
        node, parts = tree, k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    nd, r = mesh.extent("data"), mesh.coord("data")
    w = x_np.shape[0] // nd
    rows = slice(r * w, (r + 1) * w)
    x = torch.from_numpy(x_np[rows]).requires_grad_(True)
    ct = torch.from_numpy(ct_np[rows])
    with tshl.axis_rules(mesh, rules):
        y, aux, _ = tmoe.moe_forward(tree, x, cfg, chunk_tokens=chunk)
        loss = (y * ct).sum() + 0.01 * aux
        gs = torch.autograd.grad(loss, [x] + [local[k] for k in keys])
    gp = {}
    for k, g in zip(keys, gs[1:]):
        if "data" not in str(specs[k]):
            g = tshl.all_reduce_(g.contiguous(), mesh.group("data"))
        gp[k] = g.numpy()
    return {"y": y.detach().numpy(), "aux": float(aux.detach()),
            "gx": gs[0].numpy(), "gp": gp, "rows": rows,
            "slices": {k: block_slices(specs[k], full[k].shape, mesh) for k in keys}}


def _job_train(mesh, tag, params_np, tokens, rules_kw, steps, mutant=None):
    """``steps`` AdamW steps of ``tag``'s config on one batch: the losses,
    and the first step's gradients as ``TrainTP.sync_grads`` leaves them
    (this rank's blocks).  ``mutant`` breaks the gradients' ownership:
    ``no_gather_sum`` keeps each rank's partial gradient of the gathered
    chunk (the experts' token gather without its reduce-scatter),
    ``no_grad_scale`` drops the MTP block's 1/n scale."""
    cfg = _cfg(tag)
    rules = tshl.make_rules(phase="train", **rules_kw)
    tp = TrainTP(cfg, mesh, rules)
    params = tp.shard_params(_tree_torch(params_np))
    opt = topt.adamw(LR)
    state = {"params": params,
             "opt": opt.init(bridge.ref_view(params, cfg), shard=tp.leaf_shards()),
             "step": torch.zeros((), dtype=torch.int32)}
    step = tts.build_train_step(cfg, opt, mesh=mesh, rules=rules)
    got = _capture_grads(step)
    real = tdec._GradScale.apply, tshl.exchange_in
    if mutant == "no_grad_scale":
        tdec._GradScale.apply = lambda t, s: t
    if mutant == "no_gather_sum":
        tshl.exchange_in = lambda x, pos, n, owners, summers: real[1](x, pos, n, owners, ())
    try:
        losses = []
        for _ in range(steps):
            state, m = step(state, {"tokens": torch.from_numpy(tokens)})
            losses.append(float(m["loss"]))
    finally:
        tdec._GradScale.apply, tshl.exchange_in = real
    return {"losses": losses, **got}


def _capture_grads(step):
    """Wraps the step's ``sync_grads``: its first call's gradients (this
    rank's blocks, numpy) and their slices of the global leaves go in the
    dict returned."""
    tp, got = step.tp, {}
    real = tp.sync_grads

    def sync(grads, seq_parallel=False):
        grads = real(grads, seq_parallel)
        if not got:
            shapes = _paths(tp.param_shapes)
            got["grads"] = {k: x.detach().numpy().copy() for k, x in _paths(grads).items()}
            got["slices"] = {k: tp.slices(s, shapes[k].shape)
                             for k, s in _paths(tp.param_specs).items()}
        return grads

    tp.sync_grads = sync
    return got


def _one_rank_grads(cfg, params, batch):
    """The plain step's gradients (one device): the whole leaves, numpy."""
    _, _, g = tts.value_and_grad(tdec.loss_fn, params, batch, cfg)
    flat, rebuild = tts._flatten(params)
    g = rebuild([torch.zeros_like(p) if x is None else x
                 for p, x in zip(flat, tts._flatten(g)[0])])
    return {k: x.numpy().copy() for k, x in _paths(g).items()}


def _grad_misses(out, want):
    """The leaves of a rank's synced blocks (``_capture_grads``) farther
    than ``GRAD_REL`` of the leaf's largest |g| from the same block of
    the one-device gradient ``want`` (a leaf whose gradient is zero but
    for rounding, as an attention key bias's: of ``ZERO_GRAD`` times the
    tree's largest |g|)."""
    assert sorted(out["grads"]) == sorted(want)
    top = max(float(np.abs(w).max()) for w in want.values())
    bad = []
    for k, w in want.items():
        blk = w[out["slices"][k]]
        g = out["grads"][k]
        assert g.shape == blk.shape, k
        scale = max(float(np.abs(w).max()), ZERO_GRAD * top)
        if not np.allclose(g, blk, rtol=0, atol=GRAD_REL * scale):
            bad.append(k)
    return bad


def _family_sp_losses(mesh=None):
    """Each family's smoke config (``test_torch_train_mesh.FAMILIES``: the
    local-attention, SSM, VLM, RG-LRU, encoder and MLA/MoE/MTP stacks), one
    AdamW step from seed 0 under sequence-parallel rules with FSDP (or on
    one rank without a mesh): the losses and the step's gradients (on the
    mesh, as ``_job_train``; on one rank, the whole leaves)."""
    from test_torch_train_mesh import FAMILIES, _family_batch

    out = {}
    for arch in FAMILIES:
        cfg = tget(arch, smoke=True)
        params = tdec.init_params(cfg, 0, "cpu")
        opt = topt.adamw(1e-3)
        rules = shard = None
        if mesh is not None:
            rules = tshl.make_rules(phase="train", fsdp=True, seq_parallel=True)
            tp = TrainTP(cfg, mesh, rules)
            params, shard = tp.shard_params(params), tp.leaf_shards()
        state = {"params": params,
                 "opt": opt.init(bridge.ref_view(params, cfg), shard=shard),
                 "step": torch.zeros((), dtype=torch.int32)}
        step = tts.build_train_step(cfg, opt, mesh=mesh, rules=rules)
        batch = {k: torch.from_numpy(v) for k, v in _family_batch(cfg).items()}
        got = _capture_grads(step) if mesh is not None else \
            {"grads": _one_rank_grads(cfg, params, batch)}
        state, m = step(state, batch)
        out[arch] = {"losses": [float(m["loss"])], **got}
    return out


def _job_sp_families(mesh):
    import warnings

    with warnings.catch_warnings():  # divisibility drops
        warnings.simplefilter("ignore")
        return _family_sp_losses(mesh)


def _job_sp_prefill(mesh):
    """Yi-9B's smoke prefill cell under ``seq_parallel`` rules: this
    rank's block of the last logits, its rows and vocabulary columns."""
    cfg, shape = _cfg("yi"), ShapeConfig("p", 32, 4, "prefill")
    pol = tpol.policy_for(cfg, shape, seq_parallel=True)
    pol = tpol.CellPolicy(rules=pol.rules, griffin=GriffinConfig(
        sparsity=0.5, tp_shards=2))
    cell = tcells.build_prefill_cell(cfg, shape, mesh, pol)
    assert cell.args[1]["tokens"].shape == (2, 16)  # the sequence arrives split
    args = tcells.materialize(cell, "cpu")
    out = cell.fn(*args)
    V = out["last_logits"].shape[-1]
    return {"logits": out["last_logits"].numpy(),
            "rows": slice(mesh.coord("data") * 2, mesh.coord("data") * 2 + 2),
            "cols": slice(mesh.coord("model") * V, (mesh.coord("model") + 1) * V)}


def _job_recurrent(mesh, arch, params_np, toks):
    """Prefill (last logits) and ``REC_STEPS`` decode steps of ``arch``'s
    smoke config at (1, 2) under the serve rules: this rank's vocabulary
    block of each, and the bytes of its mixer leaves and caches."""
    cfg = _cfg(arch)
    rules = tshl.make_rules(phase="serve")
    tp = TrainTP(cfg, mesh, rules)
    params = tp.shard_params(_tree_torch(params_np))
    B, S = toks.shape[0], REC_PROMPT
    toks = torch.from_numpy(toks)
    c_specs = tdec.cache_specs(cfg, B, S + REC_STEPS)
    c_res = tdec.serve_specs(cfg, c_specs, mesh, rules)
    with tshl.axis_rules(mesh, rules):
        last, aux = tdec.forward(params, cfg, toks[:, :S], want_kv=True,
                                 logits_mode="last", q_chunk=8)
        kv = tdec.kv_blocks(cfg, aux.kv, tdec.serve_specs(
            cfg, tdec.kv_specs(cfg, B, S), mesh, rules))
        cache = tparam.init_params(
            c_specs, 0, cfg.dtype, "cpu",
            blocks=lambda s: block_slices(
                tshl.spec_for(s.axes, rules, mesh, s.shape), s.shape, mesh))
        cache = tdec.fill_cache_from_prefill(cfg, cache, kv)
        dec = []
        for t in range(S, S + REC_STEPS):
            lg, cache = tdec.decode_step(params, cfg, cache, toks[:, t:t + 1], t,
                                         cache_specs=c_res)
            dec.append(lg[:, 0].numpy())
    mixers = [li for li, d in enumerate(tdec.layer_descs(cfg)) if d.mixer != "attn"]
    return {"last": last[:, 0].numpy(), "dec": dec,
            "mixer_bytes": sum(v.numel() * v.element_size() for li in mixers
                               for v in params["layers"][li]["mixer"].values()),
            "cache_bytes": sum(v.numel() * v.element_size() for li in mixers
                               for v in cache[li].values())}


def _job_int8(mesh, k_np):
    """``quantize_kv`` of this rank's ``head_dim`` block of k, and a
    tinylm decode step with an int8 cache split over ``head_dim`` (the
    decode fallback's rules): its logits block and every layer's written
    codes and scales."""
    n, r = mesh.extent("model"), mesh.coord("model")
    hd = k_np.shape[-1]
    blk = torch.from_numpy(k_np[..., r * hd // n:(r + 1) * hd // n])
    with tshl.axis_rules(mesh, tshl.make_rules(phase="serve")):
        q, s = tattn.quantize_kv(blk, ("model",))
    cfg = _cfg("tiny8")
    rules = tshl.make_rules(phase="serve", head_dim_fallback=True)
    out = {"q": q.numpy(), "s": s.numpy(), **_int8_step(cfg, mesh, rules)}
    return out


def _int8_step(cfg, mesh, rules):
    B, C, pos = 2, 16, 9
    c_specs = tdec.cache_specs(cfg, B, C)
    c_res = tdec.serve_specs(cfg, c_specs, mesh, rules) if mesh else None
    blocks = (lambda s: block_slices(tshl.spec_for(s.axes, rules, mesh, s.shape),
                                     s.shape, mesh)) if mesh else None
    params = tparam.init_params(tdec.model_specs(cfg), 0, cfg.dtype, "cpu",
                                blocks=blocks)
    rand = tcells._random_specs(c_specs)
    cache = tparam.init_params(rand, 1, cfg.dtype, "cpu", blocks=blocks)
    for layer in cache:  # codes in range, scales positive
        layer["k"].copy_(layer["k"].float().mul(30).clamp(-127, 127).to(torch.int8))
        layer["v"].copy_(layer["v"].float().mul(30).clamp(-127, 127).to(torch.int8))
        layer["k_scale"].abs_().mul_(0.01)
        layer["v_scale"].abs_().mul_(0.01)
    token = torch.from_numpy(np.random.RandomState(4).randint(
        0, cfg.vocab_size, (B, 1)))
    ctx = tshl.axis_rules(mesh, rules) if mesh else _nullcontext()
    with ctx:
        lg, cache = tdec.decode_step(params, cfg, cache, token, pos,
                                     cache_specs=c_res)
        k_axes = [tshl.split_axes(c["k"], 3) for c in c_res] if mesh else None
    return {"logits": lg[:, 0].numpy(),
            "slot": [{k: v[:, pos].numpy() for k, v in layer.items()}
                     for layer in cache], "k_axes": k_axes}


def _nullcontext():
    import contextlib

    return contextlib.nullcontext()


def _spawn(shape, jobs):
    res, _ = tmesh.run_ranks(_rank, int(np.prod(shape)), backend="gloo",
                             device="cpu", shape=shape, axes=("data", "model"),
                             args=(jobs,), timeout_s=300)
    return res


# ---------------------------------------------------------------------------
# the references (the single device)
# ---------------------------------------------------------------------------

def _jax():
    import jax
    import jax.numpy as jnp

    from repro.models import decoder as jdec
    from repro.models.layers import attention as jattn
    from repro.models.layers import moe as jmoe
    from repro.training import optimizer as jopt
    from repro.training import train_step as jts
    from test_torch_train_step import _np

    return jax, jnp, jdec, jattn, jmoe, jopt, jts, _np


def _jax_losses(tag, params, tokens, steps):
    """The reference's single-device step: ``steps`` losses, and the
    first step's gradients in the port's layout (numpy leaves)."""
    from repro.configs.registry import get_config as jget

    jax, jnp, jdec, _, _, jopt, jts, _np = _jax()
    cfg, tcfg = _cfg(tag, jget), _cfg(tag)
    jp = jax.tree.map(jnp.asarray, _np(bridge.params_to_jax(params, tcfg)))
    b = {"tokens": jnp.asarray(tokens)}
    jg = jax.jit(jax.grad(lambda p: jdec.loss_fn(p, b, cfg)[0]))(jp)
    grads = {k: x.numpy() for k, x in _paths(bridge.params_from_jax(
        jax.tree.map(np.asarray, jg), tcfg, "cpu")).items()}
    opt = jopt.adamw(LR)
    st = {"params": jp, "opt": opt.init(jp), "step": jnp.zeros((), jnp.int32)}
    step = jax.jit(jts.build_train_step(cfg, opt))
    out = []
    for _ in range(steps):
        st, m = step(st, b)
        out.append(float(m["loss"]))
    return {"losses": out, "grads": grads}


def _jax_moe(params, x, ct, chunk):
    from repro.configs.registry import get_config as jget

    jax, jnp, _, _, jmoe, _, _, _ = _jax()
    cfg = _cfg("ds", jget)

    def f(p, x):
        y, aux, _ = jmoe.moe_forward(p, x, cfg, chunk_tokens=chunk)
        return jnp.sum(y * ct) + 0.01 * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    return np.asarray(y), float(aux), jax.tree.map(np.asarray, gp), np.asarray(gx)


def _jax_recurrent(arch, params, toks):
    from repro.configs.registry import get_config as jget

    jax, jnp, jdec, _, _, _, _, _np = _jax()
    cfg, tcfg = _cfg(arch, jget), _cfg(arch)
    jp = jax.tree.map(jnp.asarray, _np(bridge.params_to_jax(params, tcfg)))
    S = REC_PROMPT
    last, aux = jdec.forward(jp, cfg, jnp.asarray(toks[:, :S]), want_kv=True,
                             remat=False, logits_mode="last")
    cache = jdec.fill_cache_from_prefill(
        cfg, jdec.init_cache(cfg, toks.shape[0], S + REC_STEPS), aux.kv)
    dec = []
    for t in range(S, S + REC_STEPS):
        lg, cache = jdec.decode_step(jp, cfg, cache, jnp.asarray(toks[:, t:t + 1]),
                                     jnp.int32(t))
        dec.append(np.asarray(lg)[:, 0])
    return np.asarray(last)[:, 0], dec


# ---------------------------------------------------------------------------
# the spawns, shared by the checks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    """One (2, 2) and one (1, 2) spawn beside the references."""
    from concurrent.futures import ThreadPoolExecutor

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    rng = np.random.default_rng(3)
    ds = _cfg("ds")
    moe_p = _tree_np(tparam.init_params(tmoe.moe_specs(ds), 0, "float32", "cpu"))
    x = rng.normal(size=(4, 32, 64)).astype(np.float32)
    ct = rng.normal(size=(4, 32, 64)).astype(np.float32)
    tokens = rng.integers(0, 256, (4, 32)).astype(np.int64)
    inits = {tag: tdec.init_params(_cfg(tag), 0, "cpu") for tag in ("ds", "yi")}
    jobs22 = {f"moe{c}": ("_job_moe", (moe_p, x, ct, c)) for c in MOE_CHUNKS}
    jobs22["train2d"] = ("_job_train", ("ds", _tree_np(inits["ds"]), tokens,
                                        {"expert_2d": True}, 1))
    jobs22["sp_yi"] = ("_job_train", ("yi", _tree_np(inits["yi"]), tokens,
                                      {"fsdp": True, "seq_parallel": True}, 2))
    jobs22["sp_ds"] = ("_job_train", ("ds", _tree_np(inits["ds"]), tokens,
                                      {"expert_2d": True, "seq_parallel": True}, 1))
    for tag, kw, mutant in GRAD_MUTANTS:
        jobs22[f"{tag}-{mutant}"] = ("_job_train", ("ds", _tree_np(inits["ds"]), tokens,
                                                    kw, 1, mutant))
    jobs22["sp_prefill"] = ("_job_sp_prefill", ())
    jobs22["sp_families"] = ("_job_sp_families", ())
    rec_p = {a: tdec.init_params(_cfg(a), 0, "cpu") for a in RECURRENT + (ODD_SSM,)}
    rec_t = rng.integers(0, 256, (2, REC_PROMPT + REC_STEPS)).astype(np.int64)
    k_np = rng.normal(size=(2, 1, 3, 32)).astype(np.float32)
    jobs12 = {a: ("_job_recurrent", (a, _tree_np(rec_p[a]), rec_t))
              for a in RECURRENT + (ODD_SSM,)}
    for name, kw in ODD_TRAIN.items():
        jobs12[name] = ("_job_train", (ODD_SSM, _tree_np(rec_p[ODD_SSM]), tokens,
                                       kw, 1))
    jobs12["int8"] = ("_job_int8", (k_np,))
    with ThreadPoolExecutor(2) as ex:
        f22 = ex.submit(_spawn, (2, 2), jobs22)
        f12 = ex.submit(_spawn, (1, 2), jobs12)
        ref = {"moe": {c: _jax_moe(moe_p, x, ct, c) for c in MOE_CHUNKS},
               "train2d": _jax_losses("ds", inits["ds"], tokens, 1),
               "sp_yi": _jax_losses("yi", inits["yi"], tokens, 2),
               "rec": {a: _jax_recurrent(a, rec_p[a], rec_t)
                       for a in RECURRENT + (ODD_SSM,)},
               "odd_train": _jax_losses(ODD_SSM, rec_p[ODD_SSM], tokens, 1),
               "odd_one": _job_recurrent(tmesh.TrainMesh(), ODD_SSM,
                                         _tree_np(rec_p[ODD_SSM]), rec_t)}
        res22, res12 = f22.result(), f12.result()
    torch.set_num_threads(n)
    ref["sp_ds"] = ref["train2d"]
    return dict(res22=res22, res12=res12, ref=ref, moe_p=moe_p, x=x,
                k=k_np, rec_p=rec_p, inits=inits, tokens=tokens)


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def test_moe_experts_over_data_model_match_the_reference(runs):
    import jax

    cfg = _cfg("ds")
    # the capacity drops assignments in both chunkings (the trap a row's
    # own capacity would fall into)
    p = _tree_torch(runs["moe_p"])
    xt = torch.from_numpy(runs["x"]).reshape(-1, 64)
    _, idx, _ = tmoe._route(p, xt, cfg)
    for c in MOE_CHUNKS:
        c = min(c, xt.shape[0])
        counts = [np.bincount(idx[i:i + c].reshape(-1).numpy(),
                              minlength=cfg.num_experts)
                  for i in range(0, xt.shape[0], c)]
        assert max(x.max() for x in counts) > tmoe._capacity(c, cfg), c
    for c in MOE_CHUNKS:
        y, aux, gp, gx = runs["ref"]["moe"][c]
        want = {k: np.asarray(v) for k, v in _paths(jax.tree.map(np.asarray, gp)).items()}
        for o in (r[f"moe{c}"] for r in runs["res22"]):
            np.testing.assert_allclose(o["y"], y[o["rows"]], **MOE_TOL)
            np.testing.assert_allclose(o["aux"], aux, rtol=1e-5)
            np.testing.assert_allclose(o["gx"], gx[o["rows"]], rtol=1e-4, atol=1e-6)
            assert sorted(o["gp"]) == sorted(want)
            for k, w in want.items():
                np.testing.assert_allclose(o["gp"][k], w[o["slices"][k]], rtol=0,
                                           atol=GRAD_REL * np.abs(w).max(),
                                           err_msg=f"{c} {k}")


def test_train_step_experts_over_data_model_matches_the_reference(runs):
    """The loss and every rank's synced gradient blocks (the expert leaves
    summed over ``model`` only, the rest over the batch axes) against the
    reference's single-device step."""
    want = runs["ref"]["train2d"]
    for r in runs["res22"]:
        np.testing.assert_allclose(r["train2d"]["losses"], want["losses"], **LOSS_TOL)
        assert not _grad_misses(r["train2d"], want["grads"])


@pytest.mark.parametrize("job,mutant", [(j, m) for j, _, m in GRAD_MUTANTS])
def test_gradient_ownership_mutants_miss_the_reference(runs, job, mutant):
    """The experts' token gather without the reduce-scatter of its
    backward, or the MTP block's whole leaves without their 1/n under
    sequence parallelism: the first loss is unchanged, the gradients miss
    the reference's (the gather's: the leaves before the experts)."""
    want = runs["ref"][job]
    for r in runs["res22"]:
        out = r[f"{job}-{mutant}"]
        np.testing.assert_allclose(out["losses"], want["losses"], **LOSS_TOL)
        missed = _grad_misses(out, want["grads"])
        assert missed, mutant
        if mutant == "no_gather_sum":
            assert any("ffn/w" not in k for k in missed), missed
        else:
            assert any(k.startswith("mtp/") for k in missed), missed


def test_init_on_the_mesh_is_the_one_device_draw(monkeypatch):
    """Every rank's blocks equal the one-device draw's, with leaves of
    2^12 elements and more drawn in slices of 2^9 (each rank draws the
    slices its block touches); the threshold's default leaves Yi-9B's and
    Moonshot's draws whole."""
    for arch in ("yi-9b", "moonshot-v1-16b-a3b"):
        assert not any(tparam.slice_rows(s) for s in _paths(
            tdec.model_specs(tget(arch))).values())
    cfg = _cfg("ds")
    monkeypatch.setattr(tparam, "SLICED_NUMEL", 1 << 12)
    monkeypatch.setattr(tparam, "SLICE_NUMEL", 1 << 9)
    specs = _paths(tdec.model_specs(cfg))
    sliced = [k for k, s in specs.items() if tparam.slice_rows(s)]
    assert any(k.endswith("ffn/w1") for k in sliced) and "embed/table" in sliced
    full = _paths(tdec.init_params(cfg, 0, "cpu"))
    for dims, kw in (((2, 2), {"expert_2d": True, "fsdp": True}),
                     ((1, 4), {"fsdp": False})):
        rules = tshl.make_rules(phase="train", **kw)
        for rank in range(4):
            tp = TrainTP(cfg, tmesh.TrainMesh(dims=dims, rank=rank), rules)
            got = _paths(tp.init_params(0, "cpu"))
            res = _paths(tp.param_specs)
            for k, v in full.items():
                want = block_of(v, res[k], tp.mesh)
                assert got[k].dtype == want.dtype and torch.equal(got[k], want), \
                    (dims, rank, k)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_mixers_split_over_model_match_the_reference(runs, arch):
    last, dec = runs["ref"]["rec"][arch]
    cfg = _cfg(arch)
    mixers = [li for li, d in enumerate(tdec.layer_descs(cfg)) if d.mixer != "attn"]
    whole = sum(v.numel() * v.element_size() for li in mixers
                for v in runs["rec_p"][arch]["layers"][li]["mixer"].values())
    for r, o in enumerate(runs["res12"]):
        o = o[arch]
        V = o["last"].shape[-1]
        cols = slice(r * V, (r + 1) * V)
        np.testing.assert_allclose(o["last"], last[:, cols], **TOL)
        for t, lg in enumerate(o["dec"]):
            np.testing.assert_allclose(lg, dec[t][:, cols], **TOL, err_msg=str(t))
        # each rank holds half of every mixer leaf, as the reference's rules
        # split them (conv_b / norm / the heads' vectors included)
        assert o["mixer_bytes"] * 2 == whole, arch


def test_whole_ssm_mixer_with_split_leaves_matches_one_rank(runs):
    """``ODD_SSM`` at (1, 2): the heads whole, conv / norm / w_out split
    and gathered, the mixer run whole on each rank: the logits against
    the reference's forward and decode, the bytes against one rank's."""
    last, dec = runs["ref"]["rec"][ODD_SSM]
    one = runs["ref"]["odd_one"]
    cfg = _cfg(ODD_SSM)
    assert cfg.ssm_nheads % 2 and (cfg.d_inner_ssm + 2 * cfg.ssm_state) % 2 == 0
    for r, o in enumerate(runs["res12"]):
        o = o[ODD_SSM]
        V = o["last"].shape[-1]
        cols = slice(r * V, (r + 1) * V)
        np.testing.assert_allclose(o["last"], last[:, cols], **TOL)
        for t, lg in enumerate(o["dec"]):
            np.testing.assert_allclose(lg, dec[t][:, cols], **TOL, err_msg=str(t))
        # a rank holds half of the split leaves (and of its conv tail)
        assert o["mixer_bytes"] < one["mixer_bytes"]
        assert o["cache_bytes"] < one["cache_bytes"]


@pytest.mark.parametrize("dims", [(1, 16), (16, 16)])
@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k", "train_4k"])
def test_ssm_smoke_cells_with_whole_heads_and_split_leaves_step(dims, shape):
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.launch.dryrun import step_cell

    cfg = _cfg("mamba2-1.3b")
    assert cfg.ssm_nheads % dims[1] and (cfg.d_inner_ssm + 2 * cfg.ssm_state) % dims[1] == 0
    pol = tpol.policy_for(cfg, SHAPES[shape])
    cell = tcells.build_cell(cfg, SHAPES[shape],
                             tmesh.dry_train_mesh(dims, ("data", "model"), 0), pol)
    count, records, _ = step_cell(cell)
    assert count.ops["dot"] > 0
    # the split leaves are gathered over model
    assert any(r["kind"] == "all-gather" and len(r["ranks"]) == dims[1]
               for r in records)


@pytest.mark.parametrize("job", sorted(ODD_TRAIN))
def test_whole_ssm_mixer_with_split_leaves_trains_as_one_rank(runs, job):
    """The loss and the gradient blocks (the gathered leaves': each
    rank's block of the whole gradient, every rank computed it whole;
    under sequence parallelism the sum of the ranks' parts) against the
    reference's single-device step (``JAX_GRAD_TOL``), and within
    ``GRAD_REL`` of the port's one rank."""
    want = runs["ref"]["odd_train"]
    cfg = _cfg(ODD_SSM)
    params = runs["rec_p"][ODD_SSM]
    one = _one_rank_grads(cfg, params, {"tokens": torch.from_numpy(runs["tokens"])})
    for o in runs["res12"]:
        o = o[job]
        np.testing.assert_allclose(o["losses"], want["losses"], **LOSS_TOL)
        assert sorted(o["grads"]) == sorted(want["grads"])
        for k, w in want["grads"].items():
            np.testing.assert_allclose(o["grads"][k], w[o["slices"][k]], **JAX_GRAD_TOL,
                                       err_msg=k)
        assert _grad_misses(o, one) == []


def test_int8_cache_split_over_head_dim(runs):
    _, jnp, _, jattn, _, _, _, _ = _jax()
    k = runs["k"]
    jq, js = jattn.quantize_kv(jnp.asarray(k))
    jq, js = np.asarray(jq), np.asarray(js)
    one = _int8_step(_cfg("tiny8"), None, None)
    for r, o in enumerate(runs["res12"]):
        o = o["int8"]
        hd = k.shape[-1] // 2
        np.testing.assert_array_equal(o["q"], jq[..., r * hd:(r + 1) * hd])
        np.testing.assert_array_equal(o["s"], js)
        assert all(ax == ("model",) for ax in o["k_axes"])  # head_dim is split
        V = o["logits"].shape[-1]
        np.testing.assert_allclose(o["logits"], one["logits"][:, r * V:(r + 1) * V],
                                   **TOL)
        for li, (got, want) in enumerate(zip(o["slot"], one["slot"])):
            w = got["k"].shape[-1]
            for name in ("k", "v"):
                np.testing.assert_array_equal(
                    got[name], want[name][..., r * w:(r + 1) * w], f"{li} {name}")
            for name in ("k_scale", "v_scale"):
                np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                           atol=0, err_msg=f"{li} {name}")


@pytest.mark.parametrize("tag", ("sp_yi", "sp_ds"))
def test_seq_parallel_train_step_matches_the_reference(runs, tag):
    """The losses (Yi-9B: two steps) and the first step's synced gradient
    blocks (the unsplit leaves' sequence shares summed over ``model``; the
    router's means, the MTP block's scale, the embedding's rank-0 part)
    against the reference's single-device step."""
    want = runs["ref"][tag]
    for r in runs["res22"]:
        np.testing.assert_allclose(r[tag]["losses"], want["losses"], **LOSS_TOL)
        assert not _grad_misses(r[tag], want["grads"]), tag


def test_seq_parallel_trains_every_family_as_one_rank(runs):
    """The other families' stacks under sequence parallelism (the VLM's
    prefix and the encoder's frames split with the text, local windows,
    the SSM and RG-LRU mixers, MLA with MoE and MTP): one step's loss
    and its synced gradient blocks equal the port's one rank's (held to
    the reference there by ``test_torch_train_step``)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = _family_sp_losses()
    for r in runs["res22"]:
        for arch, o in one.items():
            got = r["sp_families"][arch]
            np.testing.assert_allclose(got["losses"], o["losses"], **LOSS_TOL,
                                       err_msg=arch)
            assert not _grad_misses(got, o["grads"]), arch


def test_seq_parallel_prefill_matches_one_device(runs):
    cfg = _cfg("yi")
    params = tdec.init_params(cfg, 0, "cpu")
    tokens = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, size=(4, 32)).astype(np.int32))
    want = tsteps.build_prefill_step(cfg, GriffinConfig(sparsity=0.5, tp_shards=2))(
        params, tokens)["last_logits"].numpy()
    for o in (r["sp_prefill"] for r in runs["res22"]):
        np.testing.assert_allclose(o["logits"], want[o["rows"], o["cols"]], **TOL)


def test_sp_rules_resolve_as_the_reference():
    """``seq`` on ``model`` splits a divisible length and leaves decode's
    one token whole; the serving launcher's ``--mesh`` with ``--http``
    is served (``tests/test_torch_mesh_frontend.py``), its address
    checked before any rank starts."""
    from repro_torch.launch import serve as tserve

    m = tmesh.TrainMesh(dims=(2, 2), rank=3)
    with tshl.axis_rules(m, tshl.make_rules(phase="train", seq_parallel=True)):
        assert tshl.sp_wanted(32) and not tshl.sp_wanted(1) and not tshl.sp_wanted(7)
    with tshl.axis_rules(m, tshl.make_rules(phase="train")):
        assert not tshl.sp_wanted(32)
    with pytest.raises(SystemExit):
        tserve.main(["--arch", "tinylm-tp", "--device", "cpu", "--mesh", "model=2",
                     "--http", "127.0.0.1"])
    assert math.prod(m.dims) == 4
