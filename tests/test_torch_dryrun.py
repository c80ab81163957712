"""The port's dry-run (``repro_torch.launch.{cells,dryrun}``) and its
serving cells on a mesh, on the CPU, held against the JAX package.

* Per-rank blocks: on both production meshes, at rank 0 and the last
  rank, for every smoke arch x shape and for Yi-9B and DeepSeek-V3 at
  full size on ``decode_32k`` and ``train_4k``, every parameter, cache,
  compacted-FF and input leaf of a cell's ``args`` has the block shape
  of the reference's ``spec_for`` under ``AbstractMesh``, and the byte
  sums agree.  The SSM and RG-LRU mixers and their caches, whole over
  ``model`` in the port, are the counted exception.
* Serving cells at (2, 2) over gloo (four spawned ranks), fp32 smoke
  configs (``CASES``): the decode cache's ``kv_seq`` split over
  ``model`` (Yi-9B's smoke config under ``policy_for``'s rules), its
  ``head_dim`` (tinylm, KV heads 3, under the decode fallback rules),
  the local layers' window ring (Gemma-3), and DeepSeek-V3's MLA latent
  cache with its sequence split or its rope key's ``head_dim``, FSDP and
  routed plus shared experts.  Prefill logits, GRIFFIN selection, compacted FF and
  KV blocks and the decode step's logits and cache blocks equal one
  rank's (the same cells at (1, 1)) within ``TOL``, one rank equals the
  reference's ``steps.build_prefill_step`` / ``build_decode_step`` on
  the bridged weights within ``TOL``, and each rank's recorded
  collectives equal the dry mesh's record for that rank.
* The CLI in-process: ``smollm-360m decode_32k --pods 2`` (the
  reference's own dry-run test cell) is ``ok``, and so is DeepSeek-V3's
  decode cell without a group limit, its tokens exchanged over ``data``.
"""
import json
import math
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import bridge  # noqa: E402
from repro_torch.analysis import collectives as tcoll  # noqa: E402
from repro_torch.configs.registry import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.configs.shapes import SHAPES as TSHAPES  # noqa: E402
from repro_torch.configs.shapes import ShapeConfig, cell_supported  # noqa: E402
from repro_torch.core.griffin import GriffinConfig, ffn_widths  # noqa: E402
from repro_torch.distributed import sharding as tshl  # noqa: E402
from repro_torch.distributed.tp import block_slices  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import policies as tpol  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402

#: fp32 on the CPU: the mesh sums partial products in another order
TOL = dict(rtol=1e-4, atol=1e-5)
MESHES = (((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")))


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# per-rank blocks against the reference's spec_for
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    """(path, leaf) of a reference ParamSpec tree or a port tree in the
    reference layout (a list is a scan-stacked leaf)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _port_shape(leaf):
    if isinstance(leaf, list):
        return (len(leaf),) + tuple(leaf[0].shape), leaf[0].dtype
    return tuple(leaf.shape), leaf.dtype


def _ref_block(spec, rules, jm, sizes, jshl, drop_model=False):
    """The reference's block shape of a ParamSpec (its spec_for)."""
    ps = tuple(jshl.spec_for(spec.axes, rules, jm, spec.shape))
    out = []
    for d, n in enumerate(spec.shape):
        ax = ps[d] if d < len(ps) else None
        names = (ax,) if isinstance(ax, str) else tuple(ax or ())
        if drop_model:
            names = tuple(a for a in names if a != "model")
        out.append(n // math.prod(sizes[a] for a in names))
    return tuple(out)


def _check_blocks(jcfg, tcfg, sname, dims, axes, rank, j):
    """Leaves and bytes of one cell's args against the reference; returns
    (leaves compared, exceptions)."""
    shape = TSHAPES[sname]
    jm = j["AbstractMesh"](dims, axes)
    sizes = dict(zip(axes, dims))
    pol = tpol.policy_for(tcfg, shape)
    jpol = j["jpol"].policy_for(jcfg, j["JSHAPES"][sname])
    assert pol.rules == jpol.rules
    cell = tcells.build_cell(tcfg, shape, tmesh.dry_train_mesh(dims, axes, rank),
                             pol)
    jdec = j["jdec"]
    whole = {p.split("/")[0] + "/" + p.split("/")[1]
             for li, (p, _, _) in enumerate(tdec.layer_paths(tcfg))
             if tdec.layer_descs(tcfg)[li].mixer in ("ssm", "rec")}
    pairs = []  # (port tree in the reference layout, reference spec tree, mixers only)
    if shape.kind == "train":
        params = cell.args[0]["params"]
        pairs.append((bridge.ref_view(params, tcfg), jdec.model_specs(jcfg), True))
        pairs.append((cell.args[1], j["jcells"].train_batch_specs(
            jcfg, j["JSHAPES"][sname], None, None, specs_only=True), False))
    else:
        pairs.append((bridge.ref_view(cell.args[0], tcfg),
                      jdec.model_specs(jcfg), True))
        if shape.kind == "prefill":
            pairs.append((cell.args[1], j["jcells"].prefill_input_specs(
                jcfg, j["JSHAPES"][sname], None, None, specs_only=True), False))
        else:
            B, S = shape.global_batch, shape.seq_len
            pairs.append((bridge.ref_view({"layers": cell.args[1]}, tcfg),
                          jdec.cache_specs(jcfg, B, S), False))
            if cell.args[2]:
                pr = [cell.args[2][li] for li in range(tcfg.num_layers)]
                pairs.append((bridge.ref_view({"layers": pr}, tcfg),
                              jdec.pruned_ffn_specs(jcfg, pol.griffin.sparsity),
                              False))
            pairs.append(({"token": cell.args[3]}, {"token": j["ParamSpec"](
                (B, 1), ("batch", "seq"), dtype="int32")}, False))
    n = exc = 0
    port_bytes = ref_bytes = 0
    for port, ref, _ in pairs:
        got = dict(_leaves(port))
        want = dict(_leaves(ref))
        assert sorted(got) == sorted(want), (tcfg.name, sname)
        for path, spec in want.items():
            gshape, gdt = _port_shape(got[path])
            block = _ref_block(spec, pol.rules, jm, sizes, j["jshl"])
            if gshape != block:
                seg = "/".join(path.split("/")[:2])
                assert seg in whole, (tcfg.name, sname, dims, rank, path,
                                      gshape, block)
                block = _ref_block(spec, pol.rules, jm, sizes, j["jshl"], True)
                assert gshape == block, (tcfg.name, sname, path)
                exc += 1
            n += 1
            port_bytes += math.prod(gshape) * torch.empty((), dtype=gdt).element_size()
            rdt = np.dtype(spec.dtype or jcfg.dtype) if (spec.dtype or jcfg.dtype) \
                != "bfloat16" else np.dtype(np.uint16)
            ref_bytes += math.prod(block) * rdt.itemsize
    assert port_bytes == ref_bytes, (tcfg.name, sname)
    if shape.kind != "train":
        assert port_bytes == tcells.input_bytes(cell), (tcfg.name, sname)
    return n, exc


def _jax_modules():
    from jax.sharding import AbstractMesh

    from repro.configs import registry as jreg
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.distributed import sharding as jshl
    from repro.launch import policies as jpol
    from repro.models import decoder as jdec
    from repro.models.param import ParamSpec

    class _Cells:  # the reference's input specs, without shardings
        @staticmethod
        def train_batch_specs(cfg, shape, mesh, rules, specs_only=True):
            B, S = shape.global_batch, shape.seq_len
            if cfg.family == "encoder":
                return {"prefix_emb": ParamSpec((B, S, cfg.d_model),
                                                ("batch", "seq", "act_embed")),
                        "targets": ParamSpec((B, S), ("batch", "seq"),
                                             dtype="int32")}
            if cfg.family == "vlm":
                Pn = cfg.num_prefix_embeddings
                return {"prefix_emb": ParamSpec((B, Pn, cfg.d_model),
                                                ("batch", "seq", "act_embed")),
                        "tokens": ParamSpec((B, S - Pn), ("batch", "seq"),
                                            dtype="int32")}
            return {"tokens": ParamSpec((B, S), ("batch", "seq"), dtype="int32")}

        @classmethod
        def prefill_input_specs(cls, cfg, shape, mesh, rules, specs_only=True):
            out = cls.train_batch_specs(cfg, shape, mesh, rules)
            out.pop("targets", None)
            return out

    return dict(AbstractMesh=AbstractMesh, jreg=jreg, JSHAPES=JSHAPES, jshl=jshl,
                jpol=jpol, jdec=jdec, ParamSpec=ParamSpec, jcells=_Cells)


def test_cell_blocks_match_the_references_spec_for():
    j = _jax_modules()
    runs = [(a, True, s) for a in ASSIGNED_ARCHS for s in TSHAPES] + \
        [(a, False, s) for a in ("yi-9b", "deepseek-v3-671b")
         for s in ("decode_32k", "train_4k")]
    n = exc = 0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for arch, smoke, sname in runs:
            jcfg = j["jreg"].get_config(arch, smoke=smoke)
            tcfg = tget(arch, smoke=smoke)
            if not cell_supported(tcfg, TSHAPES[sname])[0]:
                continue
            for dims, axes in MESHES:
                for rank in (0, math.prod(dims) - 1):
                    a, b = _check_blocks(jcfg, tcfg, sname, dims, axes, rank, j)
                    n += a
                    exc += b
    assert n > 4000
    assert exc == 0  # the SSM / RG-LRU leaves split as the reference's too


# ---------------------------------------------------------------------------
# serving cells at (2, 2) over gloo
# ---------------------------------------------------------------------------

#: case -> (arch, smoke config, the cache leaf and dim the decode rules
#: split over ``model``)
CASES = {
    "kv_seq": ("yi-9b", True, ("k", 1)),
    "head_dim": ("tinylm", False, ("k", 3)),
    "mla_kv_seq": ("deepseek-v3-671b", True, ("ckv", 1)),
    "mla_head_dim": ("deepseek-v3-671b", True, ("kr", 2)),
    "window": ("gemma3-27b", True, ("k", 1)),
}
#: every expert has room for every token, so that no capacity drop tells
#: a data rank's tokens from the whole batch's (at the smoke config's
#: 1.25 a (2, 2) prefill and one rank drop different tokens)
OVERRIDES = {"deepseek-v3-671b": dict(capacity_factor=4.0)}


def _cfg(get, name):
    arch, smoke, _ = CASES[name]
    return get(arch, smoke).replace(**OVERRIDES.get(arch, {}))


def _case(name):
    """(config, prefill policy, decode policy, prefill shape, decode shape).

    * ``kv_seq``, ``window``: ``policy_for``'s rules (2 KV heads: the
      cache's ``kv_seq`` / the local layers' ring over ``model``).
    * ``head_dim``: tinylm's 3 KV heads; with the cache's ``kv_seq`` over
      ``data`` alone the decode fallback splits ``head_dim`` over model.
    * ``mla_*``: DeepSeek-V3's smoke config (MLA, routed and shared
      experts) under ``policy_for``'s FSDP serve rules with the routed
      experts over ``model`` (the production cells' experts over (data,
      model) route tokens by data row, which one rank does not: that
      path is held to a JAX mesh in ``test_torch_train_mesh.py``);
      ``mla_head_dim`` keeps the latent cache's sequence whole so the
      decode fallback splits the shared rope key's ``head_dim``."""
    pre = ShapeConfig("prefill_s", 16, 4, "prefill")
    dec = ShapeConfig("decode_s", 32, 4, "decode")
    cfg = _cfg(tget, name)
    if name in ("kv_seq", "window"):
        return cfg, tpol.policy_for(cfg, pre), tpol.policy_for(cfg, dec), pre, dec
    g = GriffinConfig(sparsity=0.5, tp_shards=16)
    if name == "head_dim":
        p = tshl.make_rules(phase="serve")
        d = tshl.make_rules(phase="serve", head_dim_fallback=True)
    else:
        p = tshl.make_rules(phase="serve", fsdp=True, kv_seq_model=True)
        d = tshl.make_rules(phase="serve", fsdp=True, head_dim_fallback=True,
                            kv_seq_model=name == "mla_kv_seq")
    return (cfg, tpol.CellPolicy(rules=p, griffin=g),
            tpol.CellPolicy(rules=d, griffin=g), pre, dec)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.detach().cpu().numpy().copy()


def _run_case(name, mesh):
    """Prefill and decode cells of a case on ``mesh``: numpy outputs and
    the collectives each step recorded."""
    cfg, ppol, dpol, pre, dec = _case(name)
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cell = tcells.build_cell(cfg, pre, mesh, ppol)
        args = tcells.materialize(cell, "cpu", seed=0)
        tshl.reset_records()
        res = cell.fn(*args)
        out["prefill_records"] = tcoll.summary(tshl.RECORDS)
        out["prefill"] = _np({k: res[k] for k in ("last_logits", "experts",
                                                   "pruned", "kv")})
        cell = tcells.build_cell(cfg, dec, mesh, dpol)
        args = tcells.materialize(cell, "cpu", seed=0)
        tshl.reset_records()
        logits, cache = cell.fn(*args)
        out["decode_records"] = tcoll.summary(tshl.RECORDS)
        out["decode"] = _np({"logits": logits, "cache": cache})
        out["decode_inputs"] = _np(args[:4])
        tshl.reset_records()
    return out


def _serve_rank(mesh, cases):
    out = {name: _run_case(name, mesh) for name in cases}
    # the dry mesh's record of the same cells for this rank
    dm = tmesh.dry_train_mesh((2, 2), ("data", "model"), mesh.rank)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name in cases:
            cfg, ppol, dpol, pre, dec = _case(name)
            for kind, shape, pol in (("prefill", pre, ppol), ("decode", dec, dpol)):
                _, records, _ = tdry.step_cell(tcells.build_cell(cfg, shape, dm, pol))
                out[name][f"dry_{kind}_records"] = tcoll.summary(records)
    return out


def _block(x, spec, rank, dims=(2, 2)):
    m = tmesh.TrainMesh(dims=dims, rank=rank)
    spec = tuple(spec) + (None,) * (x.ndim - len(tuple(spec)))
    return x[block_slices(spec, x.shape, m)]


def test_serving_cells_on_a_2x2_mesh_match_one_rank_and_the_reference():
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jreg
    from repro.core import griffin as jg
    from repro.serving import steps as jsteps

    one = tmesh.TrainMesh(dims=(1, 1))
    am = tmesh.abstract_train_mesh((2, 2))
    with ThreadPoolExecutor(1) as ex:  # the ranks run beside the reference
        ranks = ex.submit(tmesh.run_ranks, _serve_rank, 4, backend="gloo",
                          device="cpu", shape=(2, 2), axes=("data", "model"),
                          args=(tuple(CASES),), timeout_s=300)
        refs = {name: _run_case(name, one) for name in CASES}
        for name in CASES:
            # -- one rank against the reference on the bridged weights (once
            # for each config)
            if name == "mla_head_dim":
                continue
            cfg, ppol, dpol, pre, dec = _case(name)
            ref = refs[name]
            jcfg = _cfg(jreg.get_config, name)
            cell = tcells.build_cell(cfg, pre, one, ppol)
            params, inputs = tcells.materialize(cell, "cpu", seed=0)
            jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                              bridge.params_to_jax(params, cfg))
            jgcfg = jg.GriffinConfig(sparsity=0.5, tp_shards=16)
            want = jsteps.build_prefill_step(jcfg, jgcfg, q_chunk=ppol.q_chunk)(
                jp, jnp.asarray(inputs["tokens"].numpy()))
            np.testing.assert_allclose(ref["prefill"]["last_logits"],
                                       np.asarray(want["last_logits"]), **TOL)
            wp = bridge.tree_from_jax(jax.tree.map(np.asarray, want["pruned"]), cfg, "cpu")
            for li, leaf in wp.items():
                for kname, x in leaf.items():
                    np.testing.assert_allclose(ref["prefill"]["pruned"][li][kname],
                                               x.numpy(), **TOL)
            dparams, cache, pruned, token = ref["decode_inputs"]
            jc = jax.tree.map(jnp.asarray, bridge.params_to_jax(
                {"layers": [{k: torch.from_numpy(v) for k, v in lf.items()}
                            for lf in cache]}, cfg))
            jpr = jax.tree.map(jnp.asarray, bridge.params_to_jax(
                {"layers": [{k: torch.from_numpy(v) for k, v in pruned[li].items()}
                            for li in range(cfg.num_layers)]}, cfg))
            jl, _ = jsteps.build_decode_step(jcfg, True)(
                jp, jc, jpr, jnp.asarray(token), dec.seq_len - 1)
            np.testing.assert_allclose(ref["decode"]["logits"], np.asarray(jl), **TOL)
        ranks, _ = ranks.result()
    for name in CASES:
        cfg, ppol, dpol, pre, dec = _case(name)
        ref = refs[name]
        got = [r[name] for r in ranks]
        # -- prefill: logits by (rows, vocabulary) blocks
        V = cfg.vocab_size
        for r, g in enumerate(got):
            m = tmesh.TrainMesh(dims=(2, 2), rank=r)
            d, c = m.coords["data"], m.coords["model"]
            lg = g["prefill"]["last_logits"]
            want = ref["prefill"]["last_logits"]
            rows = slice(d * lg.shape[0], (d + 1) * lg.shape[0])
            cols = slice(c * lg.shape[1], (c + 1) * lg.shape[1]) if lg.shape[1] < V \
                else slice(None)
            np.testing.assert_allclose(lg, want[rows, cols], **TOL, err_msg=name)
            # selection: this model block's share of the one rank's, and
            # the compacted FF this rank's block of the one rank's
            widths = ffn_widths(cfg)
            prs = tshl.tree_specs(tdec.pruned_ffn_specs(cfg, 0.5), am, ppol.rules)
            for li, idx in ref["prefill"]["experts"].items():
                F = widths[li]
                lo, hi = c * F // 2, (c + 1) * F // 2
                np.testing.assert_array_equal(
                    g["prefill"]["experts"][li], idx[(idx >= lo) & (idx < hi)])
                for leaf, x in ref["prefill"]["pruned"][li].items():
                    np.testing.assert_allclose(
                        g["prefill"]["pruned"][li][leaf], _block(x, prs[li][leaf], r),
                        err_msg=f"{name} pruned {li} {leaf}")
            # the KV as this rank's blocks of the cache material
            ks = tdec.serve_specs(cfg, tdec.kv_specs(cfg, pre.global_batch,
                                                     pre.seq_len), am, ppol.rules)
            for li, leaf in enumerate(ref["prefill"]["kv"]):
                for kname, x in leaf.items():
                    np.testing.assert_allclose(
                        g["prefill"]["kv"][li][kname], _block(x, ks[li][kname], r),
                        **TOL, err_msg=f"{name} kv {li} {kname}")
            # -- decode: logits blocks, and the cache blocks after the step
            lg = g["decode"]["logits"]
            want = ref["decode"]["logits"]
            rows = slice(d * lg.shape[0], (d + 1) * lg.shape[0])
            cols = slice(c * lg.shape[2], (c + 1) * lg.shape[2]) if lg.shape[2] < V \
                else slice(None)
            np.testing.assert_allclose(lg, want[rows, :, cols], **TOL, err_msg=name)
            cs = tdec.serve_specs(cfg, tdec.cache_specs(cfg, dec.global_batch,
                                                        dec.seq_len), am, dpol.rules)
            for li, leaf in enumerate(ref["decode"]["cache"]):
                for kname, x in leaf.items():
                    np.testing.assert_allclose(
                        g["decode"]["cache"][li][kname], _block(x, cs[li][kname], r),
                        **TOL, err_msg=f"{name} cache {li} {kname}")
            # the dry mesh steps what the rank ran
            for kind in ("prefill", "decode"):
                assert g[f"dry_{kind}_records"] == g[f"{kind}_records"], (name, kind, r)
        assert got[0]["decode_records"]["all-reduce"]["count"] > 0
        # the split this case is for: the partial scores summed
        # (head_dim), or the log-sum-exp merge (kv_seq, window ring)
        leaf, dim = CASES[name][2]
        cs = tdec.serve_specs(cfg, tdec.cache_specs(cfg, 4, 32), am, dpol.rules)
        assert tshl.dim_axes(cs[0][leaf], dim) == ("model",), name
        if name == "window":  # layer 0's ring of the window is what is split
            assert tdec.cache_specs(cfg, 4, 32)[0][leaf].shape[1] \
                == cfg.sliding_window < dec.seq_len


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_dryrun_cli_in_process(tmp_path, capsys):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = tdry.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                        "--pods", "2", "--out", str(tmp_path)])
        out = capsys.readouterr().out
        assert rc == 0 and "[ok" in out, out
        rec = json.loads((tmp_path / "smollm-360m_decode_32k_p2.json").read_text())
        assert rec["status"] == "ok" and rec["chips"] == 512
        assert rec["griffin"] and rec["cost_source"] == tdry.COST_SOURCE
        assert rec["memory"]["input_bytes_per_device"] > 0
        assert rec["ops"]["dot"] > 0 and rec["ops"]["custom-call"] == 0
        # each 16-rank model group spans two nodes of 8: all network bytes
        coll = rec["collectives"]
        assert coll["bytes_total"] > 0 and coll["bytes_network"] == coll["bytes_total"]
        r = rec["roofline"]
        assert r["dominant"] == "memory" and r["bound_s"] == r["memory_s"]
        # DeepSeek-V3's production layout: experts over (data, model), no
        # group limit
        rc = tdry.main(["--arch", "deepseek-v3-671b", "--shape", "decode_32k",
                        "--out", str(tmp_path)])
        out = capsys.readouterr().out
        assert rc == 0 and "[ok" in out, out
        rec = json.loads((tmp_path / "deepseek-v3-671b_decode_32k_p1.json").read_text())
        assert rec["status"] == "ok" and rec["collectives"]["bytes_total"] > 0
        assert {"all-gather", "reduce-scatter"} <= set(rec["collective_summary"])
        rc = tdry.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                        "--out", str(tmp_path)])
        assert rc == 0 and "[skipped]" in capsys.readouterr().out
