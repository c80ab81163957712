"""The port's roofline tooling (``repro_torch.analysis``) held against the
JAX package's (``repro.analysis``), on the CPU.

* The roofline's terms and dominance on the H100's datasheet rates, the
  reference's test at the card's numbers.
* ``collectives.collective_bytes`` on records of the reference's
  ``HLO_SAMPLE`` ops equals ``hlo.collective_bytes`` on that text,
  exactly; a group inside a node goes over NVLink, one across nodes over
  the network.
* ``collectives.count_ops`` counts the matmuls of a tinylm decode step.
* ``count_params``, ``param_count``, ``logical_axes`` and
  ``pruned_ffn_specs`` (at sparsity 0.5, and under ``policy_for``'s
  ``tp_shards=16``) equal the reference's for every arch and tinylm;
  ``cell_cost`` equals the reference's to 1e-12 relative for every
  supported cell at sparsity 0 and 0.5.
* ``analysis.report`` prints the params, dry-run and roofline tables.
"""
import json
import warnings

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import analytic as tan  # noqa: E402
from repro_torch.analysis import collectives as tcoll  # noqa: E402
from repro_torch.analysis import report as treport  # noqa: E402
from repro_torch.analysis import roofline as trl  # noqa: E402
from repro_torch.configs.registry import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.configs.shapes import SHAPES as TSHAPES  # noqa: E402
from repro_torch.configs.shapes import cell_supported  # noqa: E402
from repro_torch.core.griffin import GriffinConfig as TGriffin  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models import param as tparam  # noqa: E402

ARCHS = ASSIGNED_ARCHS + ["tinylm"]

#: the reference's HLO_SAMPLE (tests/test_analysis.py) as the records the
#: port's collective entry points write: kind, the HLO operand's bytes,
#: the group's members
HLO_SAMPLE = """
ENTRY %main {
  %x = bf16[128,256]{1,0} parameter(0)
  %ar = bf16[128,256]{1,0} all-reduce(%x), replica_groups={{0,1,2,3},{4,5,6,7}}
  %ag = f32[64,512]{1,0} all-gather(%x), replica_groups={{0,1}}, dimensions={0}
  %rs = f32[32,512]{1,0} reduce-scatter(%ag), replica_groups={{0,1}}
  %cp = s8[1024]{0} collective-permute(%x), source_target_pairs={{0,1}}
  %dot = f32[128,128]{1,0} dot(%x, %x)
}
"""
SAMPLE_RECORDS = [
    {"kind": "all-reduce", "bytes": 128 * 256 * 2, "ranks": [0, 1, 2, 3]},
    {"kind": "all-gather", "bytes": 64 * 512 * 4, "ranks": [0, 1]},
    {"kind": "reduce-scatter", "bytes": 32 * 512 * 4, "ranks": [0, 1]},
    {"kind": "collective-permute", "bytes": 1024, "ranks": [0, 1]},
]


def _cfgs(arch):
    from repro.configs.registry import get_config as jget

    return jget(arch), tget(arch)


def test_roofline_terms_and_dominance_on_the_card():
    r = trl.from_costs(
        flops_per_chip=989e12,  # exactly 1 s of bf16 compute
        hbm_bytes_per_chip=3.35e12 / 2,  # 0.5 s
        collective_bytes_per_chip=450e9 / 4,  # 0.25 s over NVLink
        model_flops_total=989e12 * 256,
        chips=256,
    )
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 0.5) < 1e-9
    assert abs(r.collective_s - 0.25) < 1e-9
    assert r.dominant == "compute" and r.bound_s == r.compute_s
    assert abs(r.useful_ratio - 1.0) < 1e-9
    assert abs(r.roofline_fraction - 1.0) < 1e-9
    d = r.as_dict()
    assert d["dominant"] == "compute" and d["peak_flops"] == 989e12
    # the network carries what crosses a node, at 50 GB/s a card
    r = trl.from_costs(0.0, 0.0, 100e9, network_bytes_per_chip=50e9)
    assert abs(r.collective_s - (50e9 / 450e9 + 1.0)) < 1e-9
    assert r.dominant == "collective"
    # fp32 cells take the fp32 peak
    r = trl.from_costs(67e12, 0.0, 0.0, model_flops_total=67e12,
                       dtype="float32")
    assert abs(r.compute_s - 1.0) < 1e-9 and abs(r.roofline_fraction - 1.0) < 1e-9


def test_collective_bytes_equals_the_hlo_parser():
    from repro.analysis import hlo

    want = hlo.collective_bytes(HLO_SAMPLE, total_devices=8)
    got = tcoll.collective_bytes(SAMPLE_RECORDS, node_size=8)
    keys = {k for k in want if k.startswith(("bytes_", "count_"))}
    assert keys <= set(got)
    for k in keys:
        assert got[k] == want[k], k
    assert got["bytes_network"] == 0.0
    assert got["bytes_nvlink"] == got["bytes_total"]
    # a 16-rank group of the production mesh spans two nodes of 8
    recs = [{"kind": "all-reduce", "bytes": 64, "ranks": list(range(16))},
            {"kind": "all-reduce", "bytes": 64, "ranks": [0, 1, 2, 3]}]
    out = tcoll.collective_bytes(recs, node_size=8)
    assert out["bytes_network"] == 2 * 64 * 15 / 16
    assert out["bytes_nvlink"] == 2 * 64 * 3 / 4
    assert abs(out["bytes_network"] + out["bytes_nvlink"] - out["bytes_total"]) < 1e-9
    s = tcoll.summary([dict(r, issued_bytes=r["bytes"]) for r in recs])
    assert s == {"all-reduce": {"count": 2, "bytes": 128, "issued_bytes": 128}}


def test_count_ops_counts_a_decode_steps_matmuls():
    cfg = tget("tinylm")
    params = tdec.init_params(cfg, 0, "cpu")
    cache = tdec.init_cache(cfg, 2, 16, "cpu")
    tok = torch.zeros((2, 1), dtype=torch.int64)
    ops = tcoll.count_ops(tdec.decode_step, params, cfg, cache, tok, 3).ops
    # per layer q, k, v, scores, context, out-projection, w_g, w_1, w_2;
    # the tied head
    assert ops["dot"] == 9 * cfg.num_layers + 1
    assert ops["custom-call"] == 0  # the CPU runs the plain versions
    assert ops["total"] > ops["dot"]


def test_params_axes_and_pruned_specs_match_the_reference():
    from repro.analysis import roofline as jrl
    from repro.core.griffin import GriffinConfig as JGriffin
    from repro.models import decoder as jdec
    from repro.models import param as jparam
    from repro_torch import bridge

    def stacked(tree):
        """Port specs in the reference layout: a scan leaf's layers'
        specs as one stacked spec."""
        if isinstance(tree, dict):
            return {k: stacked(v) for k, v in tree.items()}
        if isinstance(tree, list):
            s = tree[0]
            assert all(t == s for t in tree), tree
            return tparam.ParamSpec((len(tree),) + s.shape, ("layers",) + s.axes,
                                    s.init, s.scale, s.dtype)
        return tree

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        else:
            yield "/".join(path), tree

    n = 0
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch)
        assert trl.count_params(tcfg) == jrl.count_params(jcfg), arch
        jspecs, tspecs = jdec.model_specs(jcfg), tdec.model_specs(tcfg)
        assert tparam.param_count(tspecs) == jparam.param_count(jspecs), arch
        want = dict(leaves(jparam.logical_axes(jspecs)))
        got = dict(leaves(stacked(bridge.ref_view(tspecs, tcfg))))
        assert sorted(got) == sorted(want), arch
        for path, spec in got.items():
            assert spec.axes == tuple(want[path]), (arch, path)
            n += 1
        if not (tcfg.griffin and tcfg.has_ffn):
            continue
        for jg, tg in ((None, None),
                       (JGriffin(sparsity=0.5, tp_shards=16),
                        TGriffin(sparsity=0.5, tp_shards=16))):
            jp = jdec.pruned_ffn_specs(jcfg, 0.5, gcfg=jg)
            tp = tdec.pruned_ffn_specs(tcfg, 0.5, gcfg=tg)
            for li, (path, inst, n_inst) in enumerate(tdec.layer_paths(tcfg)):
                seg, name = path.split("/")
                if name not in jp.get(seg, {}):
                    assert li not in tp, (arch, li)
                    continue
                for k, js in jp[seg][name].items():
                    ts = tp[li][k]
                    if name.startswith("pos"):
                        assert js.shape[0] == n_inst
                        js = jparam.ParamSpec(js.shape[1:], js.axes[1:], js.init,
                                              js.scale, js.dtype)
                    assert (ts.shape, ts.axes, ts.init) == \
                        (js.shape, js.axes, js.init), (arch, li, k)
                    n += 1
    assert n > 1000


def test_cell_cost_equals_the_reference_for_every_cell():
    from repro.analysis import analytic as jan
    from repro.configs.shapes import SHAPES as JSHAPES

    n = 0
    for arch in ASSIGNED_ARCHS:
        jcfg, tcfg = _cfgs(arch)
        for name, shape in TSHAPES.items():
            if not cell_supported(tcfg, shape)[0]:
                continue
            for sp in (0.0, 0.5):
                a = tan.cell_cost(tcfg, shape, griffin_sparsity=sp)
                b = jan.cell_cost(jcfg, JSHAPES[name], griffin_sparsity=sp)
                for f in ("flops", "param_bytes", "cache_bytes", "act_bytes",
                          "hbm_bytes"):
                    x, y = getattr(a, f), getattr(b, f)
                    assert abs(x - y) <= 1e-12 * max(abs(y), 1.0), (arch, name, f)
                s = tan.summarize(tcfg, shape, 256, sp)
                assert s["analytic_flops_total"] == a.flops
                assert s["analytic_memory_s"] == a.hbm_bytes / 256 / trl.HBM_BW
                assert s["analytic_compute_s"] == \
                    a.flops / 256 / trl.peak_flops(tcfg.dtype)
                n += 1
    assert n == 64  # 32 supported cells x 2 sparsities


def test_report_prints_the_three_tables(tmp_path, capsys):
    rec = {"arch": "yi-9b", "shape": "decode_32k", "pods": 1, "status": "ok",
           "griffin": True, "memory": {"input_bytes_per_device": 3.6e9},
           "step_s": 0.9, "collectives": {"bytes_total": 2.0e7,
                                          "bytes_network": 2.0e7},
           # the table prints the record's own terms
           "roofline": trl.from_costs(2.0e11, 7.0e9, 2.0e7, model_flops_total=1e13,
                                      chips=256, network_bytes_per_chip=2.0e7,
                                      dtype="bfloat16").as_dict()}
    (tmp_path / "yi-9b_decode_32k_p1.json").write_text(json.dumps(rec))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        treport.main(["--art", str(tmp_path)])
    out = capsys.readouterr().out
    assert "## Params" in out and "## Dry-run" in out and "## Roofline" in out
    assert "| yi-9b | decode_32k | ok | — |" in out
    assert "(no artifact)" in out  # every other cell
    line = next(ln for ln in out.splitlines()
                if ln.startswith("| yi-9b | decode_32k |") and "memory" in ln)
    assert "GRIFFIN" in line  # the memory-bound lever
    r = rec["roofline"]
    assert f"| {r['memory_s']:.4g} |" in line and f"| {r['collective_s']:.4g} |" in line
