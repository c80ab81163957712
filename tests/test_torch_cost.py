"""The dry-run's counted cost and memory (``analysis.collectives.count_ops``,
the counterpart of the reference dry-run's ``compiled.cost_analysis()``
and ``compiled.memory_analysis()``), on the CPU and on ``meta``.

* tinylm's decode step (B = 2): the counted FLOPs are the sum of
  ``2 M N K`` over its ``9 L + 1`` matmuls, exactly, on the CPU and on
  ``meta``.
* Decode cells whose every matmul ``analytic.cell_cost`` models (the smoke
  configs of Yi-9B, Gemma-3 and RecurrentGemma at (1, 1), Yi-9B at full
  size at rank 0 of (16, 16)): counted FLOPs == ``cell_cost / chips`` to
  1e-9.  Moonshot's full-size decode cell at rank 0 of (16, 16): the
  static-capacity formula (every local expert's products at its
  capacity, the router on the rank's tokens), exactly.
* Storages: a hand-built run of allocations and frees with a view and an
  in-place write gives exact temp, output, alias and peak bytes, the same
  on ``meta`` and on the CPU; the einsum's copy of a permuted cache in a
  loop of layers is freed with its layer (the temp does not grow), and
  so is a layer's FSDP-gathered weights (``decoder._gather``), with
  Python's cyclic collector off; a train step's temp is the same with
  the collector off as on (``train_step._flatten`` holds no gradient).
* A kernel wrapper's plain version is named with its ops.
* ``_fast_meta``'s own ``meta`` results of the ``_SHAPED`` ops equal the
  ops' (shape, dtype, contiguous), and it declines what it does not cover.
* ``dryrun.run_cell`` records every new field, and the report prints
  the new columns.
"""
import gc
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import analytic as tan  # noqa: E402
from repro_torch.analysis import collectives as tcoll  # noqa: E402
from repro_torch.analysis import report as treport  # noqa: E402
from repro_torch.analysis import roofline as trl  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.configs.shapes import SHAPES as TSHAPES  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch.mesh import dry_train_mesh  # noqa: E402
from repro_torch.launch.policies import policy_for  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.layers import moe as tmoe  # noqa: E402

MESH_AXES = ("data", "model")


def _cell_count(arch, shape, dims, smoke=False):
    cfg = tget(arch, smoke=smoke)
    pol = policy_for(cfg, shape)
    cell = tcells.build_cell(cfg, shape, dry_train_mesh(dims, MESH_AXES, 0), pol)
    count, _, _ = tdry.step_cell(cell)
    sp = pol.griffin.sparsity if pol.griffin is not None else 0.0
    chips = dims[0] * dims[1]
    return cfg, count, tan.cell_cost(cfg, shape, griffin_sparsity=sp).flops / chips


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_a_decode_steps_flops_are_its_matmuls(device):
    cfg = tget("tinylm")
    B, S, pos = 2, 16, 3
    params = tdec.init_params(cfg, 0, "cpu")
    cache = tdec.init_cache(cfg, B, S, "cpu")
    if device == "meta":
        params, cache = (tcells._walk(lambda t, _: t.to("meta"), tree, tree)
                         for tree in (params, cache))
    tok = torch.zeros((B, 1), dtype=torch.int64, device=device)
    c = tcoll.count_ops(tdec.decode_step, params, cfg, cache, tok, pos)
    D, H, KV, hd, F = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    # per layer q, k, v, scores, context, out-projection, w_g, w_1, w_2
    # (M, N, K); the tied head
    layer = [(B, H * hd, D), (B, KV * hd, D), (B, KV * hd, D),
             (B * H, S, hd), (B * H, hd, S), (B, D, H * hd),
             (B, F, D), (B, F, D), (B, D, F)]
    dots = layer * cfg.num_layers + [(B, cfg.vocab_size, D)]
    assert c.ops["dot"] == len(dots) == 9 * cfg.num_layers + 1
    assert c.cost["flops"] == sum(2 * m * n * k for m, n, k in dots)
    assert c.cost["elementwise_flops"] > 0
    assert c.cost["bytes_accessed"] > sum(
        t.numel() * t.element_size() for layer in params["layers"]
        for t in layer["ffn"].values())
    assert set(c.cost["by_op"]) >= {"mm", "bmm"}
    # the cache is written in place and returned: an alias, not an output
    k = cache[0]["k"]
    assert c.memory["alias_size_in_bytes"] == cfg.num_layers * 2 * k.numel() * k.element_size()
    assert c.memory["output_size_in_bytes"] == B * cfg.vocab_size * 4


@pytest.mark.parametrize("arch,dims,smoke", [
    ("yi-9b", (1, 1), True), ("gemma3-27b", (1, 1), True),
    ("recurrentgemma-9b", (1, 1), True), ("yi-9b", (16, 16), False)])
def test_decode_cells_count_the_analytic_flops(arch, dims, smoke):
    _, c, want = _cell_count(arch, TSHAPES["decode_32k"], dims, smoke)
    assert abs(c.cost["flops"] - want) <= 1e-9 * want, (c.cost["flops"], want)


def test_moonshot_decode_counts_every_experts_static_capacity():
    """Routed EP at (16, 16): each rank's 4 experts run their products at
    the capacity of 8 slots for its data row's 8 tokens (the reference's
    einsums do the same), where ``cell_cost`` counts k x capacity factor
    slots a token; the router runs on every rank of the model group."""
    shape = TSHAPES["decode_32k"]
    cfg, c, analytic = _cell_count("moonshot-v1-16b-a3b", shape, (16, 16))
    chips, n_model = 256, 16
    B, D, E, F = shape.global_batch, cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    glu = 3 if cfg.glu else 2
    n_moe = cfg.num_layers - cfg.num_dense_layers
    T = B // 16  # this data row's tokens
    routed = 2 * B * D * F * glu * cfg.experts_per_token * cfg.capacity_factor
    router = 2 * B * D * E
    C = tmoe._capacity(T, cfg)
    static = 2 * glu * (E // n_model) * C * D * F
    want = (analytic * chips - n_moe * (routed + router)) / chips \
        + n_moe * (static + 2 * T * D * E)
    assert c.cost["flops"] == want
    assert c.cost["flops"] / analytic > 3.0


def _storage_run(dev):
    """Allocations and frees of known sizes (fp32): returns the result."""
    arg = torch.zeros(1000, device=dev)

    def step(x):
        a = torch.empty(2000, device=dev)  # 8,000 B
        b = a[:500]  # a view: no new storage
        c = torch.ones(3000, device=dev)  # 12,000 B, live 20,000
        del a  # the view keeps a's storage
        c.mul_(2.0)  # in place: no new storage
        x.add_(1.0)  # an argument written in place
        d = b * 2.0  # 2,000 B, live 22,000 (the peak)
        del b, c  # a's and c's storages die: live 2,000
        e = torch.empty(4000, device=dev)  # 16,000 B, live 18,000
        del e
        return d, x

    return arg, tcoll.count_ops(step, arg)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_storages_allocated_freed_viewed_and_written_in_place(device):
    _, c = _storage_run(device)
    assert c.memory == {"argument_size_in_bytes": 4_000,
                        "output_size_in_bytes": 2_000,
                        "alias_size_in_bytes": 4_000,
                        "temp_size_in_bytes": 22_000,
                        "peak_bytes": 26_000}


def test_a_permuted_caches_copy_is_freed_with_its_layer():
    """``attn_decode``'s pattern: an einsum over a permuted cache copies
    it; over 2 and 8 layers the temp is the same."""
    def layers(n):
        caches = [torch.empty(4, 64, 2, 16, device="meta") for _ in range(n)]
        q = torch.empty(4, 1, 2, 3, 16, device="meta")

        def step(q, caches):
            x = q
            for k in caches:
                s = torch.einsum("bqkgh,bskh->bkgqs", x, k)
                x = torch.einsum("bkgqs,bskh->bqkgh", s.softmax(-1), k)
            return x

        return tcoll.count_ops(step, q, caches).memory["temp_size_in_bytes"]

    assert layers(2) == layers(8) > 0


def test_a_layers_gathered_weights_are_freed_with_their_layer():
    """Command-R+'s decode cell at rank 0 of (16, 16) gathers each layer's
    leaves over ``data``; with the cyclic collector off, the temp is the
    same at 2 and 4 layers (no reference cycle holds a layer's blocks)."""
    def temp(n):
        cfg = tget("command-r-plus-104b").replace(num_layers=n)
        shape = TSHAPES["decode_32k"]
        cell = tcells.build_cell(cfg, shape, dry_train_mesh((16, 16), MESH_AXES, 0),
                                 policy_for(cfg, shape))
        gc.collect()
        gc.disable()
        try:
            return tdry.step_cell(cell)[0].memory["temp_size_in_bytes"]
        finally:
            gc.enable()

    assert temp(2) == temp(4) > 0


def test_a_train_steps_gradients_are_freed_without_the_collector():
    """Yi-9B's train cell at 1 layer, rank 0 of (16, 16): the temp is the
    same with Python's cyclic collector off as with it on (no reference
    cycle of ``train_step._flatten`` holds the gradients)."""
    cfg = tget("yi-9b").replace(num_layers=1)
    shape = TSHAPES["train_4k"]

    def temp(collect: bool):
        cell = tcells.build_cell(cfg, shape, dry_train_mesh((16, 16), MESH_AXES, 0),
                                 policy_for(cfg, shape))
        gc.collect()
        if not collect:
            gc.disable()
        try:
            return tdry.step_cell(cell)[0].memory["temp_size_in_bytes"]
        finally:
            gc.enable()

    assert temp(False) == temp(True) > 0


def test_plain_versions_are_named_with_their_ops():
    z = torch.randn(2, 8, 64)
    c = tcoll.count_ops(lambda z: tops.griffin_stat(z) + 1.0, z)
    pv = c.cost["plain_versions"]
    assert list(pv) == ["griffin_stat"]
    assert 0 < pv["griffin_stat"]["bytes"] < c.cost["bytes_accessed"]
    assert pv["griffin_stat"]["flops"] == 0 == c.cost["flops"]


def _fast_cases():
    A = torch.ops.aten
    m = torch.device("meta")
    x = torch.empty(6, 4, 3, device=m)
    i64 = torch.empty(5, dtype=torch.int64, device=m)
    i32 = torch.empty(2, 3, dtype=torch.int32, device=m)
    mask = torch.empty(6, dtype=torch.bool, device=m)
    a, b = torch.empty(2, 3, device=m), torch.empty(4, 3, device=m)
    c = torch.empty(2, 5, device=m)
    h = torch.empty(2, 3, dtype=torch.bfloat16, device=m)
    dev = {"device": m}
    return {
        "index": (A.index.Tensor, (x, [i64]), {}, True),
        "index_2d": (A.index.Tensor, (x, [i32]), {}, True),
        "index_bool": (A.index.Tensor, (x, [mask]), {}, False),
        "index_two": (A.index.Tensor, (x, [None, i64]), {}, False),
        "arange": (A.arange.default, (7,), dev, True),
        "arange_start": (A.arange.start, (2, 11), dev, True),
        "arange_step": (A.arange.start_step, (10, 1, -3), dev, True),
        "arange_dtype": (A.arange.default, (5,), dict(dev, dtype=torch.float32), True),
        "arange_float": (A.arange.default, (2.5,), dev, False),
        "cat": (A.cat.default, ([a, b],), {}, True),
        "cat_last": (A.cat.default, ([a, c], -1), {}, True),
        "cat_dtypes": (A.cat.default, ([a, h],), {}, False),
        "cat_noncontig": (A.cat.default, ([a.t(), c.t()],), {}, False),
        "new_zeros": (A.new_zeros.default, (x, [3, 2]), {}, True),
        "new_empty": (A.new_empty.default, (x, [4]), {"dtype": torch.int32}, True),
        "new_ones": (A.new_ones.default, (i64, [2, 2]), {}, True),
        "full_like": (A.full_like.default, (x, 2.0), {}, True),
        "empty_like": (A.empty_like.default, (x,), {"dtype": torch.int32}, True),
        "zeros_like": (A.zeros_like.default, (a,), {}, True),
        "ones_like_strided": (A.ones_like.default, (x.transpose(0, 1),), {}, False),
    }


@pytest.mark.parametrize("case", sorted(_fast_cases()))
def test_fast_meta_builds_the_ops_own_result(case):
    func, args, kwargs, covered = _fast_cases()[case]
    fast = tcoll._fast_meta(func, args, kwargs)
    if not covered:
        assert fast is None
        return
    want = func(*args, **kwargs)
    assert (fast.shape, fast.dtype, fast.device.type) == \
        (want.shape, want.dtype, "meta")
    assert fast.is_contiguous() and want.is_contiguous()


def test_run_cell_records_the_counted_cost_and_memory():
    rec = tdry.run_cell("smollm-360m", "decode_32k", pods=2)
    assert rec["status"] == "ok" and rec["chips"] == 512
    assert "analytic" in rec["cost_source"] and "counted" in rec["cost_source"]
    cnt = rec["counted"]
    assert cnt["flops_per_chip"] > 0 and cnt["bytes_accessed_per_chip"] > 0
    assert cnt["elementwise_flops_per_chip"] > 0 and "bmm" in cnt["by_op"]
    assert rec["flops_counted_over_analytic"] == pytest.approx(1.0, rel=1e-9)
    mem = rec["memory"]
    assert mem["argument_size_in_bytes"] == mem["input_bytes_per_device"] > 0
    assert mem["alias_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert mem["peak_bytes"] == mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    assert mem["temp_size_in_bytes"] >= mem["output_size_in_bytes"]
    assert mem["fits_card"] is (mem["peak_bytes"] <= trl.HBM_CAPACITY) is True
    # the analytic roofline is the record's bound, as before
    assert rec["roofline"]["compute_s"] == rec["flops_per_chip"] / trl.peak_flops("bfloat16")


def test_report_prints_the_peak_and_the_counted_flops(tmp_path, capsys):
    roof = trl.from_costs(2.0e11, 7.0e9, 2.0e7, model_flops_total=1e13 * 256,
                          chips=256, dtype="bfloat16").as_dict()
    rec = {"arch": "yi-9b", "shape": "decode_32k", "pods": 1, "status": "ok",
           "memory": {"input_bytes_per_device": 3.6e9, "peak_bytes": 4.2e9},
           "counted": {"flops_per_chip": 4.0e13}, "step_s": 0.5,
           "roofline": roof}
    (tmp_path / "yi-9b_decode_32k_p1.json").write_text(json.dumps(rec))
    treport.main(["--art", str(tmp_path)])
    out = capsys.readouterr().out
    assert "peak (args + temp)" in out and "MODEL_FLOPS/counted" in out
    assert "| yi-9b | decode_32k | ok | — | 3.6 GB | 4.2 GB | 0.5 |" in out
    line = next(ln for ln in out.splitlines()
                if ln.startswith("| yi-9b | decode_32k |") and "memory" in ln)
    assert f"| {roof['useful_ratio']:.3g} | 0.25 |" in line
