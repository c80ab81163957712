"""Tensor-parallel paged serving of the port on the CPU, held against the
JAX package.

* ``PagedTP``'s spec trees (parameters, fp32 and int8 pools, a per-slot
  compacted FF tree) for tinylm-tp at N=2 and N=4 equal the reference's
  ``PagedTP(cfg, AbstractMesh((N,), ("model",)))`` leaf for leaf (the
  port's per-layer trees mapped through ``bridge.ref_view``; a
  scan-stacked reference leaf carries one more leading ``None``), and so
  do the local configs; both refuse indivisible heads and an indivisible
  compacted width with the same message.
* ``pad_attention_*`` equal the reference's on one numpy input, and a
  padded attention equals the unpadded one (the reference's own check).
* ``gather_stats`` rebuilds the global statistics exactly (2 gloo ranks).
* Rank-local compaction (``griffin.shard_indices``) of a balanced
  selection equals the global compaction cut into rank blocks, and the
  bridge's and ``init_params``' per-rank trees equal ``shard_params`` of
  the whole tree.
* The two-step statistic (row norms summed over column blocks, then the
  statistic from them) equals the reference's ``griffin_stat_sq``.
* A 2-rank gloo ``PagedServer`` over the reference's sharded-serving
  trace (4 requests, 3 slots, a pool tight enough to preempt, a shared
  16-token prefix), ``spec_k`` 0 and 4, gives the same streams on both
  ranks as the port's single-rank server and the reference's
  single-device ``PagedServer`` with the same ``GriffinConfig(tp_shards=
  2)``; per-rank pool bytes are total / 2.
* ``launch.serve --mesh model=2 --device cpu`` prints the summary lines.
* ``run_ranks`` turns a rank's exception into the parent's, and
  ``make_serving_mesh`` refuses a backend that cannot serve the ranks.

Spawned ranks use gloo on a free localhost port with a timeout.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core import griffin as jg  # noqa: E402
from repro.distributed import tp as jtp  # noqa: E402
from repro.distributed import transforms as jtr  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro.models import param as jparam  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.models.layers import ffn as jffn  # noqa: E402
from repro.serving.server import PagedServer as JaxServer  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import griffin as tg  # noqa: E402
from repro_torch.distributed import tp as ttp  # noqa: E402
from repro_torch.distributed import transforms as ttr  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import ServingMesh, abstract_mesh, run_ranks  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402
from repro_torch.serving.server import PagedServer  # noqa: E402

CFG = get_config("tinylm-tp")
TCFG = tget("tinylm-tp")
_MATS = ("wq", "wk", "wv", "wo", "w1", "wg", "w2")

# the reference's sharded-serving trace (tests/distributed_progs/
# prog_sharded_serving.py): r0/r1 share a 16-token prefix (one prefill
# chunk), the pool is tight enough to preempt
_RNG = np.random.default_rng(11)
_SHARED = _RNG.integers(0, CFG.vocab_size, size=16).astype(np.int32)
PROMPTS = [
    np.concatenate([_SHARED, _RNG.integers(0, CFG.vocab_size, size=8).astype(np.int32)]),
    np.concatenate([_SHARED, _RNG.integers(0, CFG.vocab_size, size=10).astype(np.int32)]),
    _RNG.integers(0, CFG.vocab_size, size=24).astype(np.int32),
    _RNG.integers(0, CFG.vocab_size, size=20).astype(np.int32),
]
MAX_NEW = 10
KW = dict(page_size=8, num_pages=10, n_slots=3, prefill_chunk=16, max_len=64,
          kernel_backend="gather")


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _scaled(tree, s):
    return {k: _scaled(v, s) if isinstance(v, dict)
            else (v * s if k in _MATS else v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def params():
    """tinylm-tp's ``PRNGKey(0)`` draw with the projection matrices scaled
    by 2 (so greedy streams vary), as numpy and as the port's tree."""
    jp = jax.tree.map(np.asarray, jdec.init_params(CFG, jax.random.PRNGKey(0)))
    js = _scaled(jp, np.float32(2.0))
    return js, bridge.params_from_jax(js, TCFG, "cpu")


# ---------------------------------------------------------------------------
# spec trees, refusals, transforms (no ranks)
# ---------------------------------------------------------------------------

def _spec(p):
    return tuple(p)


def _assert_same_specs(port_view, ref_tree, stacked: bool):
    """Leaf for leaf: a reference spec of a scan-stacked leaf has a
    leading None for its layer axis."""
    if isinstance(ref_tree, dict):
        assert sorted(port_view) == sorted(ref_tree)
        for k in ref_tree:
            _assert_same_specs(port_view[k], ref_tree[k],
                               stacked or k.startswith("pos"))
        return
    want = _spec(ref_tree)
    if isinstance(port_view, list):  # the layers of a stacked leaf
        for s in port_view:
            assert (None,) + s == want or (s == () and want == ()), (s, want)
        return
    assert port_view == (want[1:] if stacked and want else want), \
        (port_view, want)


@pytest.mark.parametrize("n", [2, 4])
def test_specs_match_reference(n):
    jfac = jtp.PagedTP(CFG, AbstractMesh((n,), ("model",)))
    tfac = ttp.PagedTP(TCFG, abstract_mesh(n))
    for k in ("num_heads", "num_kv_heads", "head_dim", "d_ff"):
        assert getattr(tfac.cfg_local, k) == getattr(jfac.cfg_local, k), k
    _assert_same_specs(bridge.ref_view(tfac.param_specs, TCFG),
                       jfac.param_specs, False)
    for kvd in ("fp32", "int8"):
        jfac.kv_dtype = tfac.kv_dtype = kvd
        ref_pools = jfac.pool_pspecs(10, 8)["seg0"]["pos0"]
        for pool in tfac.pool_pspecs(10, 8):
            assert sorted(pool) == sorted(ref_pools)
            for leaf, spec in pool.items():
                assert (None,) + spec == _spec(ref_pools[leaf]), (kvd, leaf)
    # a per-slot compacted FF tree: [slots, D, k] / [slots, k, D]
    D, k, L, B = CFG.d_model, 256, CFG.num_layers, 3
    jpr = {"seg0": {"pos0": {"w1": np.zeros((L, B, D, k), np.float32),
                             "wg": np.zeros((L, B, D, k), np.float32),
                             "w2": np.zeros((L, B, k, D), np.float32)}}}
    tpr = {li: {"w1": torch.zeros(B, D, k), "wg": torch.zeros(B, D, k),
                "w2": torch.zeros(B, k, D)} for li in range(L)}
    jspecs = jfac.pruned_pspecs(jpr)["seg0"]["pos0"]
    for li, leaves in tfac.pruned_pspecs(tpr).items():
        for leaf, spec in leaves.items():
            assert (None,) + spec == _spec(jspecs[leaf]), (li, leaf)


def test_tp_refuses_indivisible_dims():
    """tinylm (6 heads, 3 KV heads) on 2 ranks, and a compacted width of
    255 on 2: both packages refuse with the same message."""
    with pytest.raises(ValueError) as jerr:
        jtp.PagedTP(get_config("tinylm"), AbstractMesh((2,), ("model",)))
    with pytest.raises(ValueError) as terr:
        ttp.PagedTP(tget("tinylm"), abstract_mesh(2))
    assert str(terr.value) == str(jerr.value)
    assert "divisible" in str(terr.value)
    tfac = ttp.PagedTP(TCFG, abstract_mesh(2))
    with pytest.raises(ValueError, match="tp_shards=2"):
        tfac.pruned_pspecs({0: {"w1": torch.zeros(4, 3, TCFG.d_model, 255)}})


def test_pad_attention_matches_reference():
    jcfg = get_config("llava-next-34b", smoke=True).replace(
        num_heads=14, num_kv_heads=2, head_dim=16, d_model=64)
    tcfg = tget("llava-next-34b", smoke=True).replace(
        num_heads=14, num_kv_heads=2, head_dim=16, d_model=64)
    jpad, tpad = jtr.pad_attention_heads(jcfg, tp=4), ttr.pad_attention_heads(tcfg, tp=4)
    assert tpad.num_heads == jpad.num_heads == 16 and tpad.name == jpad.name
    assert ttr.pad_attention_heads(tcfg, tp=2) is tcfg  # 14 % 2 == 0
    jp = jax.tree.map(np.asarray, jparam.init_params(
        jattn.attn_specs(jcfg), jax.random.PRNGKey(0), "float32"))
    tp = {k: torch.from_numpy(v.copy()) for k, v in jp.items()}
    jpp = jtr.pad_attention_params(jp, jcfg, jpad)
    tpp = ttr.pad_attention_params(tp, tcfg, tpad)
    for k, v in jpp.items():
        np.testing.assert_array_equal(tpp[k].numpy(), np.asarray(v), err_msg=k)
    # the padded heads contribute nothing (the reference's test_layers.py)
    B, S = 2, 12
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (B, S, tcfg.d_model)).astype(np.float32) * 0.4)
    pos = torch.arange(S)[None].expand(B, S)
    y, _ = tattn.attn_forward(tp, x, pos, tcfg)
    y_p, _ = tattn.attn_forward(tpp, x, pos, tpad)
    torch.testing.assert_close(y_p, y, rtol=2e-5, atol=2e-5)


def test_rank_local_compaction_equals_global(params):
    """A balanced selection over global statistics: each rank's experts,
    compacted from its own F-block, are the global compaction's rank
    block; an unbalanced selection refuses."""
    _, tparams = params
    n, F = 2, TCFG.d_ff
    gcfg = tg.GriffinConfig(sparsity=0.5, tp_shards=n, per_shard_topk=True)
    s_sq = torch.from_numpy(np.random.default_rng(5).random((1, F)).astype(np.float32))
    ffn = tdec.extract_ffn_tree(tparams, TCFG)
    glob, widths = tg.select_and_compact({0: {"s_sq": s_sq}}, {0: ffn[0]}, gcfg)
    gspecs = None
    for r in range(n):
        fac = ttp.PagedTP(TCFG, ServingMesh(size=n, rank=r))
        local_ffn = tdec.extract_ffn_tree(fac.shard_params(tparams), TCFG)
        loc, lw = tg.select_and_compact({0: {"s_sq": s_sq}}, {0: local_ffn[0]},
                                        gcfg, shard=(r, n))
        assert lw == widths and loc[0]["w1"].shape[-1] == widths[0] // n
        gspecs = fac.pruned_pspecs(glob)
        want = fac.shard_pruned(glob)
        for k in loc[0]:
            torch.testing.assert_close(loc[0][k], want[0][k], rtol=0, atol=0)
    assert gspecs[0]["w2"] == ("model",)
    with pytest.raises(ValueError, match="balanced"):
        tg.shard_indices(torch.arange(4), F, 0, n)


def test_per_rank_trees_equal_shard_params(params):
    """``bridge.params_from_jax(..., tp=)`` and ``PagedTP.init_params``
    give each rank exactly ``shard_params`` of the whole tree."""
    js, tparams = params
    full = tdec.init_params(TCFG, seed=0, device="cpu")
    for r in range(2):
        fac = ttp.PagedTP(TCFG, ServingMesh(size=2, rank=r))
        for a, b in ((bridge.params_from_jax(js, TCFG, "cpu", tp=fac),
                      fac.shard_params(tparams)),
                     (fac.init_params(0, "cpu"), fac.shard_params(full))):
            fa, fb = _leaves(a), _leaves(b)
            assert len(fa) == len(fb)
            for x, y in zip(fa, fb):
                assert torch.equal(x, y)
        assert ttp.tree_bytes(fac.shard_params(tparams)) < ttp.tree_bytes(tparams)
        # pools: a rank's block of the global pools has its local pools' shapes
        pools = tdec.init_paged_pools(TCFG, 10, 8, "int8", device="cpu")
        for layer in pools:
            for buf in layer.values():
                buf.copy_(torch.arange(buf.numel()).reshape(buf.shape).to(buf.dtype))
        fac8 = ttp.PagedTP(TCFG, ServingMesh(size=2, rank=r), kv_dtype="int8")
        local = fac8.shard_pools(pools, 10, 8)
        kv = TCFG.num_kv_heads // 2
        for g, l, want in zip(pools, local, fac8.init_pools(10, 8, "cpu")):
            for k in g:
                assert l[k].shape == want[k].shape
                assert torch.equal(l[k], g[k][:, :, r * kv:(r + 1) * kv])


def test_two_step_stat_matches_reference():
    """Row norms summed over 2 column blocks, then the statistic of each
    block from them: the reference's ``griffin_stat_sq`` of the whole."""
    rng = np.random.default_rng(7)
    z = rng.standard_normal((2, 9, 64)).astype(np.float32)
    z[0, 3] = 0.0  # an all-zero row contributes 0
    want = np.asarray(jffn.griffin_stat_sq(jnp.asarray(z)))
    zt = torch.from_numpy(z)
    blocks = zt.chunk(2, dim=-1)
    row = sum(ops.griffin_row_sq(b.contiguous()) for b in blocks)
    got = torch.cat([ops.griffin_stat_from_norm(b.contiguous(), row)
                     for b in blocks], dim=-1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(ref.expert_stat_from_norm_ref(
        zt, ref.expert_stat_row_sq_ref(zt)), ref.expert_stat_ref(zt),
        rtol=0, atol=0)


# ---------------------------------------------------------------------------
# spawned gloo ranks
# ---------------------------------------------------------------------------

def _gather_rank(mesh, stats_global):
    """One rank: its F-blocks of the global statistics -> gather_stats."""
    n, r = mesh.size, mesh.rank
    local = {}
    for li, leaf in stats_global.items():
        w = leaf["s_sq"].shape[-1] // n
        local[li] = {"s_sq": torch.from_numpy(leaf["s_sq"][..., r * w:(r + 1) * w]),
                     "z_sq": torch.from_numpy(leaf["z_sq"][..., r * w:(r + 1) * w]),
                     "x_sq": torch.from_numpy(leaf["x_sq"])}
    out = ttp.gather_stats(local, mesh)
    return {li: {k: v.numpy() for k, v in leaf.items()} for li, leaf in out.items()}


def test_gather_stats_exact():
    rng = np.random.default_rng(9)
    stats = {li: {"s_sq": rng.random((2, 16)).astype(np.float32),
                  "z_sq": rng.random(16).astype(np.float32),
                  "x_sq": rng.random(8).astype(np.float32)} for li in (0, 2)}
    outs, _ = run_ranks(_gather_rank, 2, backend="gloo", device="cpu",
                        args=(stats,), timeout_s=120)
    for out in outs:
        assert sorted(out) == sorted(stats)
        for li, leaf in stats.items():
            for k, v in leaf.items():
                np.testing.assert_array_equal(out[li][k], v)


def _failing_rank(mesh):
    """Rank 1 raises; rank 0 waits in a collective rank 1 never joins."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.all_reduce(torch.ones(1), group=mesh.group)


def test_run_ranks_reports_a_failed_rank():
    """A rank's exception reaches the parent as a RuntimeError with its
    traceback, and the rank blocked in a collective is stopped, well
    before the collectives' timeout."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(_failing_rank, 2, backend="gloo", device="cpu", timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_make_serving_mesh_refusals(monkeypatch):
    from repro_torch.launch.mesh import make_serving_mesh

    with pytest.raises(ValueError, match="backend"):
        make_serving_mesh(2, backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="gloo"):
        make_serving_mesh(2, backend="nccl", device="cpu")
    # one card, two NCCL ranks: refused, naming gloo
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="backend='gloo'"):
        make_serving_mesh(2, backend="nccl")


def _jax_streams(js, gcfg_j, spec_k):
    srv = JaxServer(CFG, jax.tree.map(jnp.asarray, js), gcfg=gcfg_j,
                    spec_k=spec_k, **KW)
    for i, p in enumerate(PROMPTS):
        srv.submit(p, MAX_NEW, rid=i)
    return srv.drain()


@pytest.mark.parametrize("spec_k", [0, 4])
def test_tp_server_token_identity(params, spec_k):
    js, tparams = params
    n = 2
    gcfg = tg.GriffinConfig(sparsity=0.5, per_shard_topk=True, tp_shards=n)
    gcfg_j = jg.GriffinConfig(sparsity=0.5, per_shard_topk=True, tp_shards=n)
    kw = dict(KW, spec_k=spec_k)
    single = PagedServer(TCFG, tparams, gcfg, device="cpu", **kw)
    for i, p in enumerate(PROMPTS):
        single.submit(p, MAX_NEW, rid=i)
    want = single.drain()
    assert want == _jax_streams(js, gcfg_j, spec_k)
    assert len({t for s in want.values() for t in s}) > 4, want
    ranks, _ = run_ranks(serve.serve_requests, n, backend="gloo", device="cpu",
                         args=(TCFG, tparams, gcfg,
                               [(p, MAX_NEW) for p in PROMPTS], kw),
                         timeout_s=180)
    total = ttp.pool_shard_bytes(single.pools)
    for res in ranks:
        assert res["streams"] == want
        assert res["pool_bytes"] * n == total
        assert res["prefix_hits"] >= 1
        if spec_k:
            assert res["metrics"]["spec_rounds"] >= 1
        else:
            assert res["metrics"]["preemptions"] >= 1


def test_launcher_mesh_cpu(tmp_path, capfd):
    """With flocking telemetry on: its probe on a rank is a statistics
    step whose global statistics feed the monitor."""
    out = serve.main(["--arch", "tinylm-tp", "--device", "cpu", "--mesh",
                      "model=2", "--requests", "3", "--max-len", "64",
                      "--flocking-telemetry", "2", "--ckpt-dir", str(tmp_path)])
    text = capfd.readouterr().out
    assert sorted(out) == [0, 1, 2] and all(out.values())
    for line in ("[mesh] model=2: 2 ranks on gloo (cpu)",
                 "[GRIFFIN@50%+tp2] paged: served 3 requests",
                 "ttft p50=", "prefix: hit_rate=", "flocking: jaccard="):
        assert line in text, (line, text)
    assert text.count("paged: served") == 1  # rank 0 only
