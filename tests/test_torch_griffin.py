"""GRIFFIN selection and compaction of the port, held against the JAX
package on the same statistics.

The bar is exact: the same ``s_sq`` must select the same expert index
sets and so gather the same weights bit for bit, including per-layer
budgets from tiers and profiles, balanced per-shard selection, and ties
(``jax.lax.top_k`` keeps the lower index; the port's stable descending
sort does the same).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core import griffin as jg  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import griffin as tg  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402

CFG = get_config("tinylm")
TCFG = tget("tinylm")


@pytest.fixture(scope="module")
def tiny():
    jp = jax.tree.map(np.asarray, jdec.init_params(CFG, jax.random.PRNGKey(0)))
    return jp, bridge.params_from_jax(jp, TCFG, "cpu")


def _stats(rng, ties: bool):
    """JAX-layout pruned stats tree ({seg: {name: {"s_sq": [n, B, F]}}})."""
    out = {}
    for path, (n, F) in jg.ffn_widths(CFG).items():
        seg, name = path.split("/")
        s = rng.random((n, 1, F)).astype(np.float32)
        if ties:  # few distinct values: every top-k boundary is a tie
            s = np.round(s * 4) / 4
        out.setdefault(seg, {})[name] = {"s_sq": s}
    return out


def _jax_sets(jp, stats_np, gcfg, ks=None):
    sels = {}
    jg.select_and_compact(
        jax.tree.map(jnp.asarray, stats_np),
        jdec.extract_ffn_tree(jp, CFG), gcfg, ks=ks,
        on_select=lambda path, idx: sels.__setitem__(
            path, [np.asarray(i) for i in idx]))
    by_layer = {}
    for li, (path, inst, _) in enumerate(tdec.layer_paths(TCFG)):
        if path in sels:
            by_layer[li] = sels[path][inst]
    return by_layer


CASES = ["global", "ties", "tier", "profile", "per_shard"]


@pytest.mark.parametrize("case", CASES)
def test_select_and_compact_same_sets_as_jax(tiny, case):
    jp, tp = tiny
    rng = np.random.default_rng(CASES.index(case))
    stats_np = _stats(rng, ties=case == "ties")
    gj = jg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    gt = tg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    ks_j = ks_t = None
    if case == "per_shard":
        gj = jg.GriffinConfig(sparsity=0.6, tp_shards=4)
        gt = tg.GriffinConfig(sparsity=0.6, tp_shards=4)
    if case in ("tier", "profile"):
        n = jg.ffn_widths(CFG)["seg0/pos0"][0]
        prof_j = prof_t = None
        if case == "profile":
            ws = (("seg0/pos0", tuple(0.6 + 0.3 * i for i in range(n))),)
            prof_j = jg.SparsityProfile(weights=ws)
            prof_t = tg.SparsityProfile(weights=ws)
        ks_j = jg.plan_k_tree(CFG, gj, tier=0.25, profile=prof_j)
        ks_t = tg.plan_k_tree(TCFG, gt, tier=0.25, profile=prof_t)
        assert ks_t == {li: ks_j[p][i] for li, (p, i, _) in
                        enumerate(tdec.layer_paths(TCFG))}
        if case == "profile":
            assert len(set(ks_t.values())) > 1
    want = _jax_sets(jp, stats_np, gj, ks_j)

    got_sets = {}
    stats_t = bridge.tree_from_jax(stats_np, TCFG, "cpu")
    pruned, widths = tg.select_and_compact(
        stats_t, tdec.extract_ffn_tree(tp, TCFG), gt, ks=ks_t,
        on_select=lambda li, idx: got_sets.__setitem__(li, idx.numpy()))
    assert sorted(got_sets) == sorted(want)
    for li in want:
        np.testing.assert_array_equal(got_sets[li], want[li], err_msg=f"layer {li}")
        assert widths[li] == len(want[li])
        # the compacted weights are the selected columns/rows, bit for bit
        w1 = tp["layers"][li]["ffn"]["w1"].numpy()
        np.testing.assert_array_equal(pruned[li]["w1"].numpy(), w1[:, want[li]])


def test_topk_tie_keeps_lower_index():
    from repro.core import selector as js
    from repro_torch.core import selector as ts

    s = np.array([1.0, 3.0, 2.0, 3.0, 3.0, 0.5, 2.0], np.float32)
    for k in range(1, 7):
        np.testing.assert_array_equal(
            ts.select_topk(torch.from_numpy(s), k).numpy(),
            np.asarray(js.select_topk(jnp.asarray(s), k)))
    np.testing.assert_array_equal(
        ts.select_topk_per_shard(torch.from_numpy(np.tile(s[:6], 2)), 4, 2).numpy(),
        np.asarray(js.select_topk_per_shard(jnp.asarray(np.tile(s[:6], 2)), 4, 2)))
    sb = np.tile(s[:4], 4)
    np.testing.assert_array_equal(
        ts.select_blocks(torch.from_numpy(sb), 8, 4).numpy(),
        np.asarray(js.select_blocks(jnp.asarray(sb), 8, 4)))


def test_tiers_and_config_match_jax():
    for t in (None, 0.25, "0.5", 0.75, 1.0):
        assert tg.resolve_tier(t) == jg.resolve_tier(t)
    with pytest.raises(ValueError):
        tg.resolve_tier(0.3)
    for F in (7, 512, 11008):
        for tier in tg.TIERS:
            for sh in (1, 4):
                assert tg.tier_k(F, tier, 1.3, sh) == jg.tier_k(F, tier, 1.3, sh)
        g = dict(sparsity=0.37, tp_shards=4)
        assert tg.GriffinConfig(**g).k_of(F) == jg.GriffinConfig(**g).k_of(F)
    prof = tg.SparsityProfile(weights=(("seg0/pos0", (1.0, 0.5, 2.0, 1.0)),))
    assert tg.SparsityProfile.from_json(prof.to_json()) == prof
    assert tg.ffn_widths(TCFG) == {li: 512 for li in range(4)}


def test_pad_pruned_tree_is_inert(tiny):
    _, tp = tiny
    rng = np.random.default_rng(3)
    stats = {li: {"s_sq": torch.from_numpy(rng.random((1, 512)).astype(np.float32))}
             for li in range(4)}
    gcfg = tg.GriffinConfig(sparsity=0.75)
    pruned, widths = tg.select_and_compact(stats, tdec.extract_ffn_tree(tp, TCFG),
                                           gcfg)
    padded = tg.pad_pruned_tree(pruned, {li: 256 for li in widths})
    x = torch.from_numpy(rng.normal(size=(1, 3, TCFG.d_model)).astype(np.float32))
    from repro_torch.models.layers.ffn import ffn_forward_perslot

    for li in pruned:
        a = ffn_forward_perslot({k: v[None] for k, v in pruned[li].items()}, x, TCFG)
        b = ffn_forward_perslot({k: v[None] for k, v in padded[li].items()}, x, TCFG)
        assert padded[li]["w2"].shape[0] == 256
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
