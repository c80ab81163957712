"""The port's FF kernel entry points on the CPU, held against the JAX
package.

On the CPU ``ops.griffin_ffn_decode`` and ``ops.glu_ffn_forward`` run
their plain versions (``kernels/ref.py``); the JAX side runs its Pallas
kernels in interpret mode and its ``ref.py`` oracles on the same numpy
inputs, over the grid and with the tolerances of
``tests/test_kernels.py`` (fp32 1e-5; bf16 2e-2, where the two frameworks
round the products to bf16 at other places).  Beside them: the
block selector and ``ffn_forward`` the pruned kernel pairs with, and the
zero-copy contract — block selection followed by the kernel equals the
compacted model FF.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core import selector as jsel  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.layers import ffn as jffn  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import selector as tsel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.layers import ffn as tffn  # noqa: E402

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" else dict(rtol=1e-5,
                                                                atol=1e-5)


def _pair(a, dt):
    """The same numpy values as a JAX and a torch array of dtype ``dt``
    (bf16: JAX rounds once and torch takes the same values)."""
    jd, td = DTYPES[dt]
    j = jnp.asarray(a, jd)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("B,D,F,BK,nsel", [
    (1, 128, 512, 128, 2),
    (4, 256, 1024, 128, 4),
    (8, 128, 2048, 256, 3),
])
@pytest.mark.parametrize("act", ["swiglu", "geglu", "reglu"])
def test_griffin_ffn_plain_matches_jax(dt, B, D, F, BK, nsel, act):
    rng = np.random.default_rng(B * D + F)
    x, xt = _pair(rng.normal(size=(B, D)), dt)
    wg, wgt = _pair(rng.normal(size=(F, D)) * 0.05, dt)
    w1, w1t = _pair(rng.normal(size=(F, D)) * 0.05, dt)
    w2, w2t = _pair(rng.normal(size=(F, D)) * 0.05, dt)
    ids = np.sort(rng.choice(F // BK, size=nsel, replace=False)).astype(np.int32)
    got = ops.griffin_ffn_decode(xt, wgt, w1t, w2t, torch.from_numpy(ids),
                                 block_size=BK, activation=act)
    assert got.dtype == torch.float32 and got.shape == (B, D)
    for want in (jops.griffin_ffn_decode(x, wg, w1, w2, jnp.asarray(ids),
                                         block_size=BK, activation=act),
                 jops.griffin_ffn_ref(x, wg, w1, w2, jnp.asarray(ids), BK,
                                      activation=act)):
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


@pytest.mark.parametrize("bad", [8, 11, -1])
def test_griffin_ffn_plain_bad_block_id_adds_nothing(bad):
    """A block id outside [0, F / block_size) is a block that adds
    nothing, as in both kernel paths; the JAX reference clamps such ids
    (its gather), so the input lies outside both packages' contract and
    has no parity test."""
    rng = np.random.default_rng(5)
    B, D, F, BK = 3, 64, 512, 64
    x, wg, w1, w2 = (torch.tensor(rng.normal(size=s), dtype=torch.float32)
                     for s in ((B, D), (F, D), (F, D), (F, D)))
    good = torch.tensor([5, 2, 7], dtype=torch.int32)
    with_bad = torch.tensor([5, bad, 2, 7], dtype=torch.int32)
    want = ops.griffin_ffn_decode(x, wg, w1, w2, good, block_size=BK)
    got = ops.griffin_ffn_decode(x, wg, w1, w2, with_bad, block_size=BK)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("S,D,F", [(64, 128, 512), (300, 256, 1024)])
def test_glu_ffn_plain_matches_jax(dt, S, D, F):
    rng = np.random.default_rng(S + D)
    x, xt = _pair(rng.normal(size=(S, D)), dt)
    wg, wgt = _pair(rng.normal(size=(D, F)) * 0.05, dt)
    w1, w1t = _pair(rng.normal(size=(D, F)) * 0.05, dt)
    w2, w2t = _pair(rng.normal(size=(F, D)) * 0.05, dt)
    got = ops.glu_ffn_forward(xt, wgt, w1t, w2t)
    assert got.dtype == torch.float32 and got.shape == (S, D)
    for want in (jops.glu_ffn_forward(x, wg, w1, w2),
                 jops.glu_ffn_ref(x, wg, w1, w2)):
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dt))


@pytest.mark.parametrize("M,F,D,itemsize", [
    (32, 11008, 4096, 2),   # Yi-9B prefill chunk, bf16
    (32, 11008, 4096, 4),
    (1, 11008, 4096, 2),
    (33, 11008, 4096, 2),   # one ragged 64-row tile
    (300, 1024, 256, 2), (300, 1024, 256, 4),
    (5, 1001, 96, 2),       # odd F
    (3, 200, 96, 4),
    (2, 64, 4096, 2),       # one k tile of z: one down range
    (64, 40, 8192, 4),
    (300, 128, 16384, 2),   # the column tiles alone fill the card
])
def test_glu_ffn_plan_covers_every_row(M, F, D, itemsize):
    """The dense FF kernel's two passes cut their K rows (D for the up
    pass, F for the down pass) into at most one cluster's worth of
    ranges, each a whole number of k tiles and none empty, covering every
    row exactly once, with no more CTAs than fit the card at once; the
    row tiles cover M."""
    from repro_torch.kernels.ffn_common import CTAS_PER_SM, MAX_SPLITS
    from repro_torch.kernels.glu_ffn import (DOWN_COLS, DOWN_K_BYTES, UP_COLS,
                                             UP_K_BYTES, glu_plan, row_tile)

    n_sm = 132
    mt = row_tile(M)
    assert mt in (32, 64) and (M <= 32) == (mt == 32)
    m_tiles = -(-M // mt)
    assert (m_tiles - 1) * mt < M <= m_tiles * mt
    up, down = glu_plan(M, D, F, n_sm, itemsize)
    for (splits, rps), K, kb, cols, N in ((up, D, UP_K_BYTES, UP_COLS, F),
                                          (down, F, DOWN_K_BYTES, DOWN_COLS, D)):
        assert 1 <= splits <= MAX_SPLITS
        assert rps > 0 and rps % (kb // itemsize) == 0
        rows = np.zeros(K, np.int64)
        for sp in range(splits):
            lo, hi = sp * rps, min(K, (sp + 1) * rps)
            assert lo < hi
            rows[lo:hi] += 1
        assert (rows == 1).all()
        tiles = -(-N // cols) * m_tiles
        assert splits == 1 or tiles * splits <= CTAS_PER_SM * n_sm


@pytest.mark.parametrize("M,D,n_sel,bs,itemsize", [
    (2, 4096, 5504, 128, 2),    # Yi-9B decode, 43 of 86 blocks, bf16
    (2, 4096, 5504, 128, 4),
    (2, 4096, 11008, 128, 2),   # every block
    (1, 4096, 128, 128, 2),     # one block
    (9, 4096, 5568, 64, 2),     # 87 blocks of 64
    (17, 4096, 5376, 256, 2),   # a 64-row tile, blocks of 4 boxes
    (33, 4096, 5504, 128, 4),
    (2, 4096, 5440, 32, 2),     # blocks smaller than a box: no TMA
    (3, 100, 256, 128, 2),      # D = 100: a ragged k tile
    (5, 256, 448, 64, 4),
    (2, 8192, 14336, 128, 2),   # the column tiles alone fill the card
])
def test_griffin_plan_covers_every_row(M, D, n_sel, bs, itemsize):
    """The pruned FF kernel's two passes: the up pass's neuron tiles cover
    the n_sel selected rows of Wg/W1 and its ranges every row of D, the
    down pass's ranges cover every selected row of W2 and its column tiles
    every column of y, each exactly once; at most one cluster's worth of
    ranges, each a whole number of k tiles and none empty, with no more
    CTAs than fit the card at once.  Where the weights come by TMA (bf16,
    the block size a multiple of the box), every 64-row box of mapped rows
    is 64 consecutive rows of one selected block.  The plan's constants
    are the ones compiled into ``csrc/griffin_ffn.cu``."""
    import re
    from pathlib import Path

    from repro_torch.kernels import griffin_ffn as g
    from repro_torch.kernels.ffn_common import MAX_SPLITS

    src = (Path(g.__file__).parents[1] / "csrc" / "griffin_ffn.cu").read_text()
    for name, val in (("kUpN", g.UP_COLS), ("kUpKBytes", g.UP_K_BYTES),
                      ("kDownN", g.DOWN_COLS), ("kDownKBytes", g.DOWN_K_BYTES)):
        assert re.search(rf"constexpr int {name} = {val};", src), name
    n_sm = 132
    mt = g.row_tile(M)
    assert mt in (16, 64) and (M <= 16) == (mt == 16)
    m_tiles = -(-M // mt)
    assert (m_tiles - 1) * mt < M <= m_tiles * mt
    rng = np.random.default_rng(M + n_sel)
    F = 2 * n_sel
    ids = np.sort(rng.choice(F // bs, size=n_sel // bs, replace=False))
    rows = ids[np.arange(n_sel) // bs] * bs + np.arange(n_sel) % bs  # the map
    tma = itemsize == 2 and bs % 64 == 0
    up, down = g.griffin_plan(M, D, n_sel, n_sm, itemsize)
    for (splits, rps), K, kb, cols, N in ((up, D, g.UP_K_BYTES, g.UP_COLS, n_sel),
                                          (down, n_sel, g.DOWN_K_BYTES, g.DOWN_COLS, D)):
        bk = kb // itemsize
        assert 1 <= splits <= MAX_SPLITS
        assert rps > 0 and rps % bk == 0
        k_seen = np.zeros(K, np.int64)
        for sp in range(splits):
            lo, hi = sp * rps, min(K, (sp + 1) * rps)
            assert lo < hi
            k_seen[lo:hi] += 1
        assert (k_seen == 1).all()
        tiles = -(-N // cols)
        n_seen = np.zeros(N, np.int64)
        for t in range(tiles):
            n_seen[t * cols:(t + 1) * cols] += 1
        assert (n_seen == 1).all()
        assert splits == 1 or tiles * m_tiles * splits <= g.ctas_per_sm(M) * n_sm
    if tma:
        # up: a neuron tile's boxes start every 64 rows; down: a range's k
        # tiles (64 bf16 rows) start every 64 rows after the range's start
        starts = set(range(0, n_sel, 64))
        starts |= {sp * down[1] + j for sp in range(down[0])
                   for j in range(0, down[1], 64) if sp * down[1] + j < n_sel}
        for s in starts:
            box = rows[s:s + 64]
            assert len(box) == 64 and (box == box[0] + np.arange(64)).all()
    np.testing.assert_array_equal(np.sort(rows) // bs, np.repeat(ids, bs))


def test_ffn_plain_rejects_unknown_activation():
    x = torch.zeros((2, 8))
    w = torch.zeros((8, 128))
    with pytest.raises(ValueError, match="activation"):
        ops.glu_ffn_forward(x, w, w, w.T, activation="gelu")


def _model_case(seed=3):
    """The weights and tokens of ``test_griffin_kernel_matches_model_ffn``
    (JAX random draws), as numpy."""
    key = jax.random.PRNGKey(seed)
    d, f = 64, 512
    p = {
        "w1": jax.random.normal(key, (d, f)) * 0.1,
        "wg": jax.random.normal(jax.random.fold_in(key, 1), (d, f)) * 0.1,
        "w2": jax.random.normal(jax.random.fold_in(key, 2), (f, d)) * 0.1,
    }
    x = jax.random.normal(jax.random.fold_in(key, 3), (2, 7, d))
    return {k: np.array(v) for k, v in p.items()}, np.array(x)


def test_ffn_forward_and_block_selection_match_jax():
    cfg, tcfg = get_config("tinylm"), tget("tinylm")
    p, x = _model_case()
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    y_j, st_j = jffn.ffn_forward({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), cfg, collect_stats=True)
    y_t, st_t = tffn.ffn_forward(pt, torch.from_numpy(x), tcfg,
                                 collect_stats=True)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    assert set(st_t) == set(st_j) == {"s_sq", "x_sq", "z_sq"}
    for k in st_j:
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    assert tffn.ffn_forward(pt, torch.from_numpy(x), tcfg)[1] is None
    # block ids: random statistics, then pooled ties (every block equal)
    rng = np.random.default_rng(0)
    for s in (rng.random(1024).astype(np.float32),
              np.ones(1024, np.float32)):
        for k, block in ((512, 128), (300, 128), (64, 256), (0, 128)):
            got = tsel.select_block_ids(torch.from_numpy(s), k, block)
            want = jsel.select_block_ids(jnp.asarray(s), k, block)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(
                tsel.select_blocks(torch.from_numpy(s), k, block).numpy(),
                np.asarray(jsel.select_blocks(jnp.asarray(s), k, block)))


def test_griffin_kernel_matches_model_ffn():
    """Port of the reference test of the same name: block selection
    followed by the pruned kernel equals the compacted model FF on the
    decode token, and both equal the reference's."""
    cfg, tcfg = get_config("tinylm"), tget("tinylm")
    p, x = _model_case()
    f, bk = 512, 128
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    _, stats = tffn.ffn_forward(pt, xt, tcfg, collect_stats=True)
    s = stats["s_sq"].sum(0).sqrt()
    idx = tsel.select_blocks(s, f // 2, bk)
    bids = tsel.select_block_ids(s, f // 2, bk)
    y_model, _ = tffn.ffn_forward(tffn.compact_ffn_params(pt, idx), xt, tcfg)
    y_kernel = ops.griffin_ffn_decode(
        xt[:, -1], pt["wg"].T.contiguous(), pt["w1"].T.contiguous(), pt["w2"],
        bids, block_size=bk)
    np.testing.assert_allclose(y_kernel.numpy(), y_model[:, -1].numpy(),
                               rtol=1e-4, atol=1e-4)
    # the reference's selection and kernel on the same inputs
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    _, sj = jffn.ffn_forward(pj, jnp.asarray(x), cfg, collect_stats=True)
    bj = jsel.select_block_ids(jnp.sqrt(jnp.sum(sj["s_sq"], 0)), f // 2, bk)
    np.testing.assert_array_equal(bids.numpy(), np.asarray(bj))
    yj = jops.griffin_ffn_decode(jnp.asarray(x[:, -1]), pj["wg"].T, pj["w1"].T,
                                 pj["w2"], bj, block_size=bk)
    np.testing.assert_allclose(y_kernel.numpy(), np.asarray(yj), rtol=1e-4,
                               atol=1e-4)
