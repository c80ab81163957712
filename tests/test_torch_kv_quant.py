"""The port's quantized KV pools (int8 / fp8) on the CPU, held against the
JAX package.

* The codec (``kernels/kv_quant.py``) bit for bit: ``new_scale``,
  ``quantize`` (half-way values, values at and past +-qmax),
  ``quantize_scatter_ref`` and ``gather_scales``.
* The quantized plain ``paged_attn`` on warm pools (every real page holds
  live bits under a grown scale), by the fuzz of ``tests/test_kv_quant.py``:
  ctx within 1e-5 on written rows, pools and scales bit-identical except
  the trash page, which the reference's fused kernel never writes; its ctx
  error against the fp32-pool plain version within ``ERROR_BUDGET``.
* Monotone scales, and the re-encode is the identity where a page's
  scale did not change.
* ``paged_attn_step`` on both backends, the scale leaves, copy-on-write
  carrying scales, byte accounting.
* ``PagedServer`` with int8 pools token-identical to the JAX server's on
  the five traces of ``tests/test_torch_server.py``, fp8 on two, with the
  same modeled attention bytes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config  # noqa: E402
from repro.core import griffin as jg  # noqa: E402
from repro.kernels import kv_quant as jq  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models.layers import attention as jattn  # noqa: E402
from repro.serving.server import PagedServer as JaxServer  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import griffin as tg  # noqa: E402
from repro_torch.kernels import kv_quant as tq  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402
from repro_torch.models.layers import attention as tattn  # noqa: E402
from repro_torch.serving.server import PagedServer  # noqa: E402
from test_torch_server import TRACES, _serve, params  # noqa: E402,F401

QUANT = ["int8", "fp8"]
JDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
CFG = get_config("tinylm")
TCFG = tget("tinylm")


def _t(a):
    return torch.from_numpy(np.array(a))


def _bits(x):
    """Pool or scale contents as numpy bytes/floats for exact comparison."""
    if isinstance(x, torch.Tensor):
        return tq.as_bytes(x).numpy()
    a = np.asarray(x)
    return a.view(np.uint8) if a.dtype.itemsize == 1 and a.dtype != np.int8 else a


def _warm_case(rng, B, S, H, KV, hd, page, W, kvd):
    """Random decode/prefill inputs over *warm* quantized pools, as
    ``tests/test_kv_quant.py::_mk_quant_case`` builds them: fp32 pools
    quantized through the scatter so every real page starts with live bits
    and a grown scale (the port's scatter, held bit for bit to the
    reference's by ``test_codec_matches_jax_bit_for_bit``)."""
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    kn = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    vn = rng.normal(size=(B, S, KV, hd)).astype(np.float32)
    lens = rng.integers(0, (W - 1) * page - S, size=B)
    need = [-(-(int(n) + S) // page) for n in lens]
    P = sum(need) + 2
    pkf = rng.normal(size=(P + 1, page, KV, hd)).astype(np.float32)
    pvf = rng.normal(size=(P + 1, page, KV, hd)).astype(np.float32)
    z = torch.zeros((P + 1, page, KV, hd),
                    dtype=tq.pool_torch_dtype(kvd, "float32"))
    s0 = torch.zeros((P + 1, 1, KV, 1))
    gp = torch.arange(P + 1).repeat_interleave(page)
    off = torch.arange(page).repeat(P + 1)
    pk, sk = tq.quantize_scatter_ref(z, s0, gp, off,
                                     _t(pkf).reshape(-1, KV, hd), kvd)
    pv, sv = tq.quantize_scatter_ref(z, s0, gp, off,
                                     _t(pvf).reshape(-1, KV, hd), kvd)
    bt = np.full((B, W), -1, np.int32)
    perm = rng.permutation(P)
    c = 0
    for b in range(B):
        bt[b, : need[b]] = perm[c : c + need[b]]
        c += need[b]
    wm = rng.random((B, S)) > 0.25
    if B > 1:
        wm[-1] = False
    return dict(q=q, kn=kn, vn=vn, pk=pk, pv=pv, sk=sk, sv=sv, bt=bt,
                pos=lens.astype(np.int32), wm=wm, pkf=pkf, pvf=pvf)


def _to_jax_pool(t):
    """A torch pool (int8 or float8 bits) as the same bits in JAX."""
    a = tq.as_bytes(t).numpy()
    return jnp.asarray(a if t.dtype == torch.int8 else a.view(jnp.float8_e4m3fn))


def _jax_args(c):
    return (jnp.asarray(c["q"]), jnp.asarray(c["kn"]), jnp.asarray(c["vn"]),
            _to_jax_pool(c["pk"]), _to_jax_pool(c["pv"]), jnp.asarray(c["bt"]),
            jnp.asarray(c["pos"]), jnp.asarray(c["wm"]))


def _jax_scales(c):
    return dict(scale_k=jnp.asarray(c["sk"].numpy()),
                scale_v=jnp.asarray(c["sv"].numpy()))


def _torch_args(c):
    return (_t(c["q"]), _t(c["kn"]), _t(c["vn"]), c["pk"].clone(),
            c["pv"].clone(), _t(c["bt"]), _t(c["pos"]), _t(c["wm"]))


def _torch_scales(c):
    return dict(scale_k=c["sk"].clone(), scale_v=c["sv"].clone())


#: the reference's plain paged attention, compiled once per shape
_jax_paged_attn_ref = jax.jit(jops.paged_attn_ref,
                              static_argnames=("window", "kv_dtype"))


def _assert_same_step(outs, want, wm, what):
    """ctx within 1e-5 on rows that were written; pools and scales
    bit-identical except the trash page."""
    assert len(outs) == 5 and len(want) == 5
    rows = wm.any(axis=1)
    np.testing.assert_allclose(outs[0].numpy()[rows],
                               np.asarray(want[0])[rows], rtol=1e-5,
                               atol=1e-5, err_msg=what)
    for i in (1, 2, 3, 4):
        np.testing.assert_array_equal(_bits(outs[i])[:-1], _bits(want[i])[:-1],
                                      err_msg=f"{what} output {i}")


# ---------------------------------------------------------------------------
# the codec, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kvd", QUANT)
def test_codec_matches_jax_bit_for_bit(kvd):
    rng = np.random.default_rng(1)
    qm = tq.qmax(kvd)
    assert qm == jq.qmax(kvd) and tq.EPS == jq.EPS
    assert tq.ERROR_BUDGET == jq.ERROR_BUDGET
    assert tq.TOKEN_MATCH_FLOOR == jq.TOKEN_MATCH_FLOOR
    # new_scale: the reciprocal multiply, pinned bit for bit
    s_old = np.abs(rng.normal(size=(64, 3))).astype(np.float32) * 0.01
    s_old[:8] = 0.0
    amax = np.abs(rng.normal(size=(64, 3)) * 3).astype(np.float32)
    np.testing.assert_array_equal(
        tq.new_scale(_t(s_old), _t(amax), kvd).numpy(),
        np.asarray(jq.new_scale(jnp.asarray(s_old), jnp.asarray(amax), kvd)))
    # quantize: half-way values (ties to even), values at +-qmax, values a
    # rounding past it, tiny values, under a unit scale and a random one
    special = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5, qm, -qm,
                        qm * (1 + 2**-20), -qm * (1 + 2**-20), 1e-30, 0.0,
                        3.25, 0.0078125], np.float32)
    x = np.concatenate([special, rng.normal(size=200).astype(np.float32) * 40])
    for s in (np.float32(1.0), np.float32(0.0123), np.float32(tq.EPS)):
        xs = x if s == 1.0 else x * s
        got = tq.quantize(_t(xs), _t(s), kvd)
        want = jq.quantize(jnp.asarray(xs), jnp.asarray(s), kvd)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=str(s))
        np.testing.assert_array_equal(
            tq.dequantize(got, _t(s)).numpy(),
            np.asarray(jq.dequantize(want, jnp.asarray(s))))
    # quantize_scatter_ref over a warm pool (several rows per page, rows
    # to the trash page) and gather_scales
    c = _warm_case(rng, B=3, S=4, H=4, KV=2, hd=8, page=4, W=6, kvd=kvd)
    P1 = c["pk"].shape[0]
    slots = rng.choice(P1 * 4, size=12, replace=False)  # distinct slots
    gp, off = (slots // 4).astype(np.int32), (slots % 4).astype(np.int32)
    rows = (rng.normal(size=(12, 2, 8)) * 3).astype(np.float32)
    gb, gs = tq.quantize_scatter_ref(c["pk"], c["sk"], _t(gp), _t(off),
                                     _t(rows), kvd)
    wb, ws = jq.quantize_scatter_ref(
        _to_jax_pool(c["pk"]), jnp.asarray(c["sk"].numpy()), jnp.asarray(gp),
        jnp.asarray(off), jnp.asarray(rows), kvd)
    # the warm pool itself: the same bits through the reference's scatter
    pkf = c["pkf"].reshape(-1, 2, 8)
    P1, page = c["pk"].shape[:2]
    jb, js = jq.quantize_scatter_ref(
        jnp.zeros(c["pk"].shape, JDT[kvd]), jnp.zeros((P1, 1, 2, 1)),
        jnp.arange(P1).repeat(page), jnp.tile(jnp.arange(page), P1),
        jnp.asarray(pkf), kvd)
    np.testing.assert_array_equal(_bits(c["pk"]), _bits(jb))
    np.testing.assert_array_equal(c["sk"].numpy(), np.asarray(js))
    np.testing.assert_array_equal(_bits(gb), _bits(wb))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))
    np.testing.assert_array_equal(
        tq.gather_scales(gs, _t(c["bt"]), 4).numpy(),
        np.asarray(jq.gather_scales(ws, jnp.asarray(c["bt"]), 4)))


def test_page_bytes_and_dtypes_match_jax():
    for kvd in tq.KV_DTYPES:
        for md in ("float32", "bfloat16"):
            assert tq.kv_itemsize(kvd, md) == jq.kv_itemsize(kvd, md)
            for page, KV, hd in ((16, 2, 64), (16, 4, 128), (8, 3, 32)):
                assert tq.page_bytes(page, KV, hd, kvd, md) == \
                    jq.page_bytes(page, KV, hd, kvd, md), (kvd, md)
        assert str(tq.pool_torch_dtype(kvd, "float32")).split(".")[-1] == \
            str(jq.pool_jnp_dtype(kvd, "float32"))
    with pytest.raises(ValueError, match="kv_dtype"):
        tq.resolve_kv_dtype("int4")


# ---------------------------------------------------------------------------
# the quantized plain paged_attn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kvd", QUANT)
def test_quantized_paged_attn_matches_jax_kernel(kvd):
    """One warm case against the JAX package's fused kernel (interpret
    mode) and its reference."""
    rng = np.random.default_rng(11)
    c = _warm_case(rng, B=3, S=2, H=4, KV=2, hd=8, page=4, W=6, kvd=kvd)
    outs = ops.paged_attention(*_torch_args(c), **_torch_scales(c),
                               kv_dtype=kvd)
    for want in (jops.paged_attention(*_jax_args(c), **_jax_scales(c),
                                      kv_dtype=kvd),
                 jops.paged_attn_ref(*_jax_args(c), **_jax_scales(c),
                                     kv_dtype=kvd)):
        _assert_same_step(outs, want, c["wm"], kvd)


@pytest.mark.parametrize("kvd", QUANT)
def test_quantized_paged_attn_fuzz_matches_jax(kvd):
    """The fuzz of ``tests/test_kv_quant.py`` against the JAX reference:
    random GQA widths, chunk lengths, pages and table widths."""
    rng = np.random.default_rng(13)
    for trial in range(6):
        KV = int(rng.choice([1, 2, 3]))
        G = int(rng.choice([1, 2, 4]))
        S = int(rng.choice([1, 2, 5]))
        page = int(rng.choice([4, 8]))
        c = _warm_case(rng, B=int(rng.integers(1, 5)), S=S, H=KV * G, KV=KV,
                       hd=8, page=page, W=int(rng.integers(3, 10)), kvd=kvd)
        outs = ops.paged_attention(*_torch_args(c), **_torch_scales(c),
                                   kv_dtype=kvd)
        want = _jax_paged_attn_ref(*_jax_args(c), **_jax_scales(c),
                                   kv_dtype=kvd)
        _assert_same_step(outs, want, c["wm"], f"{kvd} trial {trial}")


@pytest.mark.parametrize("kvd", QUANT)
def test_quantized_ctx_within_error_budget(kvd):
    """Quantized ctx vs the fp32-pool plain version over the same float
    pools: inside ``ERROR_BUDGET``."""
    rng = np.random.default_rng(17)
    worst = 0.0
    for _ in range(4):
        c = _warm_case(rng, B=2, S=1, H=4, KV=2, hd=16, page=8, W=6, kvd=kvd)
        q, kn, vn, pk, pv, bt, pos, wm = _torch_args(c)
        ctx_q = ops.paged_attention(q, kn, vn, pk, pv, bt, pos, wm,
                                    **_torch_scales(c), kv_dtype=kvd)[0]
        ctx_f = ops.paged_attention(q, kn, vn, _t(c["pkf"]), _t(c["pvf"]),
                                    bt, pos, wm)[0]
        rows = c["wm"].any(axis=1)
        if rows.any():
            worst = max(worst, float((ctx_q - ctx_f).abs().numpy()[rows].max()))
    assert 0 < worst <= tq.ERROR_BUDGET[kvd], (kvd, worst)


@pytest.mark.parametrize("kvd", QUANT)
def test_scales_monotone_and_reencode_identity(kvd):
    """Sequential scatters of growing rows: scales never shrink; pages
    that get no row keep bits and scale exactly; old rows stay decodable
    within one quantization step of the new scale (int8)."""
    rng = np.random.default_rng(19)
    KV, hd, page, P = 2, 8, 8, 4
    pool = torch.zeros((P + 1, page, KV, hd),
                       dtype=tq.pool_torch_dtype(kvd, "float32"))
    s = torch.zeros((P + 1, 1, KV, 1))
    written = {}
    for step, mag in enumerate((0.5, 1.0, 4.0, 16.0)):
        rows = torch.from_numpy((rng.normal(size=(P, KV, hd)) * mag)
                                .astype(np.float32))
        # pages 0..P-2 receive a row; page P-1 receives none this step
        gp = torch.arange(P - 1)
        off = torch.full((P - 1,), step)
        new, s_new = tq.quantize_scatter_ref(pool, s, gp, off, rows[: P - 1],
                                             kvd)
        assert bool((s_new >= s).all()), f"{kvd} step {step}: scale shrank"
        np.testing.assert_array_equal(_bits(new)[P - 1:], _bits(pool)[P - 1:])
        np.testing.assert_array_equal(s_new[P - 1:].numpy(), s[P - 1:].numpy())
        pool, s = new, s_new
        for p in range(P - 1):
            written[(p, step)] = rows[p].numpy()
        dec = tq.dequantize(pool, s).numpy()
        for (p, slot), orig in written.items():
            step_sz = np.maximum(s[p, 0, :, 0].numpy(), tq.EPS)[:, None]
            tol = (np.abs(orig) * 0.25 + step_sz * 0.5 if kvd == "fp8"
                   else np.broadcast_to(step_sz * 1.01, orig.shape))
            assert (np.abs(dec[p, slot] - orig) <= tol).all(), (kvd, p, slot)


# ---------------------------------------------------------------------------
# the layer step and the pool plumbing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kvd", QUANT)
def test_paged_attn_step_quantized_matches_jax(params, kvd):
    """Full layer step on quantized pools: both port backends against the
    JAX gather path (its fused path is held to it by the JAX tests)."""
    jp, tp = params["plain"]
    jmixer = jax.tree.map(lambda v: jnp.asarray(v[0]),
                          jp["seg0"]["pos0"]["mixer"])
    rng = np.random.default_rng(3)
    B, S, page, W, P = 3, 2, 8, 6, 12
    KV, hd = CFG.num_kv_heads, CFG.head_dim
    x = rng.normal(size=(B, S, CFG.d_model)).astype(np.float32)
    bt = np.full((B, W), -1, np.int32)
    pos = np.asarray([0, 9, 17], np.int32)
    c = 0
    for b in range(B):
        need = -(-(int(pos[b]) + S) // page)
        bt[b, :need] = np.arange(c, c + need)
        c += need
    wm = np.ones((B, S), bool)
    wm[2, 1] = False
    jpool = {
        "k": jnp.zeros((P + 1, page, KV, hd), JDT[kvd]),
        "v": jnp.zeros((P + 1, page, KV, hd), JDT[kvd]),
        "k_scale": jnp.zeros((P + 1, 1, KV, 1), jnp.float32),
        "v_scale": jnp.zeros((P + 1, 1, KV, 1), jnp.float32),
    }
    # eager, as the reference's tests run it (under jit XLA may round the
    # projections differently, which moves a scale by an ulp)
    y_j, pool_j = jattn.paged_attn_step(
        jmixer, jpool, jnp.asarray(bt), jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(wm), CFG, backend="gather", kv_dtype=kvd)
    for backend in ("gather", "fused"):
        tpool = tdec.init_paged_pools(TCFG, P, page, kvd, device="cpu")[0]
        y_t, tpool = tattn.paged_attn_step(
            tp["layers"][0]["mixer"], tpool, _t(bt), _t(x), _t(pos), _t(wm),
            TCFG, backend=backend, kv_dtype=kvd)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-5,
                                   atol=1e-5, err_msg=backend)
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(_bits(tpool[key])[:-1],
                                          _bits(pool_j[key])[:-1],
                                          err_msg=f"{backend} {key}")
        assert tpool["k"].dtype == tq.pool_torch_dtype(kvd, "float32")


def test_scale_leaves_and_cow_carry_scales():
    for kvd in ("fp32", "bf16"):
        assert set(tattn.paged_cache_specs(TCFG, 8, 16, kvd)) == {"k", "v"}
    for kvd in QUANT:
        specs = tattn.paged_cache_specs(TCFG, 8, 16, kvd)
        jspecs = jattn.paged_cache_specs(CFG, 8, 16, kvd)
        assert set(specs) == set(jspecs) == {"k", "v", "k_scale", "v_scale"}
        for name in specs:
            assert specs[name].shape == jspecs[name].shape, (kvd, name)
            assert specs[name].axes == jspecs[name].axes, (kvd, name)
        assert specs["k_scale"].dtype == "float32"
        # a bf16 model keeps fp32 scales
        bspecs = tattn.paged_cache_specs(TCFG.replace(dtype="bfloat16"), 8,
                                         16, kvd)
        assert bspecs["k_scale"].dtype == "float32"
        pools = tdec.init_paged_pools(TCFG, 8, 16, kvd, device="cpu")
        assert {str(t.dtype) for p in pools for t in p.values()} == {
            str(tq.pool_torch_dtype(kvd, "float32")), "torch.float32"}
        # distinctive bits and scales in page 2 of every leaf, then a COW
        # fork 2 -> 5 copies both
        for p in pools:
            for name, leaf in p.items():
                fill = torch.full(leaf.shape[1:], 3.0 if "scale" in name else 1.5)
                leaf[2] = fill.to(leaf.dtype)
        tdec.copy_pool_pages(TCFG, pools, torch.tensor([2]), torch.tensor([5]))
        for p in pools:
            for name, leaf in p.items():
                np.testing.assert_array_equal(_bits(leaf)[5], _bits(leaf)[2],
                                              err_msg=f"{kvd} {name}")
                assert bool((leaf[5].float() != 0).all()), (kvd, name)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

SERVER_CASES = [("int8", t) for t in sorted(TRACES)] + \
    [("fp8", "griffin"), ("fp8", "shared_prefix_cow")]


@pytest.mark.parametrize("kvd,trace", SERVER_CASES)
def test_server_quantized_streams_match_jax(params, kvd, trace):
    jp, tp = params["scaled"]
    kw, drains, checks = TRACES[trace]
    gj = jg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    gt = tg.GriffinConfig(sparsity=0.5, per_shard_topk=False)
    js, want, _ = _serve(JaxServer, CFG, jax.tree.map(jnp.asarray, jp), gj,
                         kw, drains, kv_dtype=kvd)
    ts, got, margins = _serve(PagedServer, TCFG, tp, gt, kw, drains,
                              device="cpu", kv_dtype=kvd)
    assert ts.pools[0]["k"].dtype == tq.pool_torch_dtype(kvd, "float32")
    assert sorted(got) == sorted(want)
    for rid in want:
        if got[rid] != want[rid]:
            i = next(i for i, (a, b) in enumerate(zip(got[rid], want[rid]))
                     if a != b)
            pytest.fail(f"{kvd} {trace}: rid {rid} differs at token {i}: "
                        f"port {got[rid]} vs jax {want[rid]}; port top-2 "
                        f"margin there {margins[rid][i]:.3g}")
    sj, st = js.metrics.summary(), ts.metrics.summary()
    for key in ("preemptions", "cow_copies", "generated_tokens",
                "prefill_chunks", "steps", "attn_bytes_read_total",
                "attn_bytes_per_token"):
        assert st[key] == sj[key], key
    for key, least in checks.items():
        v = ts.metrics.prefix_hits if key == "prefix_hits" else st[key]
        assert v >= least, (key, v)
    ts.sched.alloc.check()
