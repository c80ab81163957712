"""The paper's evaluation protocols and analysis tools of the port on the
CPU, held against the JAX package at fp32.

* ``evaluate.generation_ppl`` (Figure 5) and ``classification_sim``
  (Table 1) agree with ``repro.core.evaluate`` within a relative 1e-5
  (``nll``; ``agree_full`` and ``acc`` exactly) for every deterministic
  method; the sampling methods run on a ``torch.Generator`` and repeat
  with its seed.  Parameters: tinylm's ``PRNGKey(0)`` draw with the
  projection matrices scaled by 2.
* Adaptive Wanda masks are bit-identical; the magnitude statistic is
  within 1e-6.
* The flocking functions are within 1e-6; ``derive_profile`` weights are
  within 1e-6 and the profile serves through the port's launcher.
* The sampling selectors pick the reference's indices when fed the
  reference's ``jax.random.gumbel`` draw, and draw from the right
  distribution with a ``torch.Generator``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.analysis import profile as jprofile  # noqa: E402
from repro.configs.registry import get_config  # noqa: E402
from repro.core import evaluate as jev  # noqa: E402
from repro.core import flocking as jflock  # noqa: E402
from repro.core import griffin as jg  # noqa: E402
from repro.core import selector as jsel  # noqa: E402
from repro.core import wanda as jwanda  # noqa: E402
from repro.models import decoder as jdec  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.analysis import profile as tprofile  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import evaluate as tev  # noqa: E402
from repro_torch.core import flocking as tflock  # noqa: E402
from repro_torch.core import griffin as tg  # noqa: E402
from repro_torch.core import selector as tsel  # noqa: E402
from repro_torch.core import wanda as twanda  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import decoder as tdec  # noqa: E402

CFG = get_config("tinylm")
TCFG = tget("tinylm")
_MATS = ("wq", "wk", "wv", "wo", "w1", "wg", "w2")
DETERMINISTIC = ("full", "griffin", "griffin_batched", "magnitude", "wanda",
                 "blocks")
P, S = 24, 32  # prompt and sequence length of the PPL protocol


def _scaled(tree, s):
    return {k: _scaled(v, s) if isinstance(v, dict)
            else (v * s if k in _MATS else v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def params():
    jp = _scaled(jax.tree.map(np.asarray,
                              jdec.init_params(CFG, jax.random.PRNGKey(0))),
                 np.float32(2.0))
    return jp, bridge.params_from_jax(jp, TCFG, "cpu")


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, CFG.vocab_size, (3, S)) \
        .astype(np.int32)


@pytest.fixture(scope="module")
def jax_decode():
    """One jitted reference decode step shared by every method's PPL run."""
    return jax.jit(lambda p, c, pr, t, pos: jdec.decode_step(p, CFG, c, t, pos, pr))


@pytest.mark.parametrize("method", DETERMINISTIC)
def test_protocols_match_jax(params, tokens, jax_decode, method):
    jp, tp = params
    want_ppl = jev.generation_ppl(jp, CFG, jnp.asarray(tokens), P, method,
                                  decode_jit=jax_decode)
    got_ppl = tev.generation_ppl(tp, TCFG, torch.from_numpy(tokens), P, method)
    np.testing.assert_allclose(got_ppl, want_ppl, rtol=1e-5)
    want = jev.classification_sim(jp, CFG, jnp.asarray(tokens), method)
    got = tev.classification_sim(tp, TCFG, tokens, method)
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=1e-5)
    assert got["agree_full"] == want["agree_full"]
    assert got["acc"] == want["acc"]
    if method == "full":
        assert got["agree_full"] == 1.0


@pytest.mark.parametrize("method", ["sampling", "topk_sampling"])
def test_sampling_protocols_run(params, tokens, method):
    _, tp = params
    runs = [tev.generation_ppl(tp, TCFG, tokens, P, method,
                               generator=torch.Generator().manual_seed(seed))
            for seed in (0, 0, 1)]
    assert np.isfinite(runs).all() and runs[0] == runs[1]
    out = tev.classification_sim(tp, TCFG, tokens, method,
                                 generator=torch.Generator().manual_seed(0))
    assert np.isfinite(out["nll"])
    with pytest.raises(ValueError, match="Generator"):
        tev.generation_ppl(tp, TCFG, tokens, P, method)
    with pytest.raises(ValueError, match="unknown method"):
        tev.build_pruned("dense", tp, TCFG, None, 0.5)


def test_wanda_and_magnitude_match_jax(params, tokens):
    """Masks from the same prompt norms are bit-identical; the pruned
    weights equal the reference's."""
    jp, tp = params
    _, aux = jdec.forward(jp, CFG, jnp.asarray(tokens), collect_stats=True,
                          remat=False, logits_mode="last")
    stats = bridge.tree_from_jax(
        jax.tree.map(np.asarray, jdec.prune_stats_tree(aux.stats, CFG)), TCFG, "cpu")
    jffn = bridge.tree_from_jax(jax.tree.map(np.asarray, jdec.extract_ffn_tree(jp, CFG)),
                                TCFG, "cpu")
    for li, p in tdec.extract_ffn_tree(tp, TCFG).items():
        xn, zn = torch.sqrt(stats[li]["x_sq"]), torch.sqrt(stats[li]["z_sq"])
        for name, norm in (("w1", xn), ("wg", xn), ("w2", zn)):
            for sp in (0.5, 0.3):
                want = np.asarray(jwanda.wanda_mask(jnp.asarray(p[name].numpy()),
                                                    jnp.asarray(norm.numpy()), sp))
                assert np.array_equal(twanda.wanda_mask(p[name], norm, sp).numpy(), want)
        pj = {k: jnp.asarray(v.numpy()) for k, v in jffn[li].items()}
        want = jwanda.prune_ffn_wanda(pj, jnp.asarray(xn.numpy()),
                                      jnp.asarray(zn.numpy()), 0.5)
        got = twanda.prune_ffn_wanda(p, xn, zn, 0.5)
        for k in want:
            assert np.array_equal(got[k].numpy(), np.asarray(want[k])), (li, k)
        np.testing.assert_allclose(
            tsel.magnitude_statistic(p).numpy(),
            np.asarray(jsel.magnitude_statistic(pj)), rtol=1e-6)
    x = np.random.default_rng(4).normal(size=(2, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(twanda.activation_norms(torch.from_numpy(x)).numpy(),
                               np.asarray(jwanda.activation_norms(jnp.asarray(x))),
                               rtol=1e-6)


def test_flocking_matches_jax():
    rng = np.random.default_rng(5)
    z = rng.normal(size=(40, 96)).astype(np.float32)
    z[3] = 0.0  # an all-zero token row
    z[:, :8] *= 4.0  # shared heavy neurons: real flocking
    zj, zt = jnp.asarray(z), torch.from_numpy(z)
    tol = dict(rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tflock.relative_activations(zt).numpy(),
                               np.asarray(jflock.relative_activations(zj)), **tol)
    np.testing.assert_allclose(tflock.heatmap_data(zt, 16, 32),
                               jflock.heatmap_data(zj, 16, 32), **tol)
    for frac in (0.05, 0.2):
        np.testing.assert_allclose(tflock.flocking_score(zt, frac),
                                   jflock.flocking_score(zj, frac), **tol)
    seqs = [rng.normal(size=(12, 96)).astype(np.float32) for _ in range(4)]
    stats_j = [jflock.sequence_statistic(jnp.asarray(s)) for s in seqs]
    stats_t = [tflock.sequence_statistic(torch.from_numpy(s)) for s in seqs]
    for a, b in zip(stats_t, stats_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    for k in (10, 48):
        np.testing.assert_allclose(tflock.pairwise_jaccard(stats_t, k),
                                   jflock.pairwise_jaccard(stats_j, k), **tol)
    assert tflock.jaccard_topk(stats_t[0], stats_t[0], 10) == 1.0


def test_derive_profile_matches_jax_and_serves(params, tmp_path, capsys):
    jp, tp = params
    seqs = np.random.default_rng(6).integers(0, CFG.vocab_size, (2, 24)) \
        .astype(np.int32)
    want = jprofile.derive_profile(CFG, jp, jnp.asarray(seqs))
    got = tprofile.derive_profile(TCFG, tp, seqs)
    assert [p for p, _ in got.weights] == [p for p, _ in want.weights]
    for (_, wg), (_, ww) in zip(got.weights, want.weights):
        np.testing.assert_allclose(wg, ww, rtol=1e-6, atol=1e-6)
    assert got.note == want.note and got.arch == want.arch
    assert len({w for _, ws in got.weights for w in ws}) > 1  # not uniform
    path = tmp_path / "profile.json"
    got.save(path)
    assert jg.SparsityProfile.load(path).weights == got.weights
    gcfg = tg.GriffinConfig(sparsity=0.5)
    ks = tg.plan_k_tree(TCFG, gcfg, tier=0.5, profile=got)
    assert len(set(ks.values())) > 1  # the profile moves the budgets
    out = serve.main(["--arch", "tinylm", "--device", "cpu", "--requests", "2",
                      "--max-len", "64", "--ckpt-dir", str(tmp_path / "none"),
                      "--tier", "0.5", "--sparsity-profile", str(path)])
    assert sorted(out) == [0, 1] and all(len(t) > 0 for t in out.values())
    assert f"[profile] {path}" in capsys.readouterr().out


def test_sampling_selectors_match_jax_noise():
    rng = np.random.default_rng(7)
    for F, k in ((64, 16), (512, 256), (33, 7)):
        s = rng.random(F).astype(np.float32)
        s[:4] = 0.0  # zero weights: log-clamped, never sampled before others
        key = jax.random.PRNGKey(F)
        g = torch.from_numpy(np.array(jax.random.gumbel(key, (F,), jnp.float32)))
        st = torch.from_numpy(s)
        assert np.array_equal(tsel.gumbel_top_k(st, k, g).numpy(),
                              np.asarray(jsel.select_sampling(jnp.asarray(s), k, key)))
        assert np.array_equal(tsel.topk_gumbel_top_k(st, k, g).numpy(),
                              np.asarray(jsel.select_topk_sampling(jnp.asarray(s), k, key)))


def test_sampling_selectors_distribution():
    """k=1 draws neuron i with probability w_i / sum(w); top-k/2 + sampling
    at k=2 keeps the top neuron and draws the other from the rest by
    weight.  4,000 draws, each frequency within 4 standard errors."""
    w = torch.tensor([0.05, 0.1, 0.4, 0.15, 0.3, 0.0, 0.2, 0.6])
    gen = torch.Generator().manual_seed(0)
    n = 4000
    one = torch.stack([tsel.select_sampling(w, 1, gen) for _ in range(n)])[:, 0]
    two = torch.stack([tsel.select_topk_sampling(w, 2, gen) for _ in range(n)])
    assert (two == 7).any(dim=1).all()  # the top neuron, always
    other = torch.where(two[:, 0] == 7, two[:, 1], two[:, 0])
    for draws, weights in ((one, w), (other, torch.cat([w[:7], w.new_zeros(1)]))):
        p = (weights / weights.sum()).numpy()
        freq = np.bincount(draws.numpy(), minlength=len(w)) / n
        assert np.all(np.abs(freq - p) <= 4 * np.sqrt(p * (1 - p) / n) + 1e-12), freq
    with pytest.raises(ValueError, match="Generator"):
        tsel.select_sampling(w, 2, None)


@pytest.mark.parametrize("mode", ["topk", "sampling", "topk_sampling", "blocks"])
def test_every_griffin_mode_selects(mode):
    s_sq = torch.rand(2, 512, generator=torch.Generator().manual_seed(1))
    gcfg = tg.GriffinConfig(sparsity=0.5, mode=mode)
    idx = tg.select_experts(s_sq, gcfg, generator=torch.Generator().manual_seed(2))
    assert idx.shape == (256,) and torch.equal(idx, torch.sort(idx).values)
    assert len(torch.unique(idx)) == 256
