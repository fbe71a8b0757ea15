"""Port parity for PDP on the sorted layout: the Stirling table, the log
factors, the plain version of the PDP sweep kernel (kernel 4), the
compacted-rows alias build (kernel 5), the family sweep, projection, the
bridge and the Trainer, each against the JAX reference on the same
numpy-seeded inputs.  The reference's Pallas kernels run in interpret
mode, as its own tests run them.

Tolerances and why:
* The Stirling tables are computed by the same numpy code: equal.
* ``log_factors``: float32 log is evaluated by different libraries (XLA's
  CPU routine, which differs from the correctly rounded value on ~3% of
  inputs; PyTorch's vectorised one, on ~0.006%), so a factor, a sum of up
  to seven logs, may differ in the last places: the test allows 4 ulp;
  measured at most 2.  ``dense_probs`` = α·exp(log_f) inherits that
  absolute error as a relative one (up to 23 ulp of the result, measured),
  so it is held to 4 ulp of log_f, relative, plus exp's own rounding;
  infinite and zero entries (clamped Stirling lookups) must be equal.
* Chains and sweeps fed the same tables and uniforms: the cdf is summed
  left to right in float32, XLA's CPU order at E = 2K ≤ 16, and every other
  step is the same float32 operation in the same order, so the draws are
  required to be identical (measured: 0 of the chains differ).
* The alias builds of compacted rows: bit-equal (row masses summed left to
  right, as XLA does at E ≤ 16).
* Trainer: the two packages draw different random numbers, so held-out
  perplexity after 5 rounds is averaged over 3 seeds on each side and the
  means must agree within three standard errors of their difference, the
  band of ``tests/test_torch_trainer.py``.  The counts are exact:
  consistency_error() is 0.0 and no projection rule is violated after
  every round.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import family as ref_family
from repro.core import pdp as ref_pdp
from repro.core import projection as ref_proj
from repro.core import stirling as ref_stirling
from repro.data.synthetic import CorpusConfig, make_topic_corpus
from repro.engine import Trainer as RefTrainer
from repro.engine import TrainerConfig as RefTrainerConfig
from repro.kernels import alias_build as ref_kernels
from repro.kernels import mhw_fused as ref_fused
from repro_torch import bridge
from repro_torch.core import family, pdp, projection, stirling
from repro_torch.engine import Trainer, TrainerConfig
from repro_torch.kernels import _build, ops
from tests.conftest import make_synthetic_corpus

ULP_MAX = 4
SEEDS = (0, 1, 2)
ROUNDS = 5
INCREMENTAL = dict(alias_rebuild_threshold=0.0, alias_rebuild_rows=64,
                   alias_full_rebuild_every=16)


def _ulps(a, b) -> int:
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


def _stats(rng, v, k, scale=3.0):
    """Consistent (m, s) counts: s ≤ m, m > 0 ⇒ s ≥ 1."""
    m = np.floor(rng.gamma(1.0, size=(v, k)) * scale).astype(np.float32)
    s = np.minimum(np.ceil(m * rng.uniform(0.2, 0.8, size=(v, k))), m)
    s = np.where(m > 0, np.maximum(s, 1.0), 0.0).astype(np.float32)
    return m, s


def _ref_shared(m, s):
    mj, sj = jnp.asarray(m), jnp.asarray(s)
    return ref_pdp.SharedStats(m_wk=mj, s_wk=sj, m_k=mj.sum(0), s_k=sj.sum(0))


def _np_of(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("n_max,a", [(16, 0.1), (128, 0.5), (512, 0.1)])
def test_stirling_table_matches_reference(n_max, a):
    want = ref_stirling.log_stirling_table(n_max, a)
    got = stirling.log_stirling_table(n_max, a)
    assert np.array_equal(got, want)
    np.testing.assert_array_equal(
        stirling.as_tensor(n_max, a, "cpu").numpy(),
        np.asarray(ref_stirling.as_jax(n_max, a)))
    assert stirling.as_tensor(n_max, a, "cpu") is stirling.as_tensor(
        n_max, a, "cpu"), "the cast table is cached per device"


def test_stirling_ratios_keep_the_asymmetric_clamps():
    """Counts above the table: m is clamped to hi+1 in the same-table ratio
    and to hi in the new-table ratio, as in the reference."""
    n_max = 16
    table = stirling.as_tensor(n_max, 0.1, "cpu")
    jt = ref_stirling.as_jax(n_max, 0.1)
    n = np.array([[0, 3, 15, 16, 40, 40, 7]], np.float32)
    m = np.array([[0, 2, 15, 16, 17, 40, 9]], np.float32)
    for fn, ref_fn in ((stirling.log_ratio_same, ref_stirling.log_ratio_same),
                       (stirling.log_ratio_incr,
                        ref_stirling.log_ratio_incr)):
        np.testing.assert_array_equal(
            fn(table, _t(n), _t(m)).numpy(),
            np.asarray(ref_fn(jt, jnp.asarray(n), jnp.asarray(m))))


@pytest.mark.parametrize("scale,n_max", [(3.0, 128), (60.0, 16)])
def test_log_factors_and_dense_probs_near_reference(scale, n_max):
    rng = np.random.default_rng(int(scale))
    v, k = 48, 8
    m, s = _stats(rng, v, k, scale)
    rcfg = ref_pdp.PDPConfig(n_topics=k, vocab_size=v, stirling_n_max=n_max,
                             concentration=5.0)
    cfg = bridge.config_from(rcfg)
    rshared = _ref_shared(m, s)
    shared = bridge.shared_from(_np_of(rshared), device="cpu",
                                kind=pdp.SharedStats)
    want_f = np.concatenate([np.asarray(x) for x in ref_pdp._log_factors(
        rcfg, ref_stirling.as_jax(n_max, rcfg.discount), rshared.m_wk,
        rshared.s_wk, rshared.m_k[None, :], rshared.s_k[None, :])], -1)
    got_f = torch.cat(pdp._log_factors(
        cfg, stirling.as_tensor(n_max, cfg.discount, "cpu"), shared.m_wk,
        shared.s_wk, shared.m_k[None, :], shared.s_k[None, :]), -1).numpy()
    assert _ulps(got_f, want_f) <= ULP_MAX, f"measured {_ulps(got_f, want_f)}"

    # exp(x + δ) = exp(x)·(1 + δ): the dense term inherits the log factor's
    # absolute error as a relative one, plus exp's own rounding.
    want = np.asarray(ref_pdp.dense_probs(rcfg, rshared))
    got = pdp.dense_probs(cfg, shared).numpy()
    fin = np.isfinite(want) & (want > 0)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    rel = np.abs(got[fin] - want[fin]) / want[fin]
    bound = (ULP_MAX * np.spacing(np.abs(want_f[fin]))
             + 2 * np.finfo(np.float32).eps)
    assert (rel <= bound).all(), f"relative error up to {rel.max():.3g}"
    rows = torch.tensor([5, 0, 47, 12], dtype=torch.int32)
    assert torch.equal(family.get("pdp").dense_probs_rows(cfg, shared, rows),
                       pdp.dense_probs(cfg, shared)[rows.long()])


@pytest.mark.parametrize("v,k,b,lo,hi,n_pad,steps,scale", [
    (64, 8, 384, 0, 64, 0, 2, 3.0),
    (128, 8, 256, 32, 48, 0, 3, 3.0),
    (64, 8, 256, 0, 9, 47, 2, 3.0),          # skew + padding
    (32, 8, 256, 0, 32, 8, 2, 400.0),        # counts above stirling_n_max
])
def test_plain_chain_matches_pallas_kernel(v, k, b, lo, hi, n_pad, steps,
                                           scale):
    rng = np.random.default_rng(v * k + b)
    rcfg = ref_pdp.PDPConfig(n_topics=k, vocab_size=v, mh_steps=steps,
                             stirling_n_max=128, concentration=5.0)
    m, s = _stats(rng, v, k, scale)
    if scale > 100:
        assert m.max() > rcfg.stirling_n_max
    rshared = _ref_shared(m, s)
    tabs, stale = ref_pdp.build_alias(rcfg, rshared)
    stirl = ref_stirling.as_jax(rcfg.stirling_n_max, rcfg.discount)
    prior = np.full(2 * k, rcfg.alpha, np.float32)
    rows = np.sort(rng.integers(lo, hi, size=b - n_pad)).astype(np.int32)
    rows = np.concatenate([rows, np.full(n_pad, v, np.int32)])
    e0 = rng.integers(0, 2 * k, size=b).astype(np.int32)
    ndk = np.floor(rng.gamma(0.5, size=(b, k)) * 2).astype(np.float32)
    ndk[np.arange(b), e0 % k] += 1.0
    slot = rng.integers(0, 2 * k, size=(steps, b)).astype(np.int32)
    uni = [rng.random((steps, b)).astype(np.float32) for _ in range(4)]
    tile_v, tile_b = 16, 64
    rs = rows.reshape(-1, tile_b)
    has = rs[:, 0] < v
    last = np.max(np.where(rs < v, rs, -1), axis=1)
    vstart = np.where(has, rs[:, 0] // tile_v, 0).astype(np.int32)
    vcount = np.where(has, last // tile_v - vstart + 1, 0).astype(np.int32)
    hyper = dict(gamma=rcfg.gamma, gamma_bar=rcfg.gamma * v)

    want = np.asarray(ref_fused.pdp_sweep_fused(
        tabs.prob, tabs.alias, tabs.mass, stale, rshared.m_wk, rshared.s_wk,
        rshared.m_k, rshared.s_k, stirl, jnp.asarray(prior),
        jnp.asarray(rows), jnp.asarray(e0), jnp.asarray(ndk),
        jnp.asarray(slot), *map(jnp.asarray, uni), jnp.asarray(vstart),
        jnp.asarray(vcount), tile_v=tile_v, tile_b=tile_b, n_steps=steps,
        b_conc=rcfg.concentration, a_disc=rcfg.discount, **hyper))
    got = pdp.sorted_chain_pdp(
        _t(tabs.prob), _t(tabs.alias), _t(tabs.mass), _t(stale), _t(m),
        _t(s), _t(rshared.m_k), _t(rshared.s_k), _t(stirl), _t(prior),
        _t(rows), torch.arange(b, dtype=torch.int32), _t(e0), _t(ndk),
        _t(slot), *map(_t, uni), b=rcfg.concentration, a=rcfg.discount,
        **hyper).numpy()
    differ = int((got != want).sum())
    assert differ == 0, f"{differ} of {b} chains differ"
    if n_pad:
        np.testing.assert_array_equal(got[-n_pad:], e0[-n_pad:])
    assert ((got >= 0) & (got < 2 * k)).all()


def _sweep_setup(chunks):
    tokens, mask, _ = make_synthetic_corpus(n_topics=6, vocab=96, n_docs=40,
                                            doc_len=24, seed=3)
    tokens, mask = np.array(tokens), np.array(mask)
    mask[::3, -5:] = False                       # masked tail positions
    rcfg = ref_pdp.PDPConfig(n_topics=8, vocab_size=96, mh_steps=2,
                             stirling_n_max=128, concentration=5.0,
                             sorted_chunks=chunks, tile_b=64)
    return tokens, mask, rcfg


@pytest.mark.parametrize("chunks", [1, 4])
def test_sweep_sorted_matches_reference_with_injected_uniforms(chunks):
    """PDPFamily.sweep_sorted from the reference's state and tables, fed
    the same per-chunk uniforms (slot over [0, 2K)), gives the same z, r,
    n_dk, Δm and Δs as the reference family sweep."""
    tokens, mask, rcfg = _sweep_setup(chunks)
    cfg = bridge.config_from(rcfg)
    jt, jm = jnp.asarray(tokens), jnp.asarray(mask)
    rlocal, rshared = ref_pdp.init_state(rcfg, jt, jm, jax.random.PRNGKey(0))
    rtables, rstale = ref_pdp.build_alias(rcfg, rshared)
    rng = np.random.default_rng(11)
    streams = {}

    def uniforms(c, lay, tile_b):
        if c not in streams:
            bp = int(lay.rows.shape[0])
            streams[c] = (
                rng.integers(0, 2 * cfg.n_topics, size=(2, bp)
                             ).astype(np.int32),
                *(rng.random((2, bp)).astype(np.float32) for _ in range(4)))
        return streams[c]

    rfam = ref_family.get("pdp")
    rlays = rfam.build_sorted_layouts(rcfg, jt, jm)
    rl2, rd = rfam.sweep_sorted(
        rcfg, rlocal, rshared, rtables, rstale, jt, jm,
        jax.random.PRNGKey(1), rlays,
        chunk_uniforms=lambda c, lay, tb: tuple(
            jnp.asarray(a) for a in uniforms(c, lay, tb)))

    fam = family.get("pdp")
    local = bridge.local_from(_np_of(rlocal), device="cpu", kind=fam)
    shared = bridge.shared_from(_np_of(rshared), device="cpu", kind=fam)
    tables, stale = bridge.proposal_from(_np_of(rtables), rstale,
                                          device="cpu")
    tt, tm = torch.as_tensor(tokens), torch.as_tensor(mask)
    lays = fam.build_sorted_layouts(cfg, tt, tm)
    for rl, gl in zip(rlays, lays):
        assert torch.equal(gl.rows, _t(rl.rows))
        assert torch.equal(gl.vstart, _t(rl.vstart))
    l2, d = fam.sweep_sorted(
        cfg, local, shared, tables, stale, tt, tm, (0, 1), lays,
        chunk_uniforms=lambda c, lay, tb: tuple(
            torch.as_tensor(a) for a in uniforms(c, lay, tb)),
        device="cpu")
    for f in ("z", "r", "n_dk"):
        np.testing.assert_array_equal(getattr(l2, f).numpy(),
                                      np.asarray(getattr(rl2, f)), err_msg=f)
    for n in ("m_wk", "s_wk"):
        np.testing.assert_array_equal(d[n].numpy(), np.asarray(rd[n]),
                                      err_msg=n)
    moved = fam.encode(cfg, l2) != fam.encode(cfg, local)
    assert float(moved.float().mean()) > 0.1, "chain moved"


@pytest.mark.parametrize("r,k,seed", [(13, 8, 0), (40, 4, 1), (1, 8, 2)])
def test_build_tables_rows_matches_pallas(r, k, seed):
    """ops.build_tables_rows on the CPU equals alias_build_rows on a
    compacted (R, 2K) block whose R is no multiple of the row tile."""
    rng = np.random.default_rng(seed)
    p = (rng.gamma(0.3, size=(r, 2 * k))
         * (rng.random((r, 2 * k)) < 0.7)).astype(np.float32)
    if r > 2:
        p[1] = 0.0                                 # uniform fallback row
    wp, wa, wm = ref_kernels.alias_build_rows(jnp.asarray(p), tile_r=8)
    got = ops.build_tables_rows(torch.as_tensor(p), device="cpu")
    np.testing.assert_array_equal(got.mass.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(got.alias.numpy(), np.asarray(wa))
    np.testing.assert_array_equal(got.prob.numpy(), np.asarray(wp))


def test_partial_rebuild_all_rows_equals_full_build():
    """PDP's generic rebuild (gathered dense rows → compacted-rows build →
    scatter) over every row equals a full build bit for bit; with a
    validity mask, invalid rows keep their resident entries."""
    tokens, mask, rcfg = _sweep_setup(2)
    cfg = bridge.config_from(rcfg)
    fam = family.get("pdp")
    tt, tm = torch.as_tensor(tokens), torch.as_tensor(mask)
    loc, sh = fam.init_state(cfg, tt, tm, (0,))
    tables, stale = fam.build_alias(cfg, sh)
    _, d = fam.sweep(cfg, loc, sh, tables, stale, tt, tm, (1,),
                     layout="sorted", device="cpu")
    sh = fam.apply_delta(sh, d)
    t_full, s_full = fam.build_alias(cfg, sh)
    rows = torch.arange(cfg.vocab_size, dtype=torch.int32)
    t_inc, s_inc = fam.rebuild_alias_rows(
        cfg, sh, tables, stale, rows, torch.ones_like(rows, dtype=torch.bool),
        device="cpu")
    for a, b in zip(t_full, t_inc):
        assert torch.equal(a, b)
    assert torch.equal(s_full, s_inc)
    sub = torch.tensor([3, 9, 11, 40], dtype=torch.int32)
    valid = torch.tensor([True, False, True, False])
    t_sub, s_sub = fam.rebuild_alias_rows(cfg, sh, tables, stale, sub, valid,
                                          device="cpu")
    assert torch.equal(t_sub.prob[3], t_full.prob[3])
    assert torch.equal(t_sub.alias[11], t_full.alias[11])
    assert torch.equal(t_sub.prob[9], tables.prob[9])
    assert torch.equal(s_sub[11], s_full[11])
    assert torch.equal(s_sub[40], stale[40])


def test_projection_matches_reference():
    """Algorithm 1 under PDP_RULES and the violation count equal the
    reference's on statistics that break every rule."""
    rng = np.random.default_rng(4)
    m = rng.integers(-2, 5, size=(30, 6)).astype(np.float32)
    s = rng.integers(-1, 7, size=(30, 6)).astype(np.float32)
    stats = {"m_wk": m, "s_wk": s, "m_k": m.sum(0), "s_k": s.sum(0)}
    want = ref_proj.project({n: jnp.asarray(x) for n, x in stats.items()},
                            ref_proj.PDP_RULES, ref_proj.PDP_AGGREGATES)
    got = projection.project({n: torch.as_tensor(x)
                              for n, x in stats.items()},
                             projection.PDP_RULES, projection.PDP_AGGREGATES)
    for n in want:
        np.testing.assert_array_equal(got[n].numpy(), np.asarray(want[n]))
    want_v = float(ref_proj.count_violations(
        {n: jnp.asarray(x) for n, x in stats.items()}, ref_proj.PDP_RULES))
    assert want_v > 0
    assert float(projection.count_violations(
        {n: torch.as_tensor(x) for n, x in stats.items()},
        projection.PDP_RULES)) == want_v
    fam = family.get("pdp")
    shared = fam.shared_from_dict({n: torch.as_tensor(x)
                                   for n, x in stats.items()})
    assert fam.count_violations(shared) == want_v
    assert fam.count_violations(fam.project(shared)) == 0.0


def test_bridge_round_trip():
    """Reference PDP config and state → port → numpy is the identity."""
    tokens, mask, rcfg = _sweep_setup(4)
    cfg = bridge.config_from(rcfg)
    assert isinstance(cfg, pdp.PDPConfig)
    assert bridge.config_to(cfg, ref_pdp.PDPConfig) == rcfg
    jt, jm = jnp.asarray(tokens), jnp.asarray(mask)
    local, shared = ref_pdp.init_state(rcfg, jt, jm, jax.random.PRNGKey(3))
    fam = family.get("pdp")
    for conv, nt, kind in ((bridge.shared_from, shared, fam),
                           (bridge.local_from, local, fam),
                           (bridge.shared_from, shared, pdp.SharedStats)):
        got = bridge.to_numpy(conv(_np_of(nt), device="cpu", kind=kind))
        for f, want in _np_of(nt).items():
            np.testing.assert_array_equal(got[f], want, err_msg=f)
            assert got[f].dtype == want.dtype, f
    with pytest.raises(TypeError, match="no port config"):
        bridge.config_from(object())


@pytest.fixture(scope="module")
def corpus():
    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=8, vocab_size=128, n_docs=96, doc_len=32, seed=5))
    return tokens, mask


@pytest.mark.parametrize("mode", ["cadence", "incremental"])
def test_trainer_matches_reference(mode, corpus):
    tokens, mask = corpus
    kw = INCREMENTAL if mode == "incremental" else {}
    rcfg = ref_pdp.PDPConfig(n_topics=8, vocab_size=128)
    cfg = bridge.config_from(rcfg)
    ours, theirs = [], []
    _build.reset_launches()
    for seed in SEEDS:
        tr = Trainer(cfg, tokens, mask, config=TrainerConfig(
            layout="sorted", n_clients=2, **kw), seed=seed, device="cpu")
        for r in range(ROUNDS):
            tr.step()
            assert tr.consistency_error() == 0.0, (seed, r)
            assert tr.family.count_violations(tr.shared) == 0.0, (seed, r)
        ours.append(tr.perplexity(tokens[:32], mask[:32]))
        assert tr.alias_builds == (ROUNDS if mode == "cadence" else 1)
        ref = RefTrainer(rcfg, tokens, mask, config=RefTrainerConfig(
            layout="sorted", n_clients=2, **kw), key=jax.random.PRNGKey(seed))
        theirs.append(ref.run(ROUNDS, eval_every=10,
                              eval_docs=32).perplexities[-1])
    assert sum(_build.LAUNCHES.values()) == 0
    ours, theirs = np.array(ours), np.array(theirs)
    assert np.all(np.isfinite(ours))
    se = np.sqrt(ours.var(ddof=1) / len(SEEDS)
                 + theirs.var(ddof=1) / len(SEEDS))
    band = 3 * se / theirs.mean()
    rel = abs(ours.mean() - theirs.mean()) / theirs.mean()
    assert rel <= band, (ours, theirs, band)
    assert band < 0.15, "seed spread too wide for the comparison to mean much"
