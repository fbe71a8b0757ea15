"""Port parity for HDP on the sorted layout: the initial state, the dense
term, the CRT table step, the θ0 draw, the family sweep, the client-local
projection, the auxiliary streams and the Trainer, each against the JAX
reference on the same numpy-seeded inputs.  The reference's Pallas
kernels run in interpret mode, as its own tests run them.

Tolerances and why:
* Counts (n_dk, n_wk, m_dk, m_k) are integer-valued float32 sums: equal.
* θ0 at init and the dense term b1·θ0·LM are the same float32 operations
  in the same order: equal.
* The CRT step fed the reference's own (D, K, crt_max) uniforms compares
  the same entries with the same float32 p = c/(c + j): equal, also for a
  θ0 with a zero entry (0/0 there, which never accepts) and for counts
  above crt_max.
* θ0 from the reference's gamma draws: g/Σg with the K gammas summed left
  to right in float32, the reference's order on the CPU (torch.sum takes
  another order, which moves θ0 by a few ulp on some draws): equal.
* The sweep fed the same tables and uniforms: z, n_dk and Δn_wk equal (as
  for LDA, the cdf is summed left to right, XLA's CPU order at K ≤ 16).
* Trainer: the two packages draw different random numbers, so held-out
  perplexity after 5 rounds is averaged over 3 seeds on each side and the
  means must agree within three standard errors of their difference, the
  band of ``tests/test_torch_trainer.py``.  The counts are exact:
  consistency_error() is 0.0 and no shared or local rule is violated
  after every round.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import family as ref_family
from repro.core import hdp as ref_hdp
from repro.core import projection as ref_proj
from repro.data.synthetic import CorpusConfig, make_topic_corpus
from repro.engine import Trainer as RefTrainer
from repro.engine import TrainerConfig as RefTrainerConfig
from repro_torch import bridge
from repro_torch import device as device_mod
from repro_torch.core import family, hdp, lda, projection
from repro_torch.engine import Trainer, TrainerConfig
from repro_torch.kernels import _build, ref
from tests.conftest import make_synthetic_corpus

SEEDS = (0, 1, 2)
ROUNDS = 5
INCREMENTAL = dict(alias_rebuild_threshold=0.0, alias_rebuild_rows=64,
                   alias_full_rebuild_every=16)


def _np_of(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def _t(x):
    return torch.tensor(np.asarray(x))


def _setup(chunks=4, crt_max=128):
    tokens, mask, _ = make_synthetic_corpus(n_topics=6, vocab=96, n_docs=40,
                                            doc_len=24, seed=3)
    tokens, mask = np.array(tokens), np.array(mask)
    mask[::3, -5:] = False                       # masked tail positions
    rcfg = ref_hdp.HDPConfig(n_topics=8, vocab_size=96, b1=2.0, mh_steps=2,
                             crt_max=crt_max, sorted_chunks=chunks,
                             tile_b=64)
    return tokens, mask, rcfg


def _ref_state(tokens, mask, rcfg, seed=0):
    return ref_hdp.init_state(rcfg, jnp.asarray(tokens), jnp.asarray(mask),
                              jax.random.PRNGKey(seed))


def test_init_state_matches_reference_given_its_z():
    tokens, mask, rcfg = _setup()
    cfg = bridge.config_from(rcfg)
    assert isinstance(cfg, hdp.HDPConfig)
    assert bridge.config_to(cfg, ref_hdp.HDPConfig) == rcfg
    rlocal, rshared = _ref_state(tokens, mask, rcfg)
    local, shared = hdp.state_from_z(cfg, torch.as_tensor(tokens),
                                     torch.as_tensor(mask), _t(rlocal.z))
    for got, want in ((local, rlocal), (shared, rshared)):
        for f, w in _np_of(want).items():
            np.testing.assert_array_equal(getattr(got, f).numpy(), w,
                                          err_msg=f)
    assert float(shared.theta0.max()) > float(shared.theta0.min())
    fam = family.get("hdp")
    l2, s2 = fam.init_state(cfg, torch.as_tensor(tokens),
                            torch.as_tensor(mask), (0,))
    assert fam.count_local_violations(l2) == 0.0
    assert torch.equal(s2.m_k, l2.m_dk.sum(0))


def test_dense_probs_and_rows_match_reference():
    """b1·θ0·LM with a Dirichlet θ0 equals the reference's; the gathered
    rows (kernel 3's plain version with prior b1·θ0) equal its rows."""
    tokens, mask, rcfg = _setup()
    cfg = bridge.config_from(rcfg)
    _, rshared = _ref_state(tokens, mask, rcfg)
    theta0 = np.random.default_rng(2).dirichlet(np.full(8, 0.3)).astype(
        np.float32)
    rshared = rshared._replace(theta0=jnp.asarray(theta0))
    shared = bridge.shared_from(_np_of(rshared), device="cpu",
                                kind=family.get("hdp"))
    want = np.asarray(ref_hdp.dense_probs(rcfg, rshared))
    got = hdp.dense_probs(cfg, shared)
    np.testing.assert_array_equal(got.numpy(), want)
    fam = family.get("hdp")
    rows = torch.tensor([5, 0, 95, 12], dtype=torch.int32)
    prior = fam.sparse_prior(cfg, shared)
    np.testing.assert_array_equal(
        prior.numpy(), np.asarray(ref_family.get("hdp").sparse_prior(
            rcfg, rshared)))
    *_, dense = ref.alias_build_gather_fused_ref(
        shared.n_wk, shared.n_k, prior, rows, beta=cfg.beta,
        beta_bar=cfg.beta * cfg.vocab_size)
    assert torch.equal(dense, got[rows.long()])
    assert torch.equal(fam.dense_probs_rows(cfg, shared, rows),
                       got[rows.long()])


@pytest.mark.parametrize("crt_max,zero_topic", [(128, None), (128, 3),
                                                (4, 5)])
def test_resample_tables_matches_reference(crt_max, zero_topic):
    """The sparse CRT step, fed the reference's (D, K, crt_max) uniforms,
    gives its m_dk and m_k bit for bit: with a θ0 entry of 0 (p = 0/0 at
    j = 0) and with counts above crt_max (crt_max = 4)."""
    tokens, mask, rcfg = _setup(crt_max=crt_max)
    cfg = bridge.config_from(rcfg)
    rlocal, rshared = _ref_state(tokens, mask, rcfg)
    theta0 = np.random.default_rng(7).dirichlet(np.full(8, 0.5)).astype(
        np.float32)
    if zero_topic is not None:
        theta0[zero_topic] = 0.0
        assert float(rlocal.n_dk[:, zero_topic].sum()) > 0
    rshared = rshared._replace(theta0=jnp.asarray(theta0))
    if crt_max < 128:
        assert float(rlocal.n_dk.max()) > crt_max
    key = jax.random.PRNGKey(4)
    want_local, want_m_k = ref_hdp.resample_tables(rcfg, rlocal, rshared,
                                                   key)
    u = jax.random.uniform(key, (tokens.shape[0], 8, crt_max))
    fam = family.get("hdp")
    local = bridge.local_from(_np_of(rlocal), device="cpu", kind=fam)
    shared = bridge.shared_from(_np_of(rshared), device="cpu", kind=fam)
    got_local, got_m_k = hdp.resample_tables(cfg, local, shared,
                                             uniforms=_t(u))
    np.testing.assert_array_equal(got_local.m_dk.numpy(),
                                  np.asarray(want_local.m_dk))
    np.testing.assert_array_equal(got_m_k.numpy(), np.asarray(want_m_k))
    assert fam.count_local_violations(got_local) == 0.0
    assert float((got_local.m_dk != local.m_dk).float().mean()) > 0.05
    # The generator path gives a valid state of the same shape.
    l3, m3 = hdp.resample_tables(cfg, local, shared,
                                 torch.Generator().manual_seed(0))
    assert fam.count_local_violations(l3) == 0.0
    assert torch.equal(m3, l3.m_dk.sum(0))


@pytest.mark.parametrize("seed", [8, 11, 12])
def test_resample_theta0_matches_reference_given_its_gammas(seed):
    rcfg = ref_hdp.HDPConfig(n_topics=16, vocab_size=32, b0=1.5)
    cfg = bridge.config_from(rcfg)
    m_k = np.random.default_rng(seed).integers(0, 40, size=16).astype(
        np.float32)
    m_k[[2, 9]] = 0.0
    key = jax.random.PRNGKey(seed)
    want = ref_hdp.resample_theta0(rcfg, jnp.asarray(m_k), key)
    g = jax.random.gamma(key, jnp.asarray(m_k) + rcfg.b0 / rcfg.n_topics)
    got = hdp.resample_theta0(cfg, _t(m_k), gammas=_t(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    drawn = hdp.resample_theta0(cfg, _t(m_k),
                                torch.Generator().manual_seed(1))
    assert drawn.shape == (16,) and bool((drawn >= 0).all())
    assert abs(float(drawn.sum()) - 1.0) < 1e-5


@pytest.mark.parametrize("chunks", [1, 4])
def test_sweep_sorted_matches_reference_with_injected_uniforms(chunks):
    """HDPFamily.sweep_sorted from the reference's state and tables (prior
    b1·θ0), fed the same per-chunk uniforms, gives the reference's z,
    n_dk and Δn_wk, and keeps m_dk."""
    tokens, mask, rcfg = _setup(chunks)
    cfg = bridge.config_from(rcfg)
    jt, jm = jnp.asarray(tokens), jnp.asarray(mask)
    rlocal, rshared = _ref_state(tokens, mask, rcfg)
    rtables, rstale = ref_hdp.build_alias(rcfg, rshared)
    rng = np.random.default_rng(11)
    streams = {}

    def uniforms(c, lay, tile_b):
        if c not in streams:
            bp = int(lay.rows.shape[0])
            streams[c] = (
                rng.integers(0, cfg.n_topics, size=(2, bp)).astype(np.int32),
                *(rng.random((2, bp)).astype(np.float32) for _ in range(4)))
        return streams[c]

    rfam = ref_family.get("hdp")
    rlays = rfam.build_sorted_layouts(rcfg, jt, jm)
    rl2, rd = rfam.sweep_sorted(
        rcfg, rlocal, rshared, rtables, rstale, jt, jm,
        jax.random.PRNGKey(1), rlays,
        chunk_uniforms=lambda c, lay, tb: tuple(
            jnp.asarray(a) for a in uniforms(c, lay, tb)))

    fam = family.get("hdp")
    local = bridge.local_from(_np_of(rlocal), device="cpu", kind=fam)
    shared = bridge.shared_from(_np_of(rshared), device="cpu", kind=fam)
    tables, stale = bridge.proposal_from(_np_of(rtables), rstale,
                                          device="cpu")
    tables2, stale2 = fam.build_alias(cfg, shared)
    for a, b in zip(tables, tables2):
        assert torch.equal(a, b)
    assert torch.equal(stale, stale2)
    tt, tm = torch.as_tensor(tokens), torch.as_tensor(mask)
    l2, d = fam.sweep_sorted(
        cfg, local, shared, tables, stale, tt, tm, (0, 1),
        fam.build_sorted_layouts(cfg, tt, tm),
        chunk_uniforms=lambda c, lay, tb: tuple(
            torch.as_tensor(a) for a in uniforms(c, lay, tb)),
        device="cpu")
    for f in ("z", "n_dk", "m_dk"):
        np.testing.assert_array_equal(getattr(l2, f).numpy(),
                                      np.asarray(getattr(rl2, f)), err_msg=f)
    np.testing.assert_array_equal(d["n_wk"].numpy(), np.asarray(rd["n_wk"]))
    assert float((l2.z != local.z).float().mean()) > 0.1, "chain moved"
    got = hdp.apply_delta(cfg, shared, d["n_wk"], d["n_wk"].sum(0))
    want = ref_hdp.apply_delta(rcfg, rshared, rd["n_wk"], rd["n_wk"].sum(0))
    for f, w in _np_of(want).items():
        np.testing.assert_array_equal(getattr(got, f).numpy(), w, err_msg=f)


def test_local_projection_matches_reference():
    """HDP's client-local rules (nonneg m_dk, pos_link and le against
    n_dk) and their violation count equal the reference's on a state that
    breaks each of them."""
    rng = np.random.default_rng(5)
    n_dk = rng.integers(0, 4, size=(12, 6)).astype(np.float32)
    m_dk = rng.integers(-2, 6, size=(12, 6)).astype(np.float32)
    z = np.zeros((12, 3), np.int32)
    rfam, fam = ref_family.get("hdp"), family.get("hdp")
    rlocal = ref_hdp.LocalState(z=jnp.asarray(z), n_dk=jnp.asarray(n_dk),
                                m_dk=jnp.asarray(m_dk))
    local = bridge.local_from(_np_of(rlocal), device="cpu", kind=fam)
    want_v = float(rfam.count_local_violations(rlocal))
    assert want_v > 0
    assert fam.count_local_violations(local) == want_v
    assert [r.kind for r in fam.local_rules] == [
        r.kind for r in rfam.local_rules] == ["nonneg", "pos_link", "le"]
    want = rfam.local_project(rlocal)
    got = fam.local_project(local)
    for f in ("z", "n_dk", "m_dk"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert fam.count_local_violations(got) == 0.0
    assert family.get("lda").count_local_violations(local) == 0.0
    stats = {"n_wk": np.array([[-1.0, 2.0]], np.float32)}
    assert float(projection.count_violations(
        {n: torch.as_tensor(x) for n, x in stats.items()},
        projection.HDP_RULES[:1])) == float(ref_proj.count_violations(
            {n: jnp.asarray(x) for n, x in stats.items()},
            ref_proj.HDP_RULES[:1])) == 1.0


def test_post_round_draws_from_its_sub_streams(monkeypatch):
    """post_round draws client c's tables from fold_in(key, c) and θ0 from
    fold_in(key, 101), and the trainer keys it (seed, AUX, round)."""
    tokens, mask, rcfg = _setup()
    cfg = bridge.config_from(rcfg)
    fam = family.get("hdp")
    tt, tm = torch.as_tensor(tokens), torch.as_tensor(mask)
    locs, shared = [], None
    for c, (t, m) in enumerate(((tt[:20], tm[:20]), (tt[20:], tm[20:]))):
        loc, sh = fam.init_state(cfg, t, m, (0, c))
        locs.append(loc)
        shared = sh if shared is None else shared
    key = (0, device_mod.AUX, 3)
    got_locals, got = fam.post_round(cfg, locs, shared, key)
    m_k = 0
    for c, loc in enumerate(locs):
        want_loc, mk = hdp.resample_tables(
            cfg, loc, shared, device_mod.generator(key + (c,), "cpu"))
        assert torch.equal(got_locals[c].m_dk, want_loc.m_dk)
        m_k = m_k + mk
    assert torch.equal(got.m_k, m_k)
    assert torch.equal(got.theta0, hdp.resample_theta0(
        cfg, m_k, device_mod.generator(key + (101,), "cpu")))
    assert torch.equal(got.n_wk, shared.n_wk)

    keys = []
    real = family.HDPFamily.post_round

    def spy(self, cfg, locals_, shared, key):
        keys.append(key)
        return real(self, cfg, locals_, shared, key)

    monkeypatch.setattr(family.HDPFamily, "post_round", spy)
    tr = Trainer(cfg, tokens, mask, config=TrainerConfig(
        layout="sorted", n_clients=2), seed=7, device="cpu")
    tr.step()
    tr.step()
    assert keys == [(7, device_mod.AUX, 0), (7, device_mod.AUX, 1)]


def test_fold_in_perplexity_prior_vector_matches_scalar():
    """The per-topic prior of HDP's evaluator, set to α·1, gives LDA's
    scalar-prior perplexity (the same draws; θ's normaliser Σprior against
    α·K may round apart)."""
    tokens, mask, _ = _setup()
    cfg = lda.LDAConfig(n_topics=8, vocab_size=96)
    tt, tm = torch.as_tensor(tokens), torch.as_tensor(mask)
    _, shared = lda.init_state(cfg, tt, tm, (0,))
    phi = lda.language_model(cfg, shared)
    a = lda.fold_in_perplexity(cfg, phi, tt[:8], tm[:8], (1,), 3)
    b = lda.fold_in_perplexity(cfg, phi, tt[:8], tm[:8], (1,), 3,
                               prior=torch.full((8,), cfg.alpha))
    assert a == pytest.approx(b, rel=1e-6)
    assert a == lda.perplexity(cfg, shared, tt[:8], tm[:8], (1,), 3)


@pytest.fixture(scope="module")
def corpus():
    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=8, vocab_size=128, n_docs=96, doc_len=32, seed=5))
    return tokens, mask


@pytest.mark.parametrize("mode", ["cadence", "incremental"])
def test_trainer_matches_reference(mode, corpus):
    tokens, mask = corpus
    kw = INCREMENTAL if mode == "incremental" else {}
    rcfg = ref_hdp.HDPConfig(n_topics=16, vocab_size=128)
    cfg = bridge.config_from(rcfg)
    ours, theirs = [], []
    _build.reset_launches()
    for seed in SEEDS:
        tr = Trainer(cfg, tokens, mask, config=TrainerConfig(
            layout="sorted", n_clients=2, **kw), seed=seed, device="cpu")
        theta_start = tr.shared.theta0.clone()
        for r in range(ROUNDS):
            tr.step()
            assert tr.consistency_error() == 0.0, (seed, r)
            assert tr.family.count_violations(tr.shared) == 0.0, (seed, r)
            assert sum(tr.family.count_local_violations(loc)
                       for loc in tr.locals_) == 0.0, (seed, r)
            assert torch.equal(tr.shared.m_k, sum(
                loc.m_dk.sum(0) for loc in tr.locals_)), (seed, r)
        assert not torch.equal(tr.shared.theta0, theta_start)
        ours.append(tr.perplexity(tokens[:32], mask[:32]))
        assert tr.alias_builds == (ROUNDS if mode == "cadence" else 1)
        ref_tr = RefTrainer(rcfg, tokens, mask, config=RefTrainerConfig(
            layout="sorted", n_clients=2, **kw),
            key=jax.random.PRNGKey(seed))
        theirs.append(ref_tr.run(ROUNDS, eval_every=10,
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
