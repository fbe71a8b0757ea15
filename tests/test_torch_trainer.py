"""Port parity: LDA training on the sorted layout, two clients, BSP, on the
CPU, against the reference Trainer on the same corpus; and the bridge.

The two trainers draw different random numbers (torch generators against
JAX keys), so their runs agree only in distribution.  Held-out perplexity
after 5 rounds is averaged over 3 seeds on each side and the means must
agree within a band set from the measured seed-to-seed spread: three
standard errors of the difference of the two means (the spread of single
runs here is about ±2%; the band came out at 5.0% for cadence and 4.6%
for incremental rebuilds, with the port 1.7% and 2.2% above).  The count
statistics, unlike perplexity, are exact: consistency_error() must be 0.0
and the projection must find no violation after every round.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import hdp as ref_hdp
from repro.core import lda as ref_lda
from repro.core import projection as ref_proj
from repro.data import segment as ref_segment
from repro.data.synthetic import CorpusConfig, make_topic_corpus
from repro.engine import Trainer as RefTrainer
from repro.engine import TrainerConfig as RefTrainerConfig
from repro_torch import bridge
from repro_torch.core import lda, projection, ps
from repro_torch.kernels import _build
from repro_torch.engine import Trainer, TrainerConfig

SEEDS = (0, 1, 2)
ROUNDS = 5
INCREMENTAL = dict(alias_rebuild_threshold=0.0, alias_rebuild_rows=64,
                   alias_full_rebuild_every=16)


@pytest.fixture(scope="module")
def corpus():
    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=8, vocab_size=256, n_docs=96, doc_len=32, seed=5))
    return tokens, mask


def _ref_cfg():
    return ref_lda.LDAConfig(n_topics=16, vocab_size=256)


MODES = {"cadence": {}, "incremental": INCREMENTAL,
         "ssp2": dict(consistency="ssp:2"), "async": dict(consistency="async")}


@pytest.mark.parametrize("mode", list(MODES))
def test_trainer_matches_reference(mode, corpus):
    tokens, mask = corpus
    kw = MODES[mode]
    cfg = bridge.config_from(_ref_cfg())
    ours, theirs = [], []
    for seed in SEEDS:
        tr = Trainer(cfg, tokens, mask, config=TrainerConfig(
            layout="sorted", n_clients=2, **kw), seed=seed, device="cpu")
        for r in range(ROUNDS):
            tr.step()
            assert tr.consistency_error() == 0.0, (seed, r)
            assert tr.family.count_violations(tr.shared) == 0.0, (seed, r)
        ours.append(tr.perplexity(tokens[:32], mask[:32]))
        want_builds = {"incremental": 1, "ssp2": 2}.get(mode, ROUNDS)
        assert tr.alias_builds == want_builds

        ref = RefTrainer(_ref_cfg(), tokens, mask, config=RefTrainerConfig(
            layout="sorted", n_clients=2, **kw), key=jax.random.PRNGKey(seed))
        theirs.append(ref.run(ROUNDS, eval_every=10,
                              eval_docs=32).perplexities[-1])
    ours, theirs = np.array(ours), np.array(theirs)
    assert np.all(np.isfinite(ours))
    se = np.sqrt(ours.var(ddof=1) / len(SEEDS)
                 + theirs.var(ddof=1) / len(SEEDS))
    band = 3 * se / theirs.mean()
    rel = abs(ours.mean() - theirs.mean()) / theirs.mean()
    assert rel <= band, (ours, theirs, band)
    assert band < 0.15, "seed spread too wide for the comparison to mean much"


def test_trainer_perplexity_falls_and_launches_nothing_on_cpu(corpus):
    tokens, mask = corpus
    _build.reset_launches()
    tr = Trainer(bridge.config_from(_ref_cfg()), tokens, mask,
                 config=TrainerConfig(layout="sorted", n_clients=2),
                 device="cpu")
    res = tr.run(4, eval_every=3, eval_docs=24)
    assert res.perplexities[-1] < res.perplexities[0]
    assert res.violations == [0.0] * len(res.violations)
    assert sum(_build.LAUNCHES.values()) == 0


TCP = dict(transport="tcp", server_addrs=("localhost:1",))
# field: (TrainerConfig overrides, the reference config, raised, message)
REJECTED = {
    "layout": ({"layout": "bogus"}, _ref_cfg, ValueError, "unknown layout"),
    "method": ({"method": "exact"}, _ref_cfg, ValueError,
               "requires method='mhw'"),
    "server_addrs": ({"server_addrs": ("localhost:1",)}, _ref_cfg,
                     ValueError, "tcp-only"),
    "transport": ({"transport": "tcp"}, _ref_cfg, ValueError,
                  "requires server_addrs"),
    "local_clients": ({"local_clients": (0,)}, _ref_cfg, ValueError,
                      "tcp-only"),
    "family": (TCP, lambda: ref_hdp.HDPConfig(n_topics=16, vocab_size=256),
               NotImplementedError, "post_round"),
    "alias_rebuild_threshold": ({**TCP, "alias_rebuild_threshold": 0.0},
                                _ref_cfg, ValueError, "incremental"),
}


@pytest.mark.parametrize("field,value", [
    ("server_addrs", ("localhost:1",)), ("transport", "tcp"),
    ("local_clients", (0,)), ("layout", "bogus"),
    ("method", "exact"), ("family", "hdp"),
    ("alias_rebuild_threshold", 0.0)])
def test_trainer_rejects_unported_options(field, value, corpus):
    """What both packages reject, the port rejects with the reference's
    exception: an unknown layout, the sorted layout with the exact
    sampler, tcp-only knobs in process, tcp without servers, and over tcp
    HDP (its post_round needs every client's locals) and incremental
    rebuilds."""
    tokens, mask = corpus
    overrides, ref_cfg, exc, match = REJECTED[field]
    cfg = {"layout": "sorted", **overrides}
    with pytest.raises(exc, match=match):
        Trainer(bridge.config_from(ref_cfg()), tokens, mask,
                config=TrainerConfig(**cfg), device="cpu")
    with pytest.raises(exc):
        RefTrainer(ref_cfg(), tokens, mask, config=RefTrainerConfig(**cfg))


def test_fused_alias_build_names_its_roadmap_item():
    """LDAConfig(fused_alias_build=True), kernel 6 of ROADMAP.md's table
    B (``alias_build_fused``), bridges and builds through the fused build
    (its plain version here):
    against the reference's build_alias on the same statistics the stale
    matrix, the masses and every alias entry are equal, and prob is within
    4·K·2⁻²⁴ (``tests/test_torch_kernels.py`` says why it is not equal)."""
    rcfg = ref_lda.LDAConfig(n_topics=4, vocab_size=8, fused_alias_build=True)
    cfg = bridge.config_from(rcfg)
    assert cfg.fused_alias_build
    assert bridge.config_to(cfg, ref_lda.LDAConfig) == rcfg
    n_wk = np.random.default_rng(1).integers(0, 5, size=(8, 4)).astype(
        np.float32)
    want_t, want_stale = ref_lda.build_alias(rcfg, ref_lda.SharedStats(
        n_wk=jax.numpy.asarray(n_wk), n_k=jax.numpy.asarray(n_wk.sum(0))))
    got_t, got_stale = lda.build_alias(cfg, lda.SharedStats(
        n_wk=torch.as_tensor(n_wk), n_k=torch.as_tensor(n_wk.sum(0))))
    np.testing.assert_array_equal(got_stale.numpy(), np.asarray(want_stale))
    np.testing.assert_array_equal(got_t.mass.numpy(),
                                  np.asarray(want_t.mass))
    np.testing.assert_array_equal(got_t.alias.numpy(),
                                  np.asarray(want_t.alias))
    np.testing.assert_allclose(got_t.prob.numpy(), np.asarray(want_t.prob),
                               rtol=0, atol=4 * 4 * 2.0 ** -24)


def test_bridge_round_trip(corpus):
    """Reference state → port → numpy is the identity, field by field."""
    tokens, mask = corpus
    rcfg = _ref_cfg()
    cfg = bridge.config_from(rcfg)
    assert bridge.config_to(cfg, ref_lda.LDAConfig) == rcfg
    jt, jm = jax.numpy.asarray(tokens), jax.numpy.asarray(mask)
    local, shared = ref_lda.init_state(rcfg, jt, jm, jax.random.PRNGKey(3))
    tables, stale = ref_lda.build_alias(rcfg, shared)
    lay = ref_segment.build_layout(jt, jm, 256, tile_v=64, tile_b=128)

    def arrays(nt):
        return {f: np.asarray(getattr(nt, f)) for f in nt._fields}

    for conv, nt in ((bridge.shared_from, shared),
                     (bridge.local_from, local),
                     (bridge.layout_from, lay)):
        got = bridge.to_numpy(conv(arrays(nt), device="cpu"))
        for f, want in arrays(nt).items():
            np.testing.assert_array_equal(got[f], want, err_msg=f)
            assert got[f].dtype == want.dtype, f
    t, s = bridge.proposal_from(arrays(tables), stale, device="cpu")
    back_t, back_s = bridge.proposal_to(t, s)
    for f, want in arrays(tables).items():
        np.testing.assert_array_equal(back_t[f], want)
    np.testing.assert_array_equal(back_s, np.asarray(stale))
    assert isinstance(t.prob, torch.Tensor)


def test_server_shards_do_not_change_the_run(corpus):
    """Vocabulary sharding is concatenation only: 1 and 3 server shards
    give bit-identical statistics and assignments."""
    tokens, mask = corpus
    cfg = bridge.config_from(_ref_cfg())
    runs = []
    for shards in (1, 3):
        tr = Trainer(cfg, tokens, mask, config=TrainerConfig(
            layout="sorted", n_clients=2, n_server_shards=shards,
            **INCREMENTAL), seed=4, device="cpu")
        for _ in range(2):
            tr.step()
        runs.append((tr.shared, tr.locals_))
    (s1, l1), (s3, l3) = runs
    assert torch.equal(s1.n_wk, s3.n_wk) and torch.equal(s1.n_k, s3.n_k)
    for a, b in zip(l1, l3):
        assert torch.equal(a.z, b.z) and torch.equal(a.n_dk, b.n_dk)


def test_projection_matches_reference():
    """Algorithm 1 and the violation count equal the reference's on
    statistics with negative entries (exact: clamps and an f32 column sum
    of small integers)."""
    rng = np.random.default_rng(2)
    n_wk = rng.integers(-3, 6, size=(40, 8)).astype(np.float32)
    stats = {"n_wk": n_wk, "n_k": n_wk.sum(0)}
    want = ref_proj.project({k: jax.numpy.asarray(v)
                             for k, v in stats.items()},
                            ref_proj.LDA_RULES, ref_proj.LDA_AGGREGATES)
    got = projection.project({k: torch.as_tensor(v)
                              for k, v in stats.items()},
                             projection.LDA_RULES, projection.LDA_AGGREGATES)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert float(projection.count_violations(
        {"n_wk": torch.as_tensor(n_wk)}, projection.LDA_RULES)) == float(
        ref_proj.count_violations({"n_wk": jax.numpy.asarray(n_wk)},
                                  ref_proj.LDA_RULES))


@pytest.mark.parametrize("mode", ["bsp", "ssp:2", "async", "topk"])
def test_restore_continues_bit_exactly(mode, corpus, tmp_path):
    """A run restored from its round-2 snapshot replays rounds 2-3 bit for
    bit: statistics, every client's z and n_dk, clocks, SSP's cache and
    lag, the filter's residuals and the counters (the snapshot carries
    every round input, and the port's streams are keyed by the seed and
    the round)."""
    tokens, mask = corpus
    kw = (dict(filter=ps.FilterSpec("topk", k_rows=16, random_rows=8))
          if mode == "topk" else dict(consistency=mode))
    tcfg = TrainerConfig(layout="sorted", n_clients=2, snapshot_every=2,
                         snapshot_dir=str(tmp_path), **kw)
    cfg = bridge.config_from(_ref_cfg())
    full = Trainer(cfg, tokens, mask, config=tcfg, seed=3, device="cpu")
    for _ in range(4):
        full.step()
    res = Trainer.restore(cfg, tokens, mask, config=tcfg, step=2, seed=3,
                          device="cpu")
    assert res.round_idx == 2
    for _ in range(2):
        res.step()
    assert torch.equal(res.shared.n_wk, full.shared.n_wk)
    assert torch.equal(res.shared.n_k, full.shared.n_k)
    for a, b in zip(res.locals_, full.locals_):
        assert torch.equal(a.z, b.z) and torch.equal(a.n_dk, b.n_dk)
    np.testing.assert_array_equal(res.clocks, full.clocks)
    assert (res.alias_builds, res._host_version, res.pstate.cache_version) \
        == (full.alias_builds, full._host_version, full.pstate.cache_version)
    if mode == "ssp:2":
        assert torch.equal(res.pstate.client_lag["n_wk"],
                           full.pstate.client_lag["n_wk"])
        assert torch.equal(res.pstate.cache.n_wk, full.pstate.cache.n_wk)
    if mode == "topk":
        for a, b in zip(res.residuals, full.residuals):
            assert torch.equal(a["n_wk"], b["n_wk"])
        assert res.consistency_error() > 0.0     # mass waits in residuals
    else:
        assert res.consistency_error() == 0.0
