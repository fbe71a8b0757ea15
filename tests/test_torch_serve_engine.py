"""Port parity for serving: ``repro_torch.serve`` (snapshot, fold-in
engine, oracle, perplexity) against ``repro.serve`` on the same
numpy-seeded inputs, for LDA, PDP and HDP, on the CPU.  The reference's
Pallas kernels run in interpret mode, as its own tests run them, at its
own test sizes (K=4, V=64, max_len 32, 3 sweeps, 4 slots).

Every test of ``tests/test_serve_engine.py`` is mirrored on the port with
its own streams.  Against the reference:

* ``freeze`` of the reference's statistics: for LDA and HDP, tables and
  stale bit-equal (the same float32 operations in the same order; rows
  summed left to right, XLA's CPU order at these widths).  PDP's dense
  term is α·exp(log factors), and XLA's and PyTorch's float32 log differ
  in the last places (ROADMAP queue C records it), so its stale is held to
  ``tests/test_torch_pdp.py``'s bound (4 ulp of the log factor, relative,
  plus exp's rounding) and its tables to the reference's build of that
  same stale, bit for bit.
* The engine and the oracle fed the reference's own streams (its
  ``init_state`` under ``PRNGKey(seed)``, its ``_step_uniforms`` under
  ``fold_in(fold_in(PRNGKey(seed), sweep), chunk)``) through the
  ``streams`` seam, on the reference's snapshot: assignments, theta and
  checksum bit-equal to the reference's ``FoldInEngine.run`` and
  ``reference_fold_in``.
* ``fold_in_perplexity`` of the same thetas: within 1e-6 relative (φ is
  formed by each package's own reductions).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import alias as ref_alias
from repro.core import family as ref_fam_mod
from repro.core import pdp as ref_pdp
from repro.core import stirling as ref_stirling
from repro.data.synthetic import CorpusConfig, make_topic_corpus
from repro.kernels import ops as ref_ops
from repro.serve import FoldInEngine as RefEngine
from repro.serve import InferRequest as RefRequest
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import fold_in_perplexity as ref_fold_in_perplexity
from repro.serve import freeze as ref_freeze
from repro.serve import reference_fold_in as ref_reference_fold_in
from repro_torch import bridge
from repro_torch.core import family as fam_mod
from repro_torch.core.alias import AliasTable
from repro_torch.serve import (FoldInEngine, InferenceSnapshot, InferRequest,
                               ServeConfig, Streams, fold_in_perplexity,
                               freeze, from_servers, reference_fold_in,
                               result_checksum)
from repro_torch.serve.engine import InferResult

MAX_LEN = 32
FAMILIES = ("lda", "pdp", "hdp")
CPU = "cpu"


def _np_of(nt):
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


class JaxStreams(Streams):
    """The reference engine's per-request streams, handed to the port."""

    def __init__(self, ref_fam, ref_cfg):
        self.ref_fam, self.ref_cfg = ref_fam, ref_cfg

    def init_state(self, fam, cfg, tokens, mask, seed):
        local, _ = self.ref_fam.init_state(
            self.ref_cfg, jnp.asarray(tokens.numpy()),
            jnp.asarray(mask.numpy()), jax.random.PRNGKey(seed))
        return bridge.local_from(_np_of(local), device=CPU, kind=fam)

    def uniforms(self, seed, sweep, chunk, n_outcomes, mh_steps, width,
                 device):
        key = jax.random.fold_in(
            jax.random.fold_in(jax.random.PRNGKey(seed), sweep), chunk)
        return tuple(torch.tensor(np.asarray(u)) for u in
                     ref_ops._step_uniforms(key, n_outcomes, mh_steps,
                                            width))


@pytest.fixture(scope="module", params=FAMILIES)
def both(request):
    """The reference test's snapshot (a few in-process sweeps over a tiny
    corpus, then freeze) and the port's, frozen from the same statistics;
    plus the port's copy of the reference's snapshot itself."""
    ref_fam = ref_fam_mod.get(request.param)
    rcfg = ref_fam.config_cls(n_topics=4, vocab_size=64)
    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=4, vocab_size=64, n_docs=24, doc_len=16, seed=1))
    local, shared = ref_fam.init_state(rcfg, tokens, mask,
                                       jax.random.PRNGKey(0))
    for i in range(3):
        tables, stale = ref_fam.build_alias(rcfg, shared)
        local, deltas = ref_fam.sweep(
            rcfg, local, shared, tables, stale, tokens, mask,
            jax.random.fold_in(jax.random.PRNGKey(9), i), method="mhw")
        shared = ref_fam.project(ref_fam.apply_delta(shared, deltas))
    ref_snap = ref_freeze(rcfg, shared)

    fam = fam_mod.get(request.param)
    cfg = bridge.config_from(rcfg)
    port_shared = bridge.shared_from(_np_of(ref_snap.shared), device=CPU,
                                     kind=fam)
    snap = freeze(cfg, port_shared, device=CPU)
    tables, stale = bridge.proposal_from(_np_of(ref_snap.tables),
                                         ref_snap.stale, device=CPU)
    mirror = InferenceSnapshot(family_name=fam.name, cfg=cfg,
                               shared=port_shared, tables=tables,
                               stale=stale)
    return dict(ref=ref_snap, rcfg=rcfg, ref_fam=ref_fam, snap=snap,
                mirror=mirror, streams=JaxStreams(ref_fam, rcfg))


@pytest.fixture
def snapshot(both):
    return both["snap"]


def make_reqs(snap, n, seed=0, min_len=3, max_len=MAX_LEN):
    rng = np.random.default_rng(seed)
    return [InferRequest(
        uid=i,
        tokens=rng.integers(0, snap.vocab_size,
                            size=int(rng.integers(min_len, max_len + 1))
                            ).astype(np.int32),
        seed=100 + i) for i in range(n)]


def scfg(**kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("n_sweeps", 3)
    return ServeConfig(**kw)


def engine(snap, cfg=None, **kw):
    return FoldInEngine(snap, cfg or scfg(), device=CPU, **kw)


# ---------------------------------------------------------------------------
# The reference's tests, on the port
# ---------------------------------------------------------------------------

def test_engine_completes_all_requests(snapshot):
    eng = engine(snapshot)
    reqs = make_reqs(snapshot, 7)
    results = eng.run(reqs)
    assert sorted(results) == list(range(7))
    k = snapshot.n_topics
    for req in reqs:
        res = results[req.uid]
        assert res.n_sweeps == 3
        assert res.theta.shape == (k,)
        assert np.isclose(res.theta.sum(), 1.0, atol=1e-4)
        assert res.assignments.shape == (len(req.tokens),)
        assert ((res.assignments >= 0)
                & (res.assignments
                   < snapshot.family.n_outcomes(snapshot.cfg))).all()
    assert eng.docs_admitted == eng.docs_harvested == 7
    assert eng.free_slots() == 4


def test_admit_step_harvest_cycle(snapshot):
    eng = engine(snapshot, scfg(max_slots=2, n_sweeps=2))
    reqs = make_reqs(snapshot, 3)
    assert eng.admit(reqs[0])
    assert eng.admit(reqs[1])
    assert not eng.admit(reqs[2])          # grid full → False, not an error
    assert eng.free_slots() == 0
    assert eng.harvest() == []             # nothing mixed yet
    eng.step()
    assert eng.harvest() == []             # age 1 < n_sweeps 2
    eng.step()
    done = eng.harvest()
    assert sorted(r.uid for r in done) == [0, 1]
    assert eng.free_slots() == 2           # slots recycled
    assert eng.admit(reqs[2])


def test_admit_validation(snapshot):
    eng = engine(snapshot)
    with pytest.raises(ValueError, match="empty"):
        eng.admit(InferRequest(uid=0, tokens=np.zeros(0, np.int32)))
    with pytest.raises(ValueError, match="max_len"):
        eng.admit(InferRequest(
            uid=1, tokens=np.zeros(MAX_LEN + 1, np.int32)))
    with pytest.raises(ValueError, match="vocab"):
        eng.admit(InferRequest(
            uid=2, tokens=np.asarray([snapshot.vocab_size], np.int32)))
    assert eng.free_slots() == 4


def test_fold_in_bit_identical_to_trainer_path(snapshot):
    """The port's own streams: the batched engine equals the family's
    ``sweep`` on a one-document shard, assignments and theta."""
    reqs = make_reqs(snapshot, 5, seed=11)
    results = engine(snapshot).run(reqs)
    for req in reqs:
        _, theta, z = reference_fold_in(
            snapshot, req.tokens, req.seed, n_sweeps=3, max_len=MAX_LEN,
            device=CPU)
        res = results[req.uid]
        np.testing.assert_array_equal(res.assignments, z)
        np.testing.assert_array_equal(res.theta, theta)
        ref = InferResult(uid=req.uid, theta=theta, assignments=z,
                          n_sweeps=3)
        assert result_checksum(ref) == result_checksum(res)


def test_batch_composition_independence(snapshot):
    reqs = make_reqs(snapshot, 4, seed=23)
    solo = engine(snapshot).run([reqs[0]])
    pooled = engine(snapshot).run(reqs)
    reordered = engine(snapshot, scfg(max_slots=2)).run(
        list(reversed(reqs)))
    for res_set in (pooled, reordered):
        np.testing.assert_array_equal(solo[0].assignments,
                                      res_set[0].assignments)
        np.testing.assert_array_equal(solo[0].theta, res_set[0].theta)
    for uid in range(4):
        assert (result_checksum(pooled[uid])
                == result_checksum(reordered[uid]))


def test_seed_changes_chain(snapshot):
    toks = make_reqs(snapshot, 1, seed=5, min_len=MAX_LEN)[0].tokens
    a = engine(snapshot).run([InferRequest(uid=0, tokens=toks, seed=1)])[0]
    b = engine(snapshot).run([InferRequest(uid=0, tokens=toks, seed=2)])[0]
    assert not np.array_equal(a.assignments, b.assignments)


def test_fold_in_perplexity_finite(snapshot):
    n, length = 4, 12
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, snapshot.vocab_size, (n, length)
                          ).astype(np.int32)
    mask = np.ones((n, length), bool)
    results = engine(snapshot).run([InferRequest(uid=i, tokens=tokens[i],
                                                 seed=i) for i in range(n)])
    thetas = np.stack([results[i].theta for i in range(n)])
    ppl = fold_in_perplexity(snapshot, thetas, tokens, mask)
    assert np.isfinite(ppl) and 1.0 < ppl < snapshot.vocab_size ** 2


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

def test_freeze_matches_reference(both):
    """Port ``freeze`` of the reference's statistics: the proposal is the
    reference's bit for bit."""
    snap, ref = both["snap"], both["ref"]
    tables = ref.tables
    if snap.family_name == "pdp":
        rcfg, rs = both["rcfg"], ref.shared
        log_f = np.concatenate([np.asarray(x) for x in ref_pdp._log_factors(
            rcfg, ref_stirling.as_jax(rcfg.stirling_n_max, rcfg.discount),
            rs.m_wk, rs.s_wk, rs.m_k[None, :], rs.s_k[None, :])], -1)
        got, want = snap.stale.numpy(), np.asarray(ref.stale)
        fin = np.isfinite(want) & (want > 0)
        np.testing.assert_array_equal(got[~fin], want[~fin])
        rel = np.abs(got[fin] - want[fin]) / want[fin]
        assert (rel <= 4 * np.spacing(np.abs(log_f[fin]))
                + 2 * np.finfo(np.float32).eps).all()
        tables = ref_alias.build(jnp.asarray(got))
    else:
        np.testing.assert_array_equal(snap.stale.numpy(),
                                      np.asarray(ref.stale))
    for name, want in _np_of(tables).items():
        np.testing.assert_array_equal(getattr(snap.tables, name).numpy(),
                                      np.asarray(want), err_msg=name)
    np.testing.assert_array_equal(snap.topic_prior().numpy(),
                                  np.asarray(ref.topic_prior()))


def _ref_requests(reqs):
    return [RefRequest(uid=r.uid, tokens=r.tokens, seed=r.seed)
            for r in reqs]


def test_engine_with_reference_streams_matches_reference(both):
    """Acceptance: fed the reference's streams, the port's engine gives
    the reference engine's assignments, theta and checksum, whatever the
    batch composition and admission order."""
    mirror = both["mirror"]
    reqs = make_reqs(mirror, 6, seed=31)
    want = RefEngine(both["ref"], RefServeConfig(
        max_slots=4, max_len=MAX_LEN, n_sweeps=3)).run(_ref_requests(reqs))
    pooled = engine(mirror, streams=both["streams"]).run(reqs)
    reordered = engine(mirror, scfg(max_slots=3),
                       streams=both["streams"]).run(list(reversed(reqs)))
    for got in (pooled, reordered):
        for req in reqs:
            g, w = got[req.uid], want[req.uid]
            np.testing.assert_array_equal(g.assignments, w.assignments)
            np.testing.assert_array_equal(g.theta, w.theta)
            assert g.theta.dtype == w.theta.dtype
            assert result_checksum(g) == result_checksum(w)


def test_reference_fold_in_matches_reference(both):
    """The port's oracle fed the reference's streams equals the
    reference's oracle."""
    mirror = both["mirror"]
    for req in make_reqs(mirror, 2, seed=41):
        _, theta, z = reference_fold_in(
            mirror, req.tokens, req.seed, n_sweeps=3, max_len=MAX_LEN,
            streams=both["streams"], device=CPU)
        _, want_theta, want_z = ref_reference_fold_in(
            both["ref"], req.tokens, req.seed, n_sweeps=3, max_len=MAX_LEN)
        np.testing.assert_array_equal(z, want_z)
        np.testing.assert_array_equal(theta, want_theta)


def test_fold_in_perplexity_matches_reference(both):
    snap = both["snap"]
    n, length = 5, 16
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, snap.vocab_size, (n, length)).astype(np.int32)
    mask = rng.random((n, length)) < 0.8
    thetas = rng.dirichlet(np.ones(snap.n_topics), n).astype(np.float32)
    got = fold_in_perplexity(snap, thetas, tokens, mask)
    want = ref_fold_in_perplexity(both["ref"], thetas, tokens, mask)
    assert abs(got - want) <= 1e-6 * want


def test_serving_leaves_the_snapshot_unchanged(snapshot):
    before = [t.clone() for t in (*snapshot.shared, *snapshot.tables,
                                  snapshot.stale)]
    engine(snapshot).run(make_reqs(snapshot, 5, seed=7))
    after = (*snapshot.shared, *snapshot.tables, snapshot.stale)
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_engine_rejects_a_snapshot_on_another_device(snapshot):
    import dataclasses
    elsewhere = dataclasses.replace(snapshot,
                                    stale=snapshot.stale.to("meta"))
    with pytest.raises(ValueError, match="lies on"):
        FoldInEngine(elsewhere, scfg(), device=CPU)


def test_from_servers_waits_for_the_wire_client(snapshot):
    """``from_servers`` goes through the port's wire client: the
    snapshot's statistics, INIT-pushed to a live port shard server, freeze
    back to the same statistics, tables and stale matrix.  HDP is not
    servable over the wire (its post_round needs every client's locals):
    the shard server refuses it, as the reference's does."""
    from repro_torch.net.client import RemoteParameterServer
    from repro_torch.net.server import ShardServer, serve_shards
    fam = snapshot.family
    if fam.name == "hdp":
        with pytest.raises(NotImplementedError, match="post_round"):
            ShardServer("hdp", vocab_size=snapshot.vocab_size, n_clients=1,
                        device=CPU)
        return
    servers = serve_shards(fam.name, vocab_size=snapshot.vocab_size,
                           n_clients=1, n_shards=2, device=CPU)
    addrs = tuple("%s:%d" % s.address for s in servers)
    try:
        with RemoteParameterServer(addrs, family=fam, n_clients=1,
                                   vocab_size=snapshot.vocab_size,
                                   device=CPU) as rps:
            rps.init_push(0, snapshot.shared)
        got = from_servers(addrs, snapshot.cfg, n_clients=1, device=CPU)
    finally:
        for s in servers:
            s.close()
    for a, b in zip((*got.shared, *got.tables, got.stale),
                    (*snapshot.shared, *snapshot.tables, snapshot.stale)):
        assert torch.equal(a, b)


def test_fused_lda_freeze_uses_the_fused_build():
    """``LDAConfig(fused_alias_build=True)``: freeze builds the proposal
    with the fused build (its plain version on the CPU), whose stale
    matrix is α·(n_wk+β)/(n_k+β̄), product first."""
    from repro_torch.core import lda
    from repro_torch.kernels import ref
    cfg = lda.LDAConfig(n_topics=4, vocab_size=64, fused_alias_build=True)
    rng = np.random.default_rng(4)
    n_wk = torch.as_tensor(rng.integers(0, 5, (64, 4)), dtype=torch.float32)
    snap = freeze(cfg, lda.SharedStats(n_wk=n_wk, n_k=n_wk.sum(0)),
                  device=CPU)
    want = ref.alias_build_fused_ref(n_wk, n_k=n_wk.sum(0), alpha=0.1,
                                     beta=0.01, vocab_size=64)
    assert all(torch.equal(a, b) for a, b in zip(snap.tables, want))
    assert isinstance(snap.tables, AliasTable)
    res = engine(snap).run(make_reqs(snap, 3))
    assert sorted(res) == [0, 1, 2]
