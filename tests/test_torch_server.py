"""The parameter server's policies on the port: mirrors
``tests/test_server.py``.

Against ``repro.core.server``, given equal statistics and equal deltas:
the policy parsing, the shard map, the SSP cache (a copy, never a view of
the shards), ``pull_round``, ``reset_lag``, ``client_view``,
``rejoin_client``, ``push`` and ``push_sparse`` give bit-equal results for
LDA, PDP and HDP (the statistics are float32 integers; every operation is
a concatenation, a copy or an exact add).  Through the Trainer on the CPU:
SSP's refresh schedule and its coupling to the alias rebuilds, SSP(0)
against BSP, async's in-round pushes, clocks under a crash, and exact
count conservation under every policy.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import family as ref_family
from repro.core import ps as ref_ps
from repro.core import server as ref_server
from repro_torch import bridge
from repro_torch.core import family, ps
from repro_torch.core import server as server_mod
from repro_torch.core.fault import FaultEvent, FaultPlan
from repro_torch.core.server import (Async, BSP, SSP, ShardSpec,
                                     make_consistency)
from repro_torch.engine import Trainer, TrainerConfig
from tests.conftest import make_synthetic_corpus

VOCAB = 64
FAMILIES = ("lda", "pdp", "hdp")


@pytest.fixture(scope="module")
def corpus():
    tokens, mask, _ = make_synthetic_corpus(n_topics=4, vocab=VOCAB,
                                            n_docs=16, doc_len=12, seed=3)
    return np.asarray(tokens), np.asarray(mask)


def _cfg(name, k=4):
    return family.get(name).config_cls(n_topics=k, vocab_size=VOCAB)


def _trainer(corpus, name="lda", **kw):
    tokens, mask = corpus
    kw.setdefault("n_clients", 2)
    return Trainer(_cfg(name), tokens, mask,
                   config=TrainerConfig(layout="sorted", **kw), device="cpu")


# ---------------------------------------------------------------------------
# Shard map and parsing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_rows,n_shards", [(10, 3), (64, 1), (7, 7)])
def test_shard_spec_equals_reference(n_rows, n_shards):
    ours, theirs = ShardSpec(n_rows, n_shards), ref_server.ShardSpec(
        n_rows, n_shards)
    assert ours.bounds == theirs.bounds
    np.testing.assert_array_equal(ours.row_to_shard(), theirs.row_to_shard())
    assert ours.row_to_shard().dtype == np.int32
    assert [ours.shard_of(r) for r in range(n_rows)] == \
        [theirs.shard_of(r) for r in range(n_rows)]
    x = torch.arange(n_rows * 2, dtype=torch.float32).reshape(n_rows, 2)
    assert torch.equal(torch.cat(ours.split(x)), x)
    with pytest.raises(IndexError):
        ours.shard_of(n_rows)
    with pytest.raises(ValueError):
        ShardSpec(n_rows=4, n_shards=5)


@pytest.mark.parametrize("text", ["bsp", "async", "ssp", "ssp:3", "ssp(2)",
                                  " SSP:0 ", "ssp:12"])
def test_make_consistency_equals_reference(text):
    ours, theirs = make_consistency(text), ref_server.make_consistency(text)
    assert (ours.key, ours.kind, ours.caches, ours.immediate, ours.bound) \
        == (theirs.key, theirs.kind, theirs.caches, theirs.immediate,
            theirs.bound)
    for r in range(6):
        for v in (None, 0, 2, 5):
            assert ours.needs_refresh(r, v) == theirs.needs_refresh(r, v)


def test_make_consistency_rejects():
    assert isinstance(make_consistency("bsp"), BSP)
    assert isinstance(make_consistency("async"), Async)
    pol = SSP(bound=4)
    assert make_consistency(pol) is pol
    with pytest.raises(ValueError, match="consistency"):
        make_consistency("eventually-maybe")
    with pytest.raises(ValueError, match="bound"):
        SSP(bound=-1)
    with pytest.raises(ValueError, match="bound"):
        make_consistency("ssp:-1")


def test_trainer_rejects_bad_consistency(corpus):
    with pytest.raises(ValueError, match="consistency"):
        _trainer(corpus, consistency="gossip")
    with pytest.raises(ValueError, match="n_shards"):
        _trainer(corpus, n_server_shards=10**6)


# ---------------------------------------------------------------------------
# Server operations against the reference, given equal deltas
# ---------------------------------------------------------------------------

def _shared_pair(name, corpus):
    """Equal shared statistics in both packages (the port's initial state
    of the corpus)."""
    tokens, mask = corpus
    fam = family.get(name)
    _, shared = fam.init_state(_cfg(name), torch.as_tensor(tokens),
                               torch.as_tensor(mask), (0,))
    arrays = bridge.to_numpy(shared)
    rfam = ref_family.get(name)
    return fam, shared, rfam, rfam.shared_cls(
        **{n: jnp.asarray(v) for n, v in arrays.items()})


def _deltas(fam, seed, n_clients):
    rng = np.random.default_rng(seed)
    return [{n: (rng.integers(-2, 3, size=(VOCAB, fam_k))
                 * (rng.random((VOCAB, fam_k)) < 0.2)).astype(np.float32)
             for n, fam_k in fam} for _ in range(n_clients)]


def _eq_tree(ours, theirs, what):
    if theirs is None:
        assert ours is None, what
        return
    for n, v in (theirs._asdict() if hasattr(theirs, "_asdict")
                 else theirs).items():
        got = getattr(ours, n) if hasattr(ours, "_asdict") else ours[n]
        np.testing.assert_array_equal(got.numpy(), np.asarray(v),
                                      err_msg=f"{what}: {n}")


@pytest.mark.parametrize("name", FAMILIES)
@pytest.mark.parametrize("consistency,n_shards", [("ssp:1", 1), ("ssp:2", 3),
                                                  ("async", 2), ("bsp", 3)])
def test_server_rounds_equal_reference(name, consistency, n_shards, corpus):
    """Five rounds of the server's side of a round, on both packages: the
    pull, each client's read-my-writes view, the lag's reset and growth, a
    client's rejoin, pushes (sparse from the second round on) with clocks
    and row mass, and the cache and its version."""
    fam, shared, rfam, rshared = _shared_pair(name, corpus)
    srv = server_mod.make_server(fam, VOCAB, n_shards=n_shards,
                                 consistency=consistency)
    rsrv = ref_server.make_server(rfam, VOCAB, n_shards=n_shards,
                                  consistency=consistency)
    n_clients = 2
    state = srv.init_state(shared, n_clients)
    rstate = rsrv.init_state(rshared, n_clients)
    widths = [(n, int(fam.stats_dict(shared)[n].shape[1]))
              for n in fam.delta_names]
    version = None
    for r in range(5):
        do_refresh = srv.policy.needs_refresh(r, version)
        if do_refresh:
            version = r
        if r == 3:
            state = srv.rejoin_client(state, 1)
            rstate = rsrv.rejoin_client(rstate, 1)
        snap, cache, ver = srv.pull_round(state, r, do_refresh)
        rsnap, rcache, rver = rsrv.pull_round(rstate, r, do_refresh)
        _eq_tree(snap, rsnap, f"r{r} snapshot")
        _eq_tree(cache, rcache, f"r{r} cache")
        assert ver == int(rver)
        lag = srv.reset_lag(state.client_lag, do_refresh)
        rlag = rsrv.reset_lag(rstate.client_lag, do_refresh)
        _eq_tree(lag, rlag, f"r{r} lag")
        deltas = _deltas(widths, 100 * r, n_clients)
        for c in range(n_clients):
            _eq_tree(srv.client_view(snap, lag, c),
                     rsrv.client_view(rsnap, rlag, c), f"r{r} view {c}")
            if lag is not None:
                lag = {n: v.clone() for n, v in lag.items()}
                for n in lag:
                    lag[n][c] += torch.as_tensor(deltas[c][n])
                rlag = {n: v.at[c].add(deltas[c][n])
                        for n, v in rlag.items()}
        total = {n: sum(d[n] for d in deltas) for n, _ in widths}
        pushed = np.array([True, r != 2])
        if r == 0:
            state = srv.push(state, {n: torch.as_tensor(v)
                                     for n, v in total.items()},
                             torch.as_tensor(pushed), track_mass=True)
        else:
            state = srv.push_sparse(state, ps.to_sparse_delta(
                {n: torch.as_tensor(v) for n, v in total.items()}),
                torch.as_tensor(pushed), track_mass=True)
        rstate = rsrv.push_sparse(rstate, ref_ps.to_sparse_delta(total),
                                  jnp.asarray(pushed), track_mass=True)
        state = state._replace(cache=cache, cache_version=ver,
                               client_lag=lag)
        rstate = rstate._replace(cache=rcache, cache_version=rver,
                                 client_lag=rlag)
        _eq_tree(srv.snapshot(state), rsrv.snapshot(rstate), f"r{r} pushed")
        np.testing.assert_array_equal(state.clocks.numpy(),
                                      np.asarray(rstate.clocks))
        for a, b in zip(srv.shard_row_mass(state),
                        rsrv.shard_row_mass(rstate)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _eq_tree(srv.pull(state), rsrv.pull(rstate), f"r{r} pull")
        keys = [(fam.delta_names[0], s) for s in range(n_shards)]
        for a, b in zip(srv.pull(state, keys), rsrv.pull(rstate, keys)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_ssp_cache_is_a_copy(corpus):
    """SSP's cache is a copy: writing to the shards leaves it as it was,
    and the lag is (n_clients, V, K) zeros per delta statistic."""
    fam, shared, _, _ = _shared_pair("pdp", corpus)
    srv = server_mod.make_server(fam, VOCAB, consistency="ssp:2")
    state = srv.init_state(shared, n_clients=3)
    before = {n: v.clone() for n, v in fam.stats_dict(state.cache).items()}
    for n, v in state.shards[0].items():
        v.add_(1.0)
    for n, v in state.aux.items():
        v.add_(1.0)
    for n, v in fam.stats_dict(state.cache).items():
        assert torch.equal(v, before[n]), n
    assert set(state.client_lag) == set(fam.delta_names)
    for n, v in state.client_lag.items():
        assert v.shape == (3,) + tuple(before[n].shape)
        assert not bool(v.any())
    refreshed, _, _ = srv.pull_round(state, 1, True)
    for n, v in fam.stats_dict(refreshed).items():
        assert v.data_ptr() != fam.stats_dict(srv.snapshot(state))[n] \
            .data_ptr(), n


# ---------------------------------------------------------------------------
# Policies through the Trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("consistency", ["ssp:2", "async"])
@pytest.mark.parametrize("name", FAMILIES)
def test_policies_conserve_counts(name, consistency, corpus):
    t = _trainer(corpus, name, consistency=consistency)
    for _ in range(4):
        t.step()
        assert t.consistency_error() == 0.0
        assert t.family.count_violations(t.shared) == 0.0
    assert np.all(t.clocks == 4)


def test_ssp_refresh_schedule_and_alias_coupling(corpus):
    t = _trainer(corpus, consistency="ssp:2")
    builds = []
    for _ in range(7):
        t.step()
        builds.append(t.alias_builds)
    assert builds == [1, 1, 1, 2, 2, 2, 3]
    assert t.pstate.cache_version == 6
    assert not torch.equal(t.pstate.cache.n_wk, t.shared.n_wk)
    assert t.consistency_error() == 0.0


def test_ssp_matches_bsp_when_bound_zero(corpus):
    out = {}
    for consistency in ("bsp", "ssp:0"):
        t = _trainer(corpus, tau=2, consistency=consistency)
        for _ in range(3):
            t.step()
        out[consistency] = t.shared.n_wk
    assert torch.equal(out["bsp"], out["ssp:0"])


def test_async_clients_see_in_round_pushes(corpus):
    out = {}
    for consistency in ("bsp", "async"):
        t = _trainer(corpus, consistency=consistency)
        t.step()
        assert t.consistency_error() == 0.0
        out[consistency] = t.shared.n_wk
    assert not torch.equal(out["bsp"], out["async"])


def test_policy_failure_injection_freezes_clock(corpus):
    t = _trainer(corpus, n_clients=3, consistency="ssp:1",
                 fault_plan=FaultPlan.crash(1, 0, 2))
    for _ in range(4):
        t.step()
    np.testing.assert_array_equal(t.clocks, [4, 2, 4])
    assert t.consistency_error() == 0.0


@pytest.mark.parametrize("consistency", ["ssp:2", "async"])
def test_incremental_rebuilds_under_policies(consistency, corpus):
    """Incremental alias rebuilds ride every policy: one full build, the
    drifted rows after each round, counts conserved."""
    t = _trainer(corpus, consistency=consistency, alias_rebuild_threshold=0.0)
    for _ in range(4):
        t.step()
        assert t.consistency_error() == 0.0
    assert t.alias_builds == 1
    assert not any(bool(m.any()) for m in t.pstate.row_mass)


@pytest.mark.parametrize("consistency", ["bsp", "ssp:1", "async"])
def test_push_sum_leaves_client_deltas_untouched(consistency, corpus,
                                                 monkeypatch):
    """The round sums the clients' sent deltas into a fresh total: under
    the dense filter a sent delta is the client's own accumulated delta
    (the one its read-my-writes lag row adds), and no later add may write
    into it.  A lost push of client 0 stays out of the sum."""
    from repro_torch.engine import round as round_mod
    sent_log = []
    real = round_mod.filter_push

    def logged(*args, **kw):
        sent, res = real(*args, **kw)
        sent_log.append({n: (v, v.clone()) for n, v in sent.items()})
        return sent, res

    monkeypatch.setattr(round_mod, "filter_push", logged)
    t = _trainer(corpus, n_clients=3, consistency=consistency,
                 fault_plan=FaultPlan.scripted(
                     FaultEvent("lost_push", client=0, start=1, stop=2)))
    before = t.shared.n_wk.clone()
    t.step()
    t.step()
    assert len(sent_log) == 6
    for entry in sent_log:
        for n, (v, copy) in entry.items():
            assert torch.equal(v, copy), n
    # round 1: clients 1 and 2 land, client 0's push is lost
    assert t.consistency_error() > 0.0
    np.testing.assert_array_equal(t.clocks, [1, 2, 2])
    pushed = sum(e["n_wk"][1] for e in sent_log)
    assert torch.equal(t.shared.n_wk, before + pushed
                       - sent_log[3]["n_wk"][1])
