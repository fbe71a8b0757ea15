"""Fault plans, kill-and-rejoin and restore on the port: mirrors
``tests/test_fault.py``.

``repro_torch.core.fault`` is the port's own copy of the numpy-only
reference module: ``FaultPlan.random`` must give the reference's event
tuples for equal arguments, and ``resolve`` its flags for every round.
The Trainer's fault paths run on the CPU on a small LDA corpus: the
count statistics are float32 integers, so the conservation checks are
exact (``consistency_error() == 0.0``) and a BSP restore equals the
uninterrupted run bit for bit.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from repro.core import fault as ref_fault
from repro_torch.core import lda
from repro_torch.core.fault import (NET_KINDS, ROUND_KINDS, FaultEvent,
                                    FaultPlan, healthy)
from repro_torch.engine import Trainer, TrainerConfig
from tests.conftest import make_synthetic_corpus

VOCAB = 64


def _cfg():
    return lda.LDAConfig(n_topics=6, vocab_size=VOCAB)


@pytest.fixture(scope="module")
def corpus():
    tokens, mask, _ = make_synthetic_corpus(n_topics=4, vocab=VOCAB,
                                            n_docs=24, doc_len=16, seed=3)
    return np.asarray(tokens), np.asarray(mask)


def _trainer(corpus, **kw):
    tokens, mask = corpus
    kw.setdefault("n_clients", 2)
    return Trainer(_cfg(), tokens, mask,
                   config=TrainerConfig(layout="sorted", **kw), device="cpu")


# ---------------------------------------------------------------------------
# FaultPlan against the reference module
# ---------------------------------------------------------------------------

def test_fault_event_validation():
    with pytest.raises(ValueError, match="kind"):
        FaultEvent("explode", 0, 0, 1)
    with pytest.raises(ValueError, match="reversed"):
        FaultEvent("crash", 0, 3, 1)
    with pytest.raises(ValueError, match="period"):
        FaultEvent("straggle", 0, 0, 4, period=1)
    with pytest.raises(ValueError, match="client"):
        FaultEvent("crash", -1, 0, 1)
    with pytest.raises(ValueError, match="fraction"):
        FaultEvent("frame_truncate", 0, 0, 1, magnitude=1.5)
    with pytest.raises(TypeError):
        FaultPlan(events=("crash",))
    assert ROUND_KINDS == ref_fault.ROUND_KINDS
    assert NET_KINDS == ref_fault.NET_KINDS


def test_plan_resolution_scripted():
    plan = FaultPlan.scripted(
        FaultEvent("crash", client=1, start=2, stop=4),
        FaultEvent("lost_push", client=0, start=3, stop=5),
        FaultEvent("straggle", client=2, start=0, stop=6, period=3),
        FaultEvent("failed_pull", start=4, stop=5),
    )
    n = 4
    rf = plan.resolve(0, n)
    assert rf.alive == (True,) * 4 and rf.push_ok == (True,) * 4
    assert not rf.pull_failed and rf.rejoining == ()
    rf = plan.resolve(1, n)
    assert rf.alive == (True, True, False, True)
    rf = plan.resolve(3, n)
    assert rf.alive == (True, False, True, True)
    assert rf.push_ok == (False, False, True, True)
    rf = plan.resolve(4, n)
    assert rf.alive == (True, True, False, True)
    assert rf.rejoining == (1,) and rf.pull_failed
    assert plan.resolve(7, n) is healthy(n)
    assert plan.last_round == 6 and plan.max_client == 2


def test_plan_rejoin_suppressed_by_overlapping_crash():
    plan = FaultPlan.scripted(FaultEvent("crash", client=0, start=0, stop=2),
                              FaultEvent("crash", client=0, start=2, stop=4))
    rf = plan.resolve(2, 2)
    assert not rf.alive[0] and rf.rejoining == ()
    assert plan.resolve(4, 2).rejoining == (0,)


def test_plan_resolution_rejects_out_of_range_client():
    with pytest.raises(ValueError, match="only 2 clients"):
        FaultPlan.crash(5, 0, 2).resolve(1, 2)


def _as_tuples(events):
    return [(e.kind, e.client, e.start, e.stop, e.period, e.magnitude)
            for e in events]


@pytest.mark.parametrize("seed,hazards", [
    (7, dict(p_crash=0.1, p_straggle=0.1, p_lost_push=0.1,
             p_failed_pull=0.05)),
    (8, dict(p_crash=0.3, p_straggle=0.2, p_lost_push=0.2,
             p_failed_pull=0.2, mean_window=2.0)),
    (3, {}),
])
def test_random_plan_equals_reference(seed, hazards):
    """Equal arguments give the reference's events, and both resolve them
    to the same flags in every round."""
    n_clients, n_rounds = 4, 40
    ours = FaultPlan.random(seed, n_clients, n_rounds, **hazards)
    theirs = ref_fault.FaultPlan.random(seed, n_clients, n_rounds, **hazards)
    assert _as_tuples(ours.events) == _as_tuples(theirs.events)
    assert ours.events or not hazards, "expected events at these rates"
    assert ours.max_client == theirs.max_client
    assert ours.last_round == theirs.last_round
    for r in range(n_rounds + 2):
        a, b = ours.resolve(r, n_clients), theirs.resolve(r, n_clients)
        assert (a.alive, a.push_ok, a.pull_failed, a.rejoining) == \
            (b.alive, b.push_ok, b.pull_failed, b.rejoining), r
    for c in range(n_clients):
        wins = sorted((e.start, e.stop) for e in ours.events
                      if e.kind != "failed_pull" and e.client == c)
        for (_, s0), (s1, _) in zip(wins, wins[1:]):
            assert s0 <= s1


def test_network_events_equal_reference():
    """The transport kinds resolve to nothing in a round; their defaults
    and the plan's properties follow the reference."""
    kw = [("conn_drop", 0, 3, 5, 1, 0.0), ("frame_truncate", -1, 0, 4, 2,
                                            0.0),
          ("delay", 2, 1, 9, 3, 0.0), ("crash", 1, 2, 3, 2, 0.0)]
    ours = FaultPlan.scripted(*(FaultEvent(*a) for a in kw))
    theirs = ref_fault.FaultPlan.scripted(
        *(ref_fault.FaultEvent(*a) for a in kw))
    assert _as_tuples(ours.net_events) == _as_tuples(theirs.net_events)
    assert [e.magnitude for e in ours.net_events] == [0.0, 0.5, 0.05]
    assert ours.last_round == theirs.last_round == 3
    assert ours.max_client == theirs.max_client == 1
    for r in range(6):
        a, b = ours.resolve(r, 2), theirs.resolve(r, 2)
        assert (a.alive, a.push_ok, a.pull_failed, a.rejoining) == \
            (b.alive, b.push_ok, b.pull_failed, b.rejoining), r
    assert FaultPlan.from_drop_client((1, 1, 3)) == FaultPlan.crash(1, 1, 3)


# ---------------------------------------------------------------------------
# The Trainer's fault options
# ---------------------------------------------------------------------------

def test_drop_client_shim_warns_and_matches(corpus):
    with pytest.warns(DeprecationWarning, match="drop_client"):
        t = _trainer(corpus, n_clients=4, drop_client=(1, 1, 3))
    assert t.fault_plan == FaultPlan.crash(1, 1, 3)


def test_drop_client_and_fault_plan_mutually_exclusive(corpus):
    with pytest.raises(ValueError, match="mutually exclusive"):
        _trainer(corpus, n_clients=4, drop_client=(1, 1, 3),
                 fault_plan=FaultPlan.crash(0, 0, 1))


def test_trainer_rejects_plan_naming_missing_client(corpus):
    with pytest.raises(ValueError, match="client 3"):
        _trainer(corpus, fault_plan=FaultPlan.crash(3, 0, 1))


def test_compiled_false_rejects_incremental_rebuilds(corpus):
    with pytest.raises(ValueError, match="compiled"):
        _trainer(corpus, compiled=False, alias_rebuild_threshold=0.0)


def _stats(t):
    return {n: v.numpy() for n, v in t.family.stats_dict(t.shared).items()}


def test_bsp_crash_restore_bit_exact(corpus, tmp_path):
    """The oracle property: a run resumed from its round-4 snapshot
    replays rounds 4-5 bit for bit."""
    tokens, mask = corpus
    tcfg = TrainerConfig(layout="sorted", n_clients=2, snapshot_every=2,
                         snapshot_dir=str(tmp_path))
    ref = Trainer(_cfg(), tokens, mask, config=tcfg, device="cpu")
    for _ in range(6):
        ref.step()
    res = Trainer.restore(_cfg(), tokens, mask, config=tcfg, step=4,
                          device="cpu")
    assert res.round_idx == 4
    for _ in range(2):
        res.step()
    assert res.consistency_error() == 0.0
    a, b = _stats(ref), _stats(res)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)
    for x, y in zip(ref.locals_, res.locals_):
        assert torch.equal(x.z, y.z) and torch.equal(x.n_dk, y.n_dk)
    np.testing.assert_array_equal(ref.clocks, res.clocks)


def test_restore_latest_default_and_missing_dir(corpus, tmp_path):
    tokens, mask = corpus
    tcfg = TrainerConfig(layout="sorted", n_clients=2, snapshot_every=2,
                         snapshot_dir=str(tmp_path))
    t = Trainer(_cfg(), tokens, mask, config=tcfg, device="cpu")
    for _ in range(5):
        t.step()
    res = Trainer.restore(_cfg(), tokens, mask, config=tcfg, device="cpu")
    assert res.round_idx == 4
    with pytest.raises(ValueError, match="snapshot_dir"):
        Trainer.restore(_cfg(), tokens, mask, device="cpu",
                        config=TrainerConfig(layout="sorted", n_clients=2))


def test_ssp_rejoin_forces_refresh_and_resets_lag(corpus, tmp_path):
    """Kill-and-rejoin under SSP(3): the rejoin at round 3 forces a fresh
    pull off-schedule and the rejoined client re-enters with a cleared
    lag; no count mass is lost."""
    t = _trainer(corpus, consistency="ssp:3",
                 fault_plan=FaultPlan.crash(1, 1, 3), snapshot_every=2,
                 snapshot_dir=str(tmp_path))
    for _ in range(3):
        t.step()
    assert t._host_version == 0
    t.step()
    assert t.rejoins == 1
    assert t._host_version == 3 and t.pstate.cache_version == 3
    assert t.consistency_error() == 0.0
    np.testing.assert_array_equal(t.clocks, [4, 2])


def test_server_rejoin_client_clears_one_lag_row(corpus):
    t = _trainer(corpus, consistency="ssp:3")
    for _ in range(2):
        t.step()
    before = {n: v.clone() for n, v in t.pstate.client_lag.items()}
    assert any(float(v[0].abs().sum()) > 0 for v in before.values())
    lag_in = dict(t.pstate.client_lag)
    state = t.server.rejoin_client(t.pstate, 0)
    for n, v in state.client_lag.items():
        assert not bool(v[0].any())
        assert torch.equal(v[1], before[n][1])
        assert v is lag_in[n]        # in place, as the round's lag add


def test_failed_pull_bounded_retry_then_force_through(corpus):
    """An SSP(2) refresh outage: the due pull at round 3 fails twice,
    then forces through at round 5; no count mass is lost."""
    plan = FaultPlan.scripted(FaultEvent("failed_pull", start=1, stop=12))
    t = _trainer(corpus, consistency="ssp:2", fault_plan=plan,
                 pull_retry_limit=2)
    for _ in range(6):
        t.step()
    assert t.pull_failures == 2
    assert t._host_version == 5 and t.pstate.cache_version == 5
    assert t.consistency_error() == 0.0


def test_failed_pull_noop_under_bsp(corpus):
    plan = FaultPlan.scripted(FaultEvent("failed_pull", start=0, stop=8))
    t = _trainer(corpus, fault_plan=plan)
    for _ in range(3):
        t.step()
    assert t.pull_failures == 0
    assert t.consistency_error() == 0.0


@pytest.mark.parametrize("compiled", [True, False])
def test_lost_push_loses_mass_and_freezes_clock(corpus, compiled):
    t = _trainer(corpus, compiled=compiled, fault_plan=FaultPlan.scripted(
        FaultEvent("lost_push", client=1, start=1, stop=3)))
    for _ in range(4):
        t.step()
    np.testing.assert_array_equal(t.clocks, [4, 2])
    assert t.consistency_error() > 0.0


def test_straggler_conserves_counts(corpus):
    t = _trainer(corpus, fault_plan=FaultPlan.scripted(
        FaultEvent("straggle", client=1, start=0, stop=6, period=2)))
    for _ in range(6):
        t.step()
    np.testing.assert_array_equal(t.clocks, [6, 3])
    assert t.consistency_error() == 0.0


def test_compiled_false_equals_compiled_under_fault_plan(corpus):
    """``compiled=False`` is the same eager round: equal statistics and
    clocks under a plan with a crash, a lost push and a straggler."""
    plan = FaultPlan.scripted(
        FaultEvent("crash", client=0, start=1, stop=3),
        FaultEvent("lost_push", client=1, start=2, stop=4),
        FaultEvent("straggle", client=2, start=0, stop=5, period=2))
    ts = [_trainer(corpus, n_clients=3, compiled=c, fault_plan=plan)
          for c in (True, False)]
    for _ in range(5):
        for t in ts:
            t.step()
    a, b = _stats(ts[0]), _stats(ts[1])
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)
    np.testing.assert_array_equal(ts[0].clocks, ts[1].clocks)
    np.testing.assert_array_equal(ts[0].clocks, [3, 3, 3])


def test_rejoin_restores_locals_from_the_snapshot(corpus, tmp_path):
    """A client crashed over rounds 2-3 rejoins at round 4 with the
    locals of the round-2 snapshot, which equal its frozen ones (nothing
    moved it while it was down): the rejoin loses no mass."""
    t = _trainer(corpus, fault_plan=FaultPlan.crash(1, 2, 4),
                 snapshot_every=2, snapshot_dir=str(tmp_path))
    for _ in range(4):
        t.step()
    frozen = t.locals_[1].z.clone()
    t.step()
    assert t.rejoins == 1
    assert t.consistency_error() == 0.0
    np.testing.assert_array_equal(t.clocks, [5, 3])
    assert not torch.equal(t.locals_[1].z, frozen), "it sampled again"


def test_rejoin_falls_back_when_every_snapshot_is_corrupt(corpus, tmp_path):
    t = _trainer(corpus, fault_plan=FaultPlan.crash(0, 1, 3),
                 snapshot_every=2, snapshot_dir=str(tmp_path))
    for _ in range(3):
        t.step()
    for name in os.listdir(tmp_path):
        if name.endswith(".npz"):
            with open(tmp_path / name, "r+b") as f:
                f.truncate(20)
    with pytest.warns(RuntimeWarning, match="in-memory"):
        t.step()
    assert t.rejoins == 1
    assert t.consistency_error() == 0.0
