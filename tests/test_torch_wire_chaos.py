"""The port's chaos proxy, on the CPU (mirrors of ``tests/test_chaos.py``):
its actions are a pure function of (plan, connection ordinal, frame
ordinal), so a scripted schedule replayed twice corrupts the same frames,
giving byte-identical stores and equal retry counts; and because every
mutation is idempotent, a run through drops, truncations and delays ends
with the exact no-failure sum.  The port's proxy also relays the
reference's server unchanged (the frames are the same).
"""

from __future__ import annotations

import numpy as np
import pytest

from repro.net.server import serve_shards as ref_serve_shards
from repro_torch.core import family as fam_mod
from repro_torch.core.fault import FaultEvent, FaultPlan
from repro_torch.net.chaos import ChaosProxy, interpose
from repro_torch.net.client import RemoteParameterServer, stress_delta
from repro_torch.net.server import serve_shards

TIMEOUT = 30.0
SHAPE = (64, 4)


def _zero_shared():
    n_wk = np.zeros(SHAPE, np.float32)
    return fam_mod.get("lda").shared_from_dict({"n_wk": n_wk,
                                                "n_k": n_wk.sum(0)})


def _want(rounds: int) -> np.ndarray:
    return sum(stress_delta(r, 0, SHAPE) for r in range(rounds))


def _run_through_chaos(plan, rounds: int = 3, serve=None):
    """One single-client stress run through a proxied shard; returns
    (store bytes, client counters, proxy stats)."""
    serve = serve or (lambda **kw: serve_shards(device="cpu", **kw))
    servers = serve(family_name="lda", vocab_size=64, n_clients=1,
                    barrier_timeout=TIMEOUT)
    proxied, proxies = interpose(["%s:%d" % s.address for s in servers],
                                 plan)
    rps = RemoteParameterServer(proxied, family="lda", n_clients=1,
                                vocab_size=64, timeout=TIMEOUT,
                                reconnect_limit=10, local_clients=(0,),
                                device="cpu")
    try:
        rps.init_push(0, _zero_shared())
        for r in range(rounds):
            rps.pull(r)
            rps.push(r, 0, {"n_wk": stress_delta(r, 0, SHAPE)})
        rps.clock(min_round=rounds)
        store = rps.pull_keys(["n_wk"])["n_wk"].tobytes()
        counters = rps.counters()
    finally:
        rps.close()
        for p in proxies:
            p.close()
        for s in servers:
            s.close()
    return store, counters, [p.stats() for p in proxies]


# Frame ordinals: HELLO=0, INIT=1, PULL(r)=2+2r, PUSH(r)=3+2r.  Each
# reconnect gets the next connection ordinal, so a drop aimed at one
# ordinal fires exactly once.
SCHEDULE = FaultPlan.scripted(
    FaultEvent("delay", client=-1, start=0, stop=1, period=1,
               magnitude=0.01),
    FaultEvent("conn_drop", client=0, start=3, stop=4, period=1),
    FaultEvent("frame_truncate", client=1, start=2, stop=3, period=1,
               magnitude=0.5),
)


@pytest.mark.parametrize("server_pkg", ["port", "ref"])
def test_chaos_run_recovers_to_exact_sum(server_pkg):
    """Drops, truncations and delays on the mutation path change nothing
    about the final store, whichever package serves."""
    serve = None if server_pkg == "port" else ref_serve_shards
    store, counters, stats = _run_through_chaos(SCHEDULE, serve=serve)
    assert store == _want(3).tobytes()
    assert counters["retries"] >= 2
    assert counters["reconnects"] >= 2
    acts = stats[0]["actions"]
    assert acts["conn_drop"] == 1 and acts["frame_truncate"] == 1
    assert acts["delay"] == stats[0]["connections"]


def test_chaos_schedule_replay_is_deterministic():
    store_a, counters_a, stats_a = _run_through_chaos(SCHEDULE)
    store_b, counters_b, stats_b = _run_through_chaos(SCHEDULE)
    assert store_a == store_b
    assert counters_a["retries"] == counters_b["retries"]
    assert counters_a["reconnects"] == counters_b["reconnects"]
    assert [s["actions"] for s in stats_a] == [s["actions"] for s in stats_b]
    assert [s["connections"] for s in stats_a] == \
           [s["connections"] for s in stats_b]


def test_chaos_passthrough_is_invisible():
    store, counters, stats = _run_through_chaos(FaultPlan.none())
    assert store == _want(3).tobytes()
    assert counters["retries"] == 0 and counters["reconnects"] == 0
    assert all(v == 0 for v in stats[0]["actions"].values())
    assert stats[0]["frames_forwarded"] > 0


@pytest.mark.parametrize("magnitude", [0.0, 0.25, 0.75])
def test_chaos_truncation_fuzz_placement(magnitude):
    """Cutting the round-0 push at different payload fractions always
    yields a clean frame loss, and the retry completes the exact sum."""
    plan = FaultPlan.scripted(
        FaultEvent("frame_truncate", client=0, start=3, stop=4, period=1,
                   magnitude=magnitude))
    store, counters, stats = _run_through_chaos(plan)
    assert store == _want(3).tobytes()
    assert counters["retries"] >= 1
    assert stats[0]["actions"]["frame_truncate"] == 1


def test_round_kind_events_stay_with_the_trainer():
    """A plan mixing round kinds (the trainer's) with network kinds (the
    proxy's): the proxy takes only its own; the round kinds still resolve
    on the host."""
    plan = FaultPlan.scripted(
        FaultEvent("crash", client=0, start=0, stop=1),
        FaultEvent("delay", client=-1, start=0, stop=1, period=1,
                   magnitude=0.01))
    proxy = ChaosProxy("127.0.0.1:1", plan)
    try:
        assert [e.kind for e in proxy.events] == ["delay"]
    finally:
        proxy.close()
    assert plan.resolve(0, 1).alive == (False,)
