"""Fault tolerance on the port's wire, on the CPU (mirrors of the
reconnect, eviction, restart and ghost cases of
``tests/test_wire_transport.py``, and its process-level stress run):
bounded reconnects, barrier eviction and rejoin, a voluntary leave, a
shard restarted from its own snapshot mid-run, the SNAPSHOT_WRITE and
SNAPSHOT_RESTORE frames, a scripted fault plan riding the wire as ghost
pushes, and a tcp worker restored from its snapshot, each exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.core import family as fam_mod
from repro_torch.core.fault import FaultPlan
from repro_torch.engine import Trainer, TrainerConfig
from repro_torch.net.client import (RemoteError, RemoteParameterServer,
                                    stress_delta)
from repro_torch.net.server import serve_shards
from tests.conftest import make_family_cfg, make_synthetic_corpus

TIMEOUT = 30.0
CPU = "cpu"
SHAPE = (64, 4)


def _addrs(servers):
    return tuple("%s:%d" % s.address for s in servers)


def _servers(n_clients=1, n_shards=1, **kw):
    kw.setdefault("barrier_timeout", TIMEOUT)
    return serve_shards("lda", vocab_size=64, n_clients=n_clients,
                        n_shards=n_shards, device=CPU, **kw)


def _remote(servers, n_clients=1, **kw):
    return RemoteParameterServer(_addrs(servers), family="lda",
                                 n_clients=n_clients, vocab_size=64,
                                 timeout=TIMEOUT, device=CPU, **kw)


def _zero_shared():
    n_wk = np.zeros(SHAPE, np.float32)
    return fam_mod.get("lda").shared_from_dict({"n_wk": n_wk,
                                                "n_k": n_wk.sum(0)})


def _close(servers):
    for s in servers:
        s.close()


def test_pull_reconnects_after_dropped_connection():
    """A dead socket under a pull: the client re-dials, re-handshakes,
    carries its wire counters over, and the pull succeeds."""
    servers = _servers(n_shards=2)
    try:
        with _remote(servers) as rps:
            rps.init_push(0, _zero_shared())
            rps.pull(0)
            before = rps.counters()
            for conn in rps._conns:
                conn.sock.close()
            shared, _, refreshed = rps.pull(0)
            assert refreshed and shared is not None
            after = rps.counters()
            assert after["bytes_out"] > before["bytes_out"]
            assert after["rpc_count"] > before["rpc_count"]
            assert after["reconnects"] == 2
    finally:
        _close(servers)


def test_pull_reconnect_budget_exhausts_on_dead_server():
    """Every reconnect attempt fails once the server is gone: the pull
    raises RemoteError after reconnect_limit tries."""
    servers = _servers()
    rps = _remote(servers, reconnect_limit=2)
    try:
        rps.init_push(0, _zero_shared())
        rps.pull(0)
        _close(servers)
        for conn in rps._conns:
            conn.sock.close()
        with pytest.raises(RemoteError, match="after 2 reconnect"):
            rps.pull(0)
    finally:
        rps.close()
        _close(servers)


def test_dead_client_evicted_from_barrier_then_rejoins():
    """A client whose connections die holds the barrier only until the
    liveness deadline; rounds then finalize from the survivors, and a
    rejoin re-admits it after a forced-fresh pull."""
    servers = _servers(n_clients=2, liveness_timeout=0.4)
    d = np.ones(SHAPE, np.float32)
    try:
        r0, r1 = _remote(servers, 2), _remote(servers, 2)
        r0.init_push(0, _zero_shared())
        r1.init_push(1, _zero_shared())
        r0.pull(0)
        r0.push(0, 0, {"n_wk": d})
        r1.pull(0)
        r1.push(0, 1, {"n_wk": d})
        r1.close()                          # client 1 dies for good
        r0.pull(1)
        r0.push(1, 0, {"n_wk": d})          # round 1 waits on client 1...
        r0.pull(2)                          # ...until it is evicted
        st = servers[0].stats()
        assert st["evicted"] == [1] and st["evictions"] == 1
        np.testing.assert_array_equal(r0.pull_keys(["n_wk"])["n_wk"], 3 * d)
        r1b = _remote(servers, 2)
        r1b.rejoin(1)
        assert servers[0].stats()["evicted"] == []
        r1b.pull(2, None)
        r1b.push(2, 1, {"n_wk": d})
        r0.push(2, 0, {"n_wk": d})
        r0.clock(min_round=3)
        np.testing.assert_array_equal(r0.pull_keys(["n_wk"])["n_wk"], 5 * d)
        r1b.close()
        r0.close()
    finally:
        _close(servers)


def test_voluntary_leave_unblocks_barrier_immediately():
    servers = _servers(n_clients=2, liveness_timeout=60.0)
    d = np.ones(SHAPE, np.float32)
    r0 = _remote(servers, 2)
    try:
        r0.init_push(0, _zero_shared())
        r0.init_push(1, _zero_shared())
        r0.leave(1)
        r0.pull(0)
        r0.push(0, 0, {"n_wk": d})          # finalizes without client 1
        r0.clock(min_round=1)
        np.testing.assert_array_equal(r0.pull_keys(["n_wk"])["n_wk"], d)
    finally:
        r0.close()
        _close(servers)


def test_shard_restart_from_snapshot_resumes_midrun(tmp_path):
    """Kill the shard servers mid-run and restart them on the same ports
    from their own snapshots: the client reconnects, replays its buffered
    mutations (deduped by the restored log), and the run finishes with
    the exact no-failure sum."""
    kw = dict(n_clients=1, n_shards=2, snapshot_dir=str(tmp_path),
              snapshot_every=1)
    servers = _servers(**kw)
    ports = tuple(s.address[1] for s in servers)
    rps = _remote(servers, reconnect_limit=10)
    try:
        rps.init_push(0, _zero_shared())
        for r in range(3):
            rps.pull(r)
            rps.push(r, 0, {"n_wk": stress_delta(r, 0, SHAPE)})
        _close(servers)                     # hard kill, no shutdown
        servers = _servers(ports=ports, restore=True, **kw)
        assert all(s.stats()["server_round"] == 3 for s in servers)
        for r in range(3, 6):
            rps.pull(r)
            rps.push(r, 0, {"n_wk": stress_delta(r, 0, SHAPE)})
        rps.clock(min_round=6)
        want = sum(stress_delta(r, 0, SHAPE) for r in range(6))
        np.testing.assert_array_equal(rps.pull_keys(["n_wk"])["n_wk"], want)
        assert rps.counters()["reconnects"] >= 2
    finally:
        rps.close()
        _close(servers)


def test_snapshot_write_restore_rpcs(tmp_path):
    """SNAPSHOT_WRITE persists on demand; after a further round
    SNAPSHOT_RESTORE rolls the store back to the persisted round."""
    servers = _servers()
    d = np.ones(SHAPE, np.float32)
    try:
        with _remote(servers) as rps:
            rps.init_push(0, _zero_shared())
            rps.pull(0)
            rps.push(0, 0, {"n_wk": d})
            acks = rps.snapshot_write(str(tmp_path))
            assert [a["step"] for a in acks] == [1]
            rps.pull(1)
            rps.push(1, 0, {"n_wk": d})
            np.testing.assert_array_equal(
                rps.pull_keys(["n_wk"])["n_wk"], 2 * d)
            assert rps.snapshot_restore(str(tmp_path)) == [1]
            np.testing.assert_array_equal(
                rps.pull_keys(["n_wk"])["n_wk"], d)
    finally:
        _close(servers)


def _corpus():
    tokens, mask, _ = make_synthetic_corpus(n_topics=4, vocab=64, n_docs=16,
                                            doc_len=12, seed=3)
    return np.asarray(tokens), np.asarray(mask)


def _lda():
    return bridge.config_from(make_family_cfg("lda", n_topics=4,
                                              vocab_size=64))


def _stats(trainer):
    return {n: v.numpy() for n, v in
            trainer.family.stats_dict(trainer.shared).items()}


def test_trainer_tcp_fault_plan_ghost_parity():
    """A scripted crash over tcp (ghost pushes on the wire) equals the same
    faulted run in process, bit for bit, with one rejoin each."""
    tokens, mask = _corpus()
    cfg = _lda()
    plan = FaultPlan.crash(1, 1, 3)

    def faulted(**transport):
        t = Trainer(cfg, tokens, mask, device=CPU, config=TrainerConfig(
            layout="sorted", n_clients=2, fault_plan=plan, **transport))
        for _ in range(5):
            t.step()
        out, rejoins, clocks = _stats(t), t.rejoins, t.clocks.tolist()
        t.close()
        return out, rejoins, clocks

    want, ref_rejoins, ref_clocks = faulted()
    servers = _servers(n_clients=2)
    try:
        got, tcp_rejoins, tcp_clocks = faulted(
            transport="tcp", server_addrs=_addrs(servers))
    finally:
        _close(servers)
    assert ref_rejoins == tcp_rejoins == 1
    assert ref_clocks == tcp_clocks == [5, 3]
    for n in want:
        np.testing.assert_array_equal(want[n], got[n], err_msg=n)


def test_tcp_worker_restores_from_its_snapshot(tmp_path):
    """A tcp worker snapshotting every round is dropped after round 2 and
    restored by ``Trainer.restore`` against the still-live servers (its
    INIT replays dedup, it REJOINs); four rounds in all equal the
    uninterrupted in-process run bit for bit."""
    tokens, mask = _corpus()
    cfg = _lda()
    ref = Trainer(cfg, tokens, mask, device=CPU,
                  config=TrainerConfig(layout="sorted", n_clients=2))
    for _ in range(4):
        ref.step()
    servers = _servers(n_clients=2)
    tcfg = TrainerConfig(layout="sorted", n_clients=2, transport="tcp",
                         server_addrs=_addrs(servers), snapshot_every=1,
                         snapshot_dir=str(tmp_path))
    try:
        first = Trainer(cfg, tokens, mask, config=tcfg, device=CPU)
        for _ in range(2):
            first.step()
        first.close()
        res = Trainer.restore(cfg, tokens, mask, config=tcfg, device=CPU)
        assert res.round_idx == 2
        while res.round_idx < 4:
            res.step()
        got = _stats(res)
        for c in range(2):
            assert np.array_equal(res.locals_[c].z.numpy(),
                                  ref.locals_[c].z.numpy())
        res.close()
    finally:
        _close(servers)
    for n, v in _stats(ref).items():
        np.testing.assert_array_equal(got[n], v, err_msg=n)


def test_launch_loopback_stress_processes(tmp_path):
    """Real processes on loopback: 1 server process (2 shards) and 2
    stress worker processes, on the CPU; both report the checksums of
    init + Σ deltas."""
    from repro_torch.launch.loopback import launch_loopback
    res = launch_loopback(mode="stress", n_shards=2,
                          client_sets=((0,), (1,)), n_rounds=4,
                          timeout=180.0, workdir=str(tmp_path), device=CPU)
    assert res.ok, [(p.name, p.returncode, p.stderr[-2000:])
                    for p in res.failures()]
    sums = [p.result["checksums"] for p in res.clients]
    assert sums[0] == sums[1]
    want = sum(stress_delta(r, c, SHAPE) for r in range(4) for c in range(2))
    assert res.clients[0].result["sums"]["n_wk"] == pytest.approx(
        float(want.sum()))
