"""Transport parity on the port alone, on the CPU (mirrors of
``tests/test_wire_transport.py``): the port's tcp ``Trainer`` against its
in-process ``Trainer``, and the port's ``RemoteParameterServer`` against
its ``ShardServer``.

BSP over loopback TCP is bit-exact with the in-process run (same corpus,
seed and rounds), one worker or two; SSP conserves the token mass and
lands near BSP's perplexity; the stress tests hammer a live server from
threads and check the final store is exactly init + Σ deltas.
"""

from __future__ import annotations

import threading

import numpy as np
import pytest

from repro_torch import bridge
from repro_torch.core import family as fam_mod
from repro_torch.engine import Trainer, TrainerConfig
from repro_torch.net.client import RemoteParameterServer, stress_delta
from repro_torch.net.protocol import MsgType, ProtocolError
from repro_torch.net.server import MUTLOG_WINDOW, serve_shards
from tests.conftest import make_family_cfg, make_synthetic_corpus

TIMEOUT = 30.0
CPU = "cpu"


def _corpus():
    tokens, mask, _ = make_synthetic_corpus(n_topics=4, vocab=64, n_docs=16,
                                            doc_len=12, seed=3)
    return np.asarray(tokens), np.asarray(mask)


def _cfg(family_name):
    return bridge.config_from(make_family_cfg(family_name, n_topics=4,
                                              vocab_size=64))


def _stats(trainer):
    return {n: v.numpy() for n, v in
            trainer.family.stats_dict(trainer.shared).items()}


def _run_ref(cfg, tokens, mask, *, n_clients, rounds, consistency="bsp"):
    t = Trainer(cfg, tokens, mask, device=CPU,
                config=TrainerConfig(layout="sorted", n_clients=n_clients,
                                     consistency=consistency))
    for _ in range(rounds):
        t.step()
    return t


def _servers(family_name, *, n_clients, n_shards=1, consistency="bsp"):
    return serve_shards(family_name, vocab_size=64, n_clients=n_clients,
                        n_shards=n_shards, consistency=consistency,
                        barrier_timeout=TIMEOUT, device=CPU)


def _addrs(servers):
    return tuple("%s:%d" % s.address for s in servers)


def _tcp(cfg, tokens, mask, servers, **kw):
    return Trainer(cfg, tokens, mask, device=CPU, config=TrainerConfig(
        layout="sorted", n_clients=2, transport="tcp",
        server_addrs=_addrs(servers), **kw))


# ---------------------------------------------------------------------------
# Trainer-level parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family_name", ["lda", "pdp"])
@pytest.mark.parametrize("sparse_push", [False, True])
def test_bsp_tcp_bitexact_single_worker(family_name, sparse_push):
    """One tcp Trainer hosting every client equals the in-process run bit
    for bit, with dense or COO push frames (sparse_push is an encoding:
    PDP's rows are the union of m_wk's and s_wk's non-zero rows)."""
    tokens, mask = _corpus()
    cfg = _cfg(family_name)
    want = _stats(_run_ref(cfg, tokens, mask, n_clients=2, rounds=3))
    servers = _servers(family_name, n_clients=2, n_shards=2)
    try:
        t = _tcp(cfg, tokens, mask, servers, sparse_push=sparse_push)
        for _ in range(3):
            t.step()
        got = _stats(t)
        assert t.consistency_error() == 0.0
        t.close()
    finally:
        for s in servers:
            s.close()
    assert set(want) == set(got)
    for n in want:
        np.testing.assert_array_equal(want[n], got[n], err_msg=n)


def test_bsp_tcp_bitexact_two_workers():
    """Two tcp Trainers (one global client each, stepped concurrently)
    jointly reproduce the single-process run exactly."""
    tokens, mask = _corpus()
    cfg = _cfg("lda")
    want = _stats(_run_ref(cfg, tokens, mask, n_clients=2, rounds=3))
    servers = _servers("lda", n_clients=2)
    try:
        t0, t1 = (_tcp(cfg, tokens, mask, servers, local_clients=cs)
                  for cs in ((0,), (1,)))
        for _ in range(3):
            th = threading.Thread(target=t1.step)
            th.start()
            t0.step()
            th.join(timeout=TIMEOUT)
            assert not th.is_alive()
        got0, got1 = _stats(t0), _stats(t1)
        counters = t0.remote.counters()
        with pytest.raises(RuntimeError, match="every client's locals"):
            t0.consistency_error()
        t0.close()
        t1.close()
    finally:
        for s in servers:
            s.close()
    for n in want:
        np.testing.assert_array_equal(want[n], got0[n], err_msg=n)
        np.testing.assert_array_equal(want[n], got1[n], err_msg=n)
    assert counters["rpc_count"] > 0 and counters["bytes_out"] > 0


def test_ssp_tcp_runs_within_tolerance():
    """SSP(2) over the wire: NOT_MODIFIED engages (kernel 2's plain
    version runs on the refreshes only), the token mass is conserved
    exactly, and the model lands near the BSP result."""
    tokens, mask = _corpus()
    cfg = _cfg("lda")
    ref = _run_ref(cfg, tokens, mask, n_clients=2, rounds=6)
    ref_ppl = ref.perplexity()
    servers = _servers("lda", n_clients=2, consistency="ssp:2")
    try:
        t = _tcp(cfg, tokens, mask, servers, consistency="ssp:2")
        for _ in range(6):
            t.step()
        t._sync()
        got = _stats(t)
        ppl = t.perplexity()
        assert t.consistency_error() == 0.0
        assert t.alias_builds == 2               # refreshes at rounds 0, 3
        t.close()
    finally:
        for s in servers:
            s.close()
    assert got["n_wk"].sum() == pytest.approx(float(mask.sum()))
    assert np.isfinite(ppl)
    assert abs(ppl - ref_ppl) / ref_ppl < 0.25


def test_tcp_rejects_unsupported_configs():
    tokens, mask = _corpus()
    with pytest.raises(NotImplementedError, match="post_round"):
        Trainer(_cfg("hdp"), tokens, mask, device=CPU, config=TrainerConfig(
            layout="sorted", n_clients=2, transport="tcp",
            server_addrs=("127.0.0.1:1",)))
    lcfg = _cfg("lda")
    for kw in ({"transport": "tcp"},
               {"transport": "inproc", "server_addrs": ("127.0.0.1:1",)},
               {"transport": "udp"},
               {"transport": "tcp", "server_addrs": ("127.0.0.1:1",),
                "local_clients": (0, 0)}):
        with pytest.raises(ValueError):
            Trainer(lcfg, tokens, mask, device=CPU,
                    config=TrainerConfig(layout="sorted", n_clients=2, **kw))


def test_sparse_push_rejected_on_inproc_transport():
    tokens, mask = _corpus()
    with pytest.raises(ValueError):
        Trainer(_cfg("lda"), tokens, mask, device=CPU, config=TrainerConfig(
            layout="sorted", n_clients=2, sparse_push=True))


# ---------------------------------------------------------------------------
# RemoteParameterServer-level semantics
# ---------------------------------------------------------------------------

def _fresh_remote(servers, n_clients=1, consistency="bsp", **kw):
    return RemoteParameterServer(_addrs(servers), family="lda",
                                 n_clients=n_clients, vocab_size=64,
                                 consistency=consistency, timeout=TIMEOUT,
                                 device=CPU, **kw)


def _zero_shared():
    n_wk = np.zeros((64, 4), np.float32)
    return fam_mod.get("lda").shared_from_dict({"n_wk": n_wk,
                                                "n_k": n_wk.sum(0)})


def test_not_modified_and_version_flow():
    servers = _servers("lda", n_clients=1, consistency="ssp:2")
    try:
        with _fresh_remote(servers, consistency="ssp:2") as rps:
            rps.init_push(0, _zero_shared())
            shared, v, refreshed = rps.pull(0, None)
            assert refreshed and v == 0 and shared is not None
            rps.push(0, 0, {"n_wk": np.ones((64, 4), np.float32)})
            shared, v, refreshed = rps.pull(1, v)
            assert not refreshed and shared is None and v == 0
            rps.push(1, 0, {"n_wk": np.ones((64, 4), np.float32)})
            rps.push(2, 0, {"n_wk": np.ones((64, 4), np.float32)})
            shared, v, refreshed = rps.pull(3, 0)
            assert refreshed and v == 3
            np.testing.assert_array_equal(
                shared.n_wk.numpy(), np.full((64, 4), 3, np.float32))
            np.testing.assert_array_equal(
                shared.n_k.numpy(), np.full((4,), 192, np.float32))
    finally:
        for s in servers:
            s.close()


def test_pull_keys_clock_rejoin_snapshot():
    servers = _servers("lda", n_clients=1, n_shards=2)
    try:
        with _fresh_remote(servers) as rps:
            rps.init_push(0, _zero_shared())
            d = stress_delta(0, 0, (64, 4))
            rps.pull(0)
            rps.push(0, 0, {"n_wk": d})
            sr, clocks = rps.clock(min_round=1)
            assert sr == 1
            np.testing.assert_array_equal(clocks, [1])
            # Addressed row-range read spanning the shard boundary.
            mid = rps.pull_keys(["n_wk"], lo=16, hi=48)["n_wk"]
            np.testing.assert_array_equal(mid, d[16:48])
            rps.rejoin(0)
            snap = rps.snapshot(min_round=1)
            np.testing.assert_array_equal(snap.n_wk.numpy(), d)
            np.testing.assert_array_equal(snap.n_k.numpy(), d.sum(0))
    finally:
        for s in servers:
            s.close()


def test_projection_applied_at_barrier():
    """A negative delta pushing a count below zero is clipped by the
    family's nonneg rule at the round barrier, as in process."""
    servers = _servers("lda", n_clients=1)
    try:
        with _fresh_remote(servers) as rps:
            rps.init_push(0, _zero_shared())
            rps.pull(0)
            rps.push(0, 0, {"n_wk": np.full((64, 4), -1.0, np.float32)})
            out = rps.pull_keys(["n_wk"])["n_wk"]
            np.testing.assert_array_equal(out, np.zeros((64, 4)))
    finally:
        for s in servers:
            s.close()


def test_concurrent_stress_exact_sum():
    """Many client threads, out-of-order arrivals: the barrier still
    applies rounds deterministically; final state == init + Σ."""
    n_clients, rounds, shape = 4, 8, (64, 4)
    servers = _servers("lda", n_clients=n_clients, n_shards=2)
    try:
        remotes = [_fresh_remote(servers, n_clients=n_clients)
                   for _ in range(n_clients)]
        for c, rps in enumerate(remotes):
            rps.init_push(c, _zero_shared())

        def worker(c):
            rps, version = remotes[c], None
            for r in range(rounds):
                _, v, refreshed = rps.pull(r, version)
                if refreshed:
                    version = v
                rps.push(r, c, {"n_wk": stress_delta(r, c, shape)})

        threads = [threading.Thread(target=worker, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT * 4)
            assert not t.is_alive(), "stress worker hung"
        remotes[0].clock(min_round=rounds)
        final = remotes[0].pull_keys(["n_wk"])["n_wk"]
        want = np.zeros(shape, np.float32)
        for r in range(rounds):
            for c in range(n_clients):
                want = want + stress_delta(r, c, shape)
        np.testing.assert_array_equal(final, want)
        for rps in remotes:
            rps.close()
    finally:
        for s in servers:
            s.close()


def test_duplicate_push_idempotent_conflict_rejected():
    """A byte-identical re-push is the lost-ack retry: acked, applied
    once; different content claiming the same (client, round) slot is
    refused, before and after the round finalizes."""
    servers = _servers("lda", n_clients=2)
    try:
        r0 = _fresh_remote(servers, n_clients=2)
        r1 = _fresh_remote(servers, n_clients=2)
        r0.init_push(0, _zero_shared())
        r1.init_push(1, _zero_shared())
        d = np.ones((64, 4), np.float32)
        r0.pull(0)
        r0.push(0, 0, {"n_wk": d})
        r1.push(0, 0, {"n_wk": d})
        with pytest.raises(ProtocolError):
            r1.push(0, 0, {"n_wk": 2 * d})
        r1.push(0, 1, {"n_wk": d})      # re-dials: the refusal closed it
        r1.clock(min_round=1)
        r1.push(0, 1, {"n_wk": d})
        with pytest.raises(ProtocolError):
            r1.push(0, 1, {"n_wk": 3 * d})
        final = r0.pull_keys(["n_wk"])["n_wk"]
        np.testing.assert_array_equal(final, 2 * d)
        r1.close()
        r0.close()
    finally:
        for s in servers:
            s.close()


def test_stale_push_replay_flag_vs_unflagged():
    """A push below the finalized horizon whose log entry was pruned: a
    replay-flagged frame acks ``ignored``; an unflagged one is refused."""
    servers = _servers("lda", n_clients=1)
    try:
        with _fresh_remote(servers) as rps:
            rps.init_push(0, _zero_shared())
            d = np.ones((64, 4), np.float32)
            for r in range(MUTLOG_WINDOW + 2):
                rps.pull(r)
                rps.push(r, 0, {"n_wk": d})
            conn = rps._conns[0]
            _, meta, _ = conn.request(
                MsgType.PUSH, {"round": 0, "client": 0, "replay": True},
                {"n_wk": d}, expect=(MsgType.OK,))
            assert meta.get("ignored") is True
            with pytest.raises(ProtocolError):
                conn.request(MsgType.PUSH, {"round": 0, "client": 0},
                             {"n_wk": d}, expect=(MsgType.OK,))
    finally:
        for s in servers:
            s.close()


def test_sparse_frame_rejects_bad_rows_and_leaves_store():
    """Unsorted, duplicate and out-of-range row ids, and a value block of
    the wrong shape, each answer ERROR before the store is touched."""
    servers = _servers("lda", n_clients=1)
    d = np.ones((2, 4), np.float32)
    bad = [({"rows": np.array([3, 1], np.uint32), "n_wk": d}, "increasing"),
           ({"rows": np.array([2, 2], np.uint32), "n_wk": d}, "increasing"),
           ({"rows": np.array([1, 64], np.uint32), "n_wk": d}, "range"),
           ({"rows": np.array([1, 2], np.uint32), "n_wk": d[:1]}, "shape")]
    try:
        with _fresh_remote(servers) as rps:
            rps.init_push(0, _zero_shared())
            rps.pull(0)
            for arrays, why in bad:
                conn = _fresh_remote(servers)._conns[0]
                with pytest.raises(ProtocolError, match=why):
                    conn.request(MsgType.PUSH_SPARSE,
                                 {"round": 0, "client": 0, "n_rows": 64},
                                 arrays, expect=(MsgType.OK,))
            np.testing.assert_array_equal(rps.pull_keys(["n_wk"])["n_wk"],
                                          np.zeros((64, 4)))
            assert servers[0].stats()["server_round"] == 0
    finally:
        for s in servers:
            s.close()
