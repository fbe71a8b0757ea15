"""The port's INFER service on the wire, on the CPU: frames byte-equal to
the reference's, each package decoding the other's; the reference's
``InferenceClient`` served by the port's ``InferenceServer``; load
shedding; the INFER fuzz cases of ``tests/test_wire_protocol.py`` against
the port's server, which keeps serving; a batcher failure answered, not
hung; and the loopback launcher with client processes, bit-exact.
"""

from __future__ import annotations

import socket
import threading
import time
import types
import zipfile

import numpy as np
import pytest
import torch

from repro.net import protocol as ref_protocol
from repro.serve.client import InferenceClient as RefClient
from repro.serve.engine import result_checksum as ref_checksum
from repro_torch.core import family as fam_mod
from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
from repro_torch.launch import serve as launch_serve_mod
from repro_torch.net import protocol
from repro_torch.net.protocol import MsgType, ProtocolError
from repro_torch.serve import (FoldInEngine, InferRequest, ServeConfig,
                               freeze, result_checksum)
from repro_torch.serve.client import InferenceClient, requests_for
from repro_torch.serve.server import InferenceServer

SOCK_TIMEOUT = 5.0
V_INF, K_INF, LEN_INF = 16, 4, 8
CPU = "cpu"


def _snapshot():
    fam = fam_mod.get("lda")
    cfg = fam.config_cls(n_topics=K_INF, vocab_size=V_INF)
    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=K_INF, vocab_size=V_INF, n_docs=8, doc_len=LEN_INF,
        seed=0))
    _, shared = fam.init_state(cfg, torch.as_tensor(tokens),
                               torch.as_tensor(mask), (0,))
    return freeze(cfg, shared, device=CPU)


@pytest.fixture(scope="module")
def infer_server():
    snap = _snapshot()
    scfg = ServeConfig(max_slots=2, max_len=LEN_INF, n_sweeps=2)
    srv = InferenceServer(snap, scfg, idle_timeout=SOCK_TIMEOUT,
                          device=CPU).start()
    yield srv, snap, scfg
    srv.close()


def _good_doc():
    return np.arange(6, dtype=np.int32) % V_INF


def _addr(srv):
    return "%s:%d" % srv.address


def _infer_roundtrip(srv, uid=7, seed=3):
    with InferenceClient(_addr(srv), timeout=SOCK_TIMEOUT * 4) as cli:
        return cli.infer(uid, _good_doc(), seed=seed)


def _reference_result(snap, scfg, uid=7, seed=3):
    eng = FoldInEngine(snap, scfg, device=CPU)
    return eng.run([InferRequest(uid=uid, tokens=_good_doc(),
                                 seed=seed)])[uid]


def _infer_frame(meta=None, arrays=None):
    if meta is None:
        meta = {"uid": 1, "seed": 0}
    if arrays is None:
        arrays = {"tokens": _good_doc()}
    return protocol.pack_frame(MsgType.INFER, meta, arrays)


def _expect_error_then_close(sock: socket.socket):
    got = b""
    try:
        while len(got) < protocol.HEADER_SIZE:
            chunk = sock.recv(1 << 16)
            if not chunk:
                return None  # closed without the courtesy ERROR: fine
            got += chunk
    except (socket.timeout, ConnectionResetError):
        pytest.fail("server hung or reset instead of ERROR+close")
    mt, _ = protocol._validate_header(got[:protocol.HEADER_SIZE])
    assert mt is MsgType.ERROR
    return mt


# ---------------------------------------------------------------------------
# Frames
# ---------------------------------------------------------------------------

FRAMES = {
    "INFER": ({"uid": 7, "seed": 3}, {"tokens": np.arange(6, dtype=np.int32)}),
    "INFER_RESULT": ({"uid": 7, "n_sweeps": 10},
                     {"theta": np.linspace(0, 1, 4, dtype=np.float32),
                      "assignments": np.array([3, 0, 2], np.int32)}),
    "STATS": ({}, None),
    "OK": ({"served": 3, "shed": 0, "latency_p50_ms": 1.25,
            "batcher_error": None}, None),
    "ERROR": ({"error": "overloaded: admission queue full (1)",
               "shed": True}, None),
    "SHUTDOWN": ({}, None),
}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_frames_byte_equal_and_cross_decoded(name, monkeypatch):
    # npz members carry the zip's timestamp: pin it for both encoders.
    monkeypatch.setattr(zipfile, "time", types.SimpleNamespace(
        time=lambda: 1.7e9, localtime=time.localtime))
    meta, arrays = FRAMES[name]
    assert int(MsgType[name]) == int(ref_protocol.MsgType[name])
    ours = protocol.pack_frame(MsgType[name], meta, arrays)
    theirs = ref_protocol.pack_frame(ref_protocol.MsgType[name], meta,
                                     arrays)
    assert ours == theirs
    for codec, frame in ((protocol, theirs), (ref_protocol, ours)):
        a, b = socket.socketpair()
        try:
            a.sendall(frame)
            mt, meta2, arrays2 = codec.read_frame(b)
        finally:
            a.close()
            b.close()
        assert mt.name == name and meta2 == meta
        assert sorted(arrays2) == sorted(arrays or {})
        for k, v in (arrays or {}).items():
            assert arrays2[k].dtype == v.dtype
            np.testing.assert_array_equal(arrays2[k], v)


def test_message_types_and_header_match_the_reference():
    assert {m.name: int(m) for m in MsgType} == {
        m.name: int(m) for m in ref_protocol.MsgType}
    assert (protocol.MAGIC, protocol.PROTOCOL_VERSION, protocol.HEADER.format,
            protocol.MAX_PAYLOAD) == (
        ref_protocol.MAGIC, ref_protocol.PROTOCOL_VERSION,
        ref_protocol.HEADER.format, ref_protocol.MAX_PAYLOAD)


# ---------------------------------------------------------------------------
# The service
# ---------------------------------------------------------------------------

def test_reference_client_served_by_the_port(infer_server):
    """The reference's client against the port's server: every result is
    the port engine's, and STATS answers."""
    srv, snap, scfg = infer_server
    rng = np.random.default_rng(0)
    docs = [rng.integers(0, V_INF, size=int(rng.integers(2, LEN_INF + 1))
                         ).astype(np.int32) for _ in range(5)]
    want = FoldInEngine(snap, scfg, device=CPU).run(
        [InferRequest(uid=100 + i, tokens=d, seed=i)
         for i, d in enumerate(docs)])
    with RefClient(_addr(srv), timeout=SOCK_TIMEOUT * 4) as cli:
        for i, d in enumerate(docs):
            res = cli.infer(100 + i, d, seed=i)
            assert ref_checksum(res) == result_checksum(want[100 + i])
        stats = cli.stats()
    assert stats["served"] >= 5 and stats["batcher_alive"]
    assert stats["batcher_error"] is None


def test_concurrent_port_clients_match_the_engine(infer_server):
    srv, snap, scfg = infer_server
    reqs = [requests_for(c, vocab_size=V_INF, n_docs=4, max_len=LEN_INF,
                         corpus_seed=7, seed_base=1000) for c in range(3)]
    want = FoldInEngine(snap, scfg, device=CPU).run(
        [r for part in reqs for r in part])
    got: dict[int, str] = {}

    def client(part):
        with InferenceClient(_addr(srv), timeout=SOCK_TIMEOUT * 4) as cli:
            for r in part:
                got[r.uid] = result_checksum(cli.infer(r.uid, r.tokens,
                                                       seed=r.seed))

    threads = [threading.Thread(target=client, args=(p,)) for p in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert got == {uid: result_checksum(res) for uid, res in want.items()}


def test_load_shedding_keeps_the_connection():
    """``max_queue=1``: while the batcher is held, a second request is
    shed with an ``overloaded`` ERROR, the connection stays up, and the
    retry is served."""
    snap = _snapshot()
    scfg = ServeConfig(max_slots=1, max_len=LEN_INF, n_sweeps=2)
    srv = InferenceServer(snap, scfg, max_queue=1, device=CPU)
    gate = threading.Event()
    step = srv.engine.step

    def held_step():
        gate.wait(10.0)
        return step()

    srv.engine.step = held_step
    srv.start()
    try:
        first = {}
        t = threading.Thread(target=lambda: first.setdefault(
            "res", _infer_roundtrip(srv, uid=1)))
        t.start()
        deadline = time.monotonic() + 5.0
        while srv.engine.live == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.engine.live == 1
        with InferenceClient(_addr(srv), timeout=SOCK_TIMEOUT) as queued, \
                InferenceClient(_addr(srv), timeout=SOCK_TIMEOUT,
                                retries=0) as shed:
            queued._conn.send(MsgType.INFER, {"uid": 2, "seed": 0},
                              {"tokens": _good_doc()})
            while srv._queue.qsize() < 1 and time.monotonic() < deadline:
                time.sleep(0.01)
            with pytest.raises(ProtocolError, match="overloaded"):
                shed.infer(3, _good_doc(), seed=0)
            gate.set()
            _, meta, _ = queued._conn.recv(expect=(MsgType.INFER_RESULT,))
            assert meta["uid"] == 2
            assert shed.infer(3, _good_doc(), seed=0).uid == 3
        t.join(10.0)
        assert first["res"].uid == 1
        assert srv.stats()["shed"] == 1
    finally:
        gate.set()
        srv.close()


def test_batcher_failure_is_an_error_not_a_hang():
    snap = _snapshot()
    srv = InferenceServer(snap, ServeConfig(max_slots=2, max_len=LEN_INF,
                                            n_sweeps=2),
                          request_timeout=30.0, device=CPU)

    def broken_step():
        raise RuntimeError("kernel launch failed")

    srv.engine.step = broken_step
    srv.start()
    try:
        for uid in (1, 2):
            with pytest.raises(ProtocolError, match="batcher failed"):
                _infer_roundtrip(srv, uid=uid)
        stats = srv.stats()
        assert "kernel launch failed" in stats["batcher_error"]
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# INFER fuzz (tests/test_wire_protocol.py's cases) against the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frame_fn", [
    lambda: _infer_frame(meta={"seed": 0}),                  # no uid
    lambda: _infer_frame(meta={"uid": "seven", "seed": 0}),
    lambda: _infer_frame(meta={"uid": True, "seed": 0}),
    lambda: _infer_frame(meta={"uid": 1, "seed": "x"}),
    lambda: _infer_frame(arrays={}),                         # no tokens
    lambda: _infer_frame(arrays={"tokens": np.zeros((2, 3), np.int32)}),
    lambda: _infer_frame(arrays={"tokens": np.ones(4, np.float32)}),
    lambda: _infer_frame(arrays={"tokens": np.zeros(0, np.int32)}),
    lambda: _infer_frame(                                    # oversized doc
        arrays={"tokens": np.zeros(LEN_INF + 1, np.int32)}),
    lambda: _infer_frame(                                    # out-of-vocab
        arrays={"tokens": np.asarray([V_INF], np.int32)}),
], ids=["no-uid", "uid-str", "uid-bool", "seed-str", "no-tokens",
        "tokens-2d", "tokens-float", "tokens-empty", "oversized",
        "oov"])
def test_fuzz_infer_malformed_rejected_service_lives(infer_server,
                                                     frame_fn):
    srv, snap, scfg = infer_server
    sock = socket.create_connection(srv.address, timeout=SOCK_TIMEOUT)
    sock.settimeout(SOCK_TIMEOUT)
    try:
        sock.sendall(frame_fn())
        _expect_error_then_close(sock)
    finally:
        sock.close()
    res = _infer_roundtrip(srv)
    assert result_checksum(res) == result_checksum(
        _reference_result(snap, scfg))


def test_fuzz_infer_mid_payload_disconnect(infer_server):
    srv, snap, scfg = infer_server
    before = srv.stats()["protocol_errors"]
    sock = socket.create_connection(srv.address, timeout=SOCK_TIMEOUT)
    sock.settimeout(SOCK_TIMEOUT)
    try:
        sock.sendall(_infer_frame()[:protocol.HEADER_SIZE + 10])
    finally:
        sock.close()
    res = _infer_roundtrip(srv, uid=9, seed=5)
    assert result_checksum(res) == result_checksum(
        _reference_result(snap, scfg, uid=9, seed=5))
    deadline = time.monotonic() + SOCK_TIMEOUT
    while (srv.stats()["protocol_errors"] < before + 1
           and time.monotonic() < deadline):
        time.sleep(0.01)
    assert srv.stats()["protocol_errors"] >= before + 1


def test_fuzz_infer_garbage_header_service_lives(infer_server):
    srv, _, _ = infer_server
    sock = socket.create_connection(srv.address, timeout=SOCK_TIMEOUT)
    sock.settimeout(SOCK_TIMEOUT)
    try:
        sock.sendall(b"EVIL" + protocol.pack_frame(
            MsgType.INFER, {"uid": 1, "seed": 0},
            {"tokens": _good_doc()})[4:])
        _expect_error_then_close(sock)
    finally:
        sock.close()
    assert _infer_roundtrip(srv, uid=11).n_sweeps == 2


def test_infer_wrong_type_rejected(infer_server):
    srv, _, _ = infer_server
    sock = socket.create_connection(srv.address, timeout=SOCK_TIMEOUT)
    sock.settimeout(SOCK_TIMEOUT)
    try:
        sock.sendall(protocol.pack_frame(MsgType.PULL, {"round": 0}))
        _expect_error_then_close(sock)
    finally:
        sock.close()
    assert _infer_roundtrip(srv, uid=13).n_sweeps == 2


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launch_serve_client_processes_bit_exact(tmp_path):
    """Train, snapshot, serve from a server process on the CPU to 2
    client processes × 3 documents: every checksum equals the in-process
    engine's over the same checkpoint."""
    from repro_torch.serve import snapshot as snapshot_mod
    result, cfg = launch_serve_mod.launch_serve(
        vocab_size=64, n_topics=4, n_clients=2, n_docs=3, max_len=16,
        max_slots=4, n_sweeps=3, train_rounds=2, timeout=240.0,
        workdir=str(tmp_path), device=CPU)
    assert result.ok, [(p.name, p.stderr[-2000:]) for p in result.failures()]
    snap = snapshot_mod.from_checkpoint(str(tmp_path), cfg, device=CPU)
    reqs = [r for c in range(2) for r in requests_for(
        c, vocab_size=64, n_docs=3, max_len=16, corpus_seed=7,
        seed_base=1000)]
    want = FoldInEngine(snap, ServeConfig(max_slots=4, max_len=16,
                                          n_sweeps=3), device=CPU).run(reqs)
    got = {uid: sha for p in result.clients
           for uid, sha in p.result["checksums"].items()}
    assert got == {str(u): result_checksum(r) for u, r in want.items()}
    assert result.server_stats["served"] == 6
    assert result.server_stats["batcher_error"] is None
