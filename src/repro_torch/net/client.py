"""The sampler-machine side of the wire: :class:`RemoteParameterServer`
(port of ``repro.net.client``).

Implements the pull/push/project/snapshot surface of the in-process
:class:`repro_torch.core.server.ParameterServer` over one or more shard
servers (:class:`repro_torch.net.server.ShardServer`, or the reference's:
the frames are the same), so ``engine.Trainer`` drives either backend
through ``TrainerConfig(transport="inproc"|"tcp")``.

Arrays cross the wire as numpy.  The client converts at its edge: pulled
statistics become tensors on ``device`` (``cuda`` unless ``device="cpu"``
is passed), and pushed deltas become contiguous host arrays.

Assembly is the client's half of the bit-exactness argument: sharded
statistics arrive as exact row slices and are concatenated in row order
(no arithmetic); the aggregates (n_k, m_k, s_k) are then re-derived from
the assembled rows with the family's ``Aggregate`` tuples, the op the
in-process ``apply_delta`` and projection use, so a pulled snapshot is
bit for bit the statistics the in-process server would hand over.  Other
unsharded stats come from the row-0 server's merged aux.

The SSP read-my-writes lag rides at the trainer, not here: each local
client holds its own lag row (the server only sees post-filter pushes).
The server keeps the clocks and answers NOT_MODIFIED.

Fault tolerance: every RPC, mutations included, retries through a bounded
reconnect-with-backoff loop.  That is safe because the server dedups
mutations by (client, round): a retried PUSH whose first copy landed
returns the recorded ack instead of applying twice.  The client also keeps
a bounded replay buffer of its acked mutation frames (INIT plus the last
``REPLAY_WINDOW`` rounds of pushes, per server) and replays it,
``replay``-flagged, after every re-handshake, so a shard restarted from a
snapshot a few rounds back re-finalizes the missing rounds in the same
ascending-client order.  Only transport errors are retried; a peer ERROR
frame is a refusal and propagates at once.

The module is also the worker process (``python -m
repro_torch.net.client``) that :mod:`repro_torch.launch.loopback` starts:

* ``--mode train``: regenerate the synthetic corpus, run a
  ``Trainer(transport="tcp")`` over the given servers for the given global
  client ids, and write a result JSON (checksums of the final shared
  statistics, throughput, wire counters, the kernels this process
  launched);
* ``--mode stress``: no trainer; integer delta pushes and versioned pulls
  for N rounds, so the launcher can check the final state is exactly init
  + Σ deltas.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import time
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import family as family_mod
from repro_torch.core import server as server_mod
from repro_torch.net import protocol
from repro_torch.net import server as net_server
from repro_torch.net.protocol import MsgType, ProtocolError


class RemoteError(ProtocolError):
    """The server answered ERROR (application-level failure)."""


# Rounds of acked push frames kept for replay after a reconnect (INIT is
# kept unconditionally).  Must stay below the server's MUTLOG_WINDOW so
# every replayed frame either digest-matches the log or is fresh.
REPLAY_WINDOW = 8

# What a bounded retry may swallow: the transport failed, not the peer's
# semantics.  A peer ERROR frame surfaces as a plain ProtocolError.
_RETRYABLE = (protocol.TransportError, protocol.ConnectionClosed, OSError)

_BACKOFF_BASE_S = 0.05
_BACKOFF_CAP_S = 2.0


def _connect(addr: str, timeout: float) -> protocol.FramedConnection:
    host, _, port = addr.rpartition(":")
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    sock.settimeout(timeout)
    return protocol.FramedConnection(sock)


def _host(v) -> np.ndarray:
    """A host array of ``v`` (a tensor or array-like) that no later
    in-place write to ``v`` can change: the replay buffer keeps it."""
    if isinstance(v, torch.Tensor):
        v = v.detach()
        return v.numpy().copy() if v.device.type == "cpu" \
            else v.cpu().numpy()
    return np.asarray(v)


class RemoteParameterServer:
    """Client-side handle on a set of shard servers (one TCP connection
    per server), presenting the in-process server's API surface."""

    def __init__(self, addrs: Sequence[str], *, family, n_clients: int,
                 vocab_size: int, consistency: str = "bsp",
                 timeout: float = 60.0, sparse_push: bool = False,
                 reconnect_limit: int = 3,
                 local_clients: Sequence[int] | None = None, device=None):
        self.family = (family_mod.get(family) if isinstance(family, str)
                       else family)
        self.device = device_mod.resolve(device)
        self.n_clients = n_clients
        self.vocab_size = vocab_size
        self.policy = server_mod.make_consistency(consistency)
        self.timeout = timeout
        # Encode pushes as COO row-sliced PUSH_SPARSE frames; dense PUSH
        # is the reference encoding.
        self.sparse_push = sparse_push
        # Bounded re-dial budget for dropped connections on any RPC.
        self.reconnect_limit = reconnect_limit
        self.retries = 0
        self.reconnects = 0
        self._conns: list[protocol.FramedConnection] = []
        self._rows: list[tuple[int, int]] = []
        self._addrs: list[str] = []
        # Acked mutation frames per server, replayed after a reconnect:
        # (msg_type, meta, arrays, seq) with seq = round (-1 for INIT).
        self._replay: list[list[tuple]] = []
        self.project_every: int | None = None
        self._hello = {"family": self.family.name, "vocab_size": vocab_size,
                       "n_clients": n_clients,
                       "consistency": self.policy.key}
        if local_clients is not None:
            # Announced on HELLO: the server tracks which client ids a
            # connection serves, for barrier-eviction liveness.
            self._hello["clients"] = [int(c) for c in local_clients]
        pairs = []
        for addr in addrs:
            conn = _connect(addr, timeout)
            try:
                _, meta, _ = conn.request(MsgType.HELLO, self._hello,
                                          expect=(MsgType.WELCOME,))
            except ProtocolError as e:
                conn.close()
                for _a, c, _r in pairs:
                    c.close()
                raise RemoteError(f"handshake with {addr} failed: {e}") \
                    from e
            pairs.append((addr, conn, tuple(meta["rows"])))
            self.project_every = meta.get("project_every",
                                          self.project_every)
        # Servers sorted by row range; together they must tile [0, V).
        pairs.sort(key=lambda p: p[2][0])
        cursor = 0
        for addr, conn, (lo, hi) in pairs:
            if lo != cursor:
                for _a, c, _r in pairs:
                    c.close()
                raise RemoteError(
                    f"server row ranges do not tile the vocabulary: "
                    f"gap/overlap at row {cursor} (next range [{lo}, {hi}))")
            cursor = hi
            self._conns.append(conn)
            self._rows.append((lo, hi))
            self._addrs.append(addr)
        if cursor != vocab_size:
            self.close()
            raise RemoteError(f"server row ranges cover [0, {cursor}) "
                              f"but vocab_size={vocab_size}")
        self._replay = [[] for _ in self._conns]

    @property
    def n_servers(self) -> int:
        return len(self._conns)

    # ----------------------------------------------------------- plumbing
    def _split_rows(self, stats: dict[str, Any],
                    names: Sequence[str]) -> list[dict[str, np.ndarray]]:
        return [{n: _host(stats[n][lo:hi]) for n in names}
                for lo, hi in self._rows]

    def _dev(self, v: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(v)).to(self.device)

    def _assemble(self, metas: list[dict], parts: list[dict]):
        """Concatenate the row slices of each sharded stat on the device
        (exact), take unsharded aux from the row-0 server, re-derive the
        aggregates with the family's tuples (the in-process op order)."""
        sharded = tuple(metas[0]["sharded"])
        stats: dict[str, torch.Tensor] = {}
        for n in sharded:
            vs = [self._dev(p[n]) for p in parts]
            stats[n] = torch.cat(vs, 0) if len(vs) > 1 else vs[0]
        for n, v in parts[0].items():
            if n not in sharded:
                stats[n] = self._dev(v)
        for agg in self.family.aggregates:
            stats[agg.out] = stats[agg.src].sum(agg.axis)
        return self.family.shared_from_dict(stats)

    def _rpc(self, i: int, msg_type: MsgType, meta: dict,
             arrays: dict | None = None, *,
             expect: tuple[MsgType, ...]):
        """One RPC to server ``i`` with bounded retry-with-backoff.

        A transport failure burns one unit of the ``reconnect_limit``
        budget, sleeps an exponential backoff, re-dials, re-handshakes,
        replays the mutation buffer and resends.  Peer ERROR frames
        propagate at once."""
        failures = 0
        while True:
            try:
                return self._conns[i].request(msg_type, meta, arrays,
                                              expect=expect)
            except _RETRYABLE as e:
                failures += 1
                self.retries += 1
                if failures > self.reconnect_limit:
                    raise RemoteError(
                        f"{msg_type.name} to {self._addrs[i]} failed "
                        f"after {self.reconnect_limit} reconnect "
                        f"attempts: {e}") from e
                time.sleep(min(_BACKOFF_BASE_S * (2 ** (failures - 1)),
                               _BACKOFF_CAP_S))
                try:
                    self._reconnect(i)
                except _RETRYABLE:
                    # The server is still down: the next iteration fails
                    # fast on the dead connection and burns the budget.
                    pass

    def _request_all(self, msg_type: MsgType, metas: list[dict],
                     arrays_list: list[dict] | None = None, *,
                     expect: tuple[MsgType, ...]):
        out = []
        for i in range(len(self._conns)):
            arrays = None if arrays_list is None else arrays_list[i]
            out.append(self._rpc(i, msg_type, metas[i], arrays,
                                 expect=expect))
        return out

    def _buffer_mutation(self, i: int, msg_type: MsgType, meta: dict,
                         arrays: dict | None, seq: int) -> None:
        """Record an acked mutation for replay after a reconnect; prune
        pushes older than the replay window (INIT, seq -1, is kept)."""
        buf = self._replay[i]
        buf.append((msg_type, meta, arrays, seq))
        if seq >= 0:
            horizon = seq - REPLAY_WINDOW
            self._replay[i] = [e for e in buf
                               if e[3] < 0 or e[3] >= horizon]

    def _reconnect(self, i: int) -> None:
        """Re-dial server ``i``: fresh socket, fresh HELLO, a check that it
        still serves the same row range, then the replay of the buffered
        mutations.  Wire counters carry over."""
        old = self._conns[i]
        try:
            old.close()
        except OSError:
            pass
        conn = _connect(self._addrs[i], self.timeout)
        try:
            _, meta, _ = conn.request(MsgType.HELLO, self._hello,
                                      expect=(MsgType.WELCOME,))
        except (protocol.TransportError, protocol.ConnectionClosed):
            # A reset or clean close mid-handshake is the restart window:
            # retryable, not a refusal.
            conn.close()
            raise
        except ProtocolError as e:
            conn.close()
            raise RemoteError(
                f"re-handshake with {self._addrs[i]} failed: {e}") from e
        if tuple(meta["rows"]) != self._rows[i]:
            conn.close()
            raise RemoteError(
                f"server {self._addrs[i]} came back with row range "
                f"{tuple(meta['rows'])} (was {self._rows[i]})")
        conn.bytes_in += old.bytes_in
        conn.bytes_out += old.bytes_out
        conn.payload_in += old.payload_in
        conn.payload_out += old.payload_out
        conn.rpc_count += old.rpc_count
        conn.rpc_latency_s = old.rpc_latency_s + conn.rpc_latency_s
        self._conns[i] = conn
        self.reconnects += 1
        for mt, m, arrays, _seq in list(self._replay[i]):
            # Replay-flagged: an applied frame digest-matches the log, a
            # pruned or finalized one acks ignored, a missing one applies.
            conn.request(mt, {**m, "replay": True}, arrays,
                         expect=(MsgType.OK,))

    # ------------------------------------------------------------- protocol
    def init_push(self, client_id: int, shared) -> None:
        """Send one client's initial statistics (the servers merge all
        ``n_clients`` in ascending client id before serving a pull)."""
        stats = self.family.stats_dict(shared)
        sharded = net_server.sharded_stat_names(self.family, stats,
                                                self.vocab_size)
        aux = {n: _host(stats[n]) for n in stats if n not in sharded}
        arrays_list = []
        for part in self._split_rows(stats, sharded):
            part.update(aux)
            arrays_list.append(part)
        meta = {"client": int(client_id), "sharded": list(sharded)}
        for i in range(self.n_servers):
            self._rpc(i, MsgType.INIT, meta, arrays_list[i],
                      expect=(MsgType.OK,))
            self._buffer_mutation(i, MsgType.INIT, meta,
                                  arrays_list[i], -1)

    def pull(self, round_idx: int, cached_version: int | None = None
             ) -> tuple[Any, int, bool]:
        """Versioned cache refresh for ``round_idx``.

        Returns ``(shared, version, refreshed)``; ``shared`` is None when
        every server answered NOT_MODIFIED.  A split decision is a
        protocol violation: the policy predicate is deterministic."""
        meta = {"round": int(round_idx)}
        if cached_version is not None:
            meta["cached_version"] = int(cached_version)
        replies = [self._rpc(i, MsgType.PULL, meta,
                             expect=(MsgType.STATE, MsgType.NOT_MODIFIED))
                   for i in range(self.n_servers)]
        kinds = {mt for mt, _, _ in replies}
        if kinds == {MsgType.NOT_MODIFIED}:
            return None, int(cached_version), False
        if len(kinds) != 1:
            raise RemoteError("servers split on NOT_MODIFIED — "
                              "inconsistent staleness policies")
        metas = [m for _, m, _ in replies]
        parts = [a for _, _, a in replies]
        return self._assemble(metas, parts), int(metas[0]["version"]), True

    def pull_keys(self, names: Sequence[str] | None = None,
                  lo: int = 0, hi: int | None = None
                  ) -> dict[str, np.ndarray]:
        """Addressed row-range pull from the canonical store, as host
        arrays."""
        hi = self.vocab_size if hi is None else hi
        meta = {"lo": int(lo), "hi": int(hi)}
        if names is not None:
            meta["names"] = list(names)
        replies = self._request_all(MsgType.PULL_KEYS,
                                    [meta] * self.n_servers,
                                    expect=(MsgType.STATE,))
        out: dict[str, list[np.ndarray]] = {}
        for _, m, arrays in replies:
            if m["rows"][0] >= m["rows"][1]:
                continue
            for n, v in arrays.items():
                out.setdefault(n, []).append(v)
        return {n: (np.concatenate(vs, 0) if len(vs) > 1 else vs[0])
                for n, vs in out.items()}

    def push(self, round_idx: int, client_id: int,
             deltas: dict[str, Any]) -> None:
        """One client's delta frame for ``round_idx``, row-sliced per
        server (the server finalizes the round at the barrier).

        With ``sparse_push`` each row slice is COO-encoded: the rows that
        are non-zero in any statistic, found where the delta lives (the
        union: one index vector a frame, ``uint32``, strictly increasing)
        plus the packed (R, K) values per statistic.  The server scatters
        them into zeros and rides the dense barrier path, so the round
        total equals the dense push's bit for bit."""
        names = tuple(deltas)
        meta = {"round": int(round_idx), "client": int(client_id)}
        if not self.sparse_push:
            parts = self._split_rows(deltas, names)
            for i in range(self.n_servers):
                self._rpc(i, MsgType.PUSH, meta, parts[i],
                          expect=(MsgType.OK,))
                self._buffer_mutation(i, MsgType.PUSH, meta, parts[i],
                                      int(round_idx))
            return
        metas: list[dict] = []
        arrays_list: list[dict[str, np.ndarray]] = []
        ts = {n: torch.as_tensor(deltas[n]) for n in names}
        for lo, hi in self._rows:
            nz = None
            for n in names:
                v = ts[n][lo:hi]
                row_any = (v != 0).reshape(v.shape[0], -1).any(1)
                nz = row_any if nz is None else (nz | row_any)
            idx = torch.nonzero(nz).squeeze(1)
            arrays = {"rows": _host(idx).astype(np.uint32)}
            arrays.update({n: _host(ts[n][lo:hi][idx]) for n in names})
            metas.append({**meta, "n_rows": int(hi - lo),
                          "sparse": list(names)})
            arrays_list.append(arrays)
        for i in range(self.n_servers):
            self._rpc(i, MsgType.PUSH_SPARSE, metas[i], arrays_list[i],
                      expect=(MsgType.OK,))
            self._buffer_mutation(i, MsgType.PUSH_SPARSE, metas[i],
                                  arrays_list[i], int(round_idx))

    def push_ghost(self, round_idx: int, client_id: int) -> None:
        """Fill the client's barrier slot for ``round_idx`` with no delta
        and no clock tick: how a simulated fault (crash, straggle, lost
        push) rides the wire, bit-exact with the in-process masks."""
        meta = {"round": int(round_idx), "client": int(client_id),
                "ghost": True}
        for i in range(self.n_servers):
            self._rpc(i, MsgType.PUSH, meta, None, expect=(MsgType.OK,))
            self._buffer_mutation(i, MsgType.PUSH, meta, None,
                                  int(round_idx))

    def project(self) -> None:
        self._request_all(MsgType.PROJECT, [{}] * self.n_servers,
                          expect=(MsgType.OK,))

    def snapshot(self, min_round: int = 0):
        """The canonical assembled statistics once every round below
        ``min_round`` has been finalized."""
        meta = {"min_round": int(min_round)}
        replies = self._request_all(MsgType.SNAPSHOT,
                                    [meta] * self.n_servers,
                                    expect=(MsgType.STATE,))
        return self._assemble([m for _, m, _ in replies],
                              [a for _, _, a in replies])

    def clock(self, min_round: int | None = None
              ) -> tuple[int, np.ndarray]:
        """(min server round across shards, per-client clocks).  With
        ``min_round``, blocks until every shard has finalized it."""
        meta = {} if min_round is None else {"min_round": int(min_round)}
        replies = self._request_all(MsgType.CLOCK, [meta] * self.n_servers,
                                    expect=(MsgType.OK,))
        rounds = [m["server_round"] for _, m, _ in replies]
        return min(rounds), np.asarray(replies[0][1]["clocks"])

    def rejoin(self, client_id: int) -> None:
        """Elastic rejoin: clear the client's pending pushes and open
        mutation-log entries at the servers, and lift any eviction."""
        self._request_all(MsgType.REJOIN,
                          [{"client": int(client_id)}] * self.n_servers,
                          expect=(MsgType.OK,))
        # Frames of the dead incarnation must not resurface on the next
        # reconnect and digest-conflict with the fresh ones.
        for buf in self._replay:
            buf[:] = [e for e in buf
                      if e[3] < 0 or int(e[1].get("client", -2))
                      != int(client_id)]

    def leave(self, client_id: int) -> None:
        """Voluntary leave: the barrier stops requiring the client at once
        and its clock freezes until a rejoin."""
        self._request_all(
            MsgType.REJOIN,
            [{"client": int(client_id), "action": "leave"}]
            * self.n_servers, expect=(MsgType.OK,))

    def snapshot_write(self, directory: str,
                       step: int | None = None) -> list[dict[str, Any]]:
        """Ask every shard to persist its state (SNAPSHOT_WRITE); returns
        the per-shard {step, name, path} acks."""
        meta: dict[str, Any] = {"directory": directory}
        if step is not None:
            meta["step"] = int(step)
        return [m for _, m, _ in self._request_all(
            MsgType.SNAPSHOT_WRITE, [meta] * self.n_servers,
            expect=(MsgType.OK,))]

    def snapshot_restore(self, directory: str,
                         step: int | None = None) -> list[int]:
        """Ask every shard to reload from its snapshot (SNAPSHOT_RESTORE);
        returns the per-shard restored rounds."""
        meta: dict[str, Any] = {"directory": directory}
        if step is not None:
            meta["step"] = int(step)
        return [int(m["server_round"]) for _, m, _ in self._request_all(
            MsgType.SNAPSHOT_RESTORE, [meta] * self.n_servers,
            expect=(MsgType.OK,))]

    def server_stats(self) -> list[dict[str, Any]]:
        return [m for _, m, _ in self._request_all(
            MsgType.STATS, [{}] * self.n_servers, expect=(MsgType.OK,))]

    def shutdown_servers(self) -> None:
        for conn in self._conns:
            try:
                conn.request(MsgType.SHUTDOWN, {}, expect=(MsgType.OK,))
            except (ProtocolError, OSError):
                pass

    # ----------------------------------------------------------- counters
    def counters(self) -> dict[str, Any]:
        """Aggregated per-connection wire counters (bytes in/out, RPC
        count, p50/p99 RPC latency)."""
        per = [c.counters() for c in self._conns]
        lat = sorted(x for c in self._conns for x in c.rpc_latency_s)

        def pct(p: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1,
                           int(round(p * (len(lat) - 1))))] * 1e3

        return {
            "bytes_in": sum(c["bytes_in"] for c in per),
            "bytes_out": sum(c["bytes_out"] for c in per),
            "payload_in": sum(c["payload_in"] for c in per),
            "payload_out": sum(c["payload_out"] for c in per),
            "rpc_count": sum(c["rpc_count"] for c in per),
            "rpc_p50_ms": pct(0.50),
            "rpc_p99_ms": pct(0.99),
            "retries": self.retries,
            "reconnects": self.reconnects,
            "per_connection": per,
        }

    def close(self) -> None:
        for conn in self._conns:
            conn.close()
        self._conns = []

    def __enter__(self) -> "RemoteParameterServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Process entry point (repro_torch.launch.loopback workers)
# ---------------------------------------------------------------------------

def _checksum(arr) -> str:
    return hashlib.sha256(np.ascontiguousarray(_host(arr)).tobytes()
                          ).hexdigest()


def stress_delta(round_idx: int, client_id: int, shape: tuple[int, int]
                 ) -> np.ndarray:
    """Deterministic integer-valued delta for the stress harness (the
    reference's): the launcher recomputes Σ over (round, client) and
    checks the final store equals init + Σ exactly."""
    v, k = shape
    base = (round_idx * 131 + client_id * 17) % 7 + 1
    col = (np.arange(v, dtype=np.float32)[:, None]
           + np.arange(k, dtype=np.float32)[None, :])
    return np.float32(base) + (col % 3)


def _run_train(args) -> dict[str, Any]:
    from repro_torch.core import lda, pdp
    from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
    from repro_torch.engine.trainer import Trainer, TrainerConfig
    from repro_torch.kernels import _build

    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=args.corpus_topics or args.n_topics,
        vocab_size=args.vocab_size, n_docs=args.n_docs,
        doc_len=args.doc_len, seed=args.corpus_seed))
    if args.family == "lda":
        cfg = lda.LDAConfig(n_topics=args.n_topics,
                            vocab_size=args.vocab_size)
    elif args.family == "pdp":
        cfg = pdp.PDPConfig(n_topics=args.n_topics,
                            vocab_size=args.vocab_size)
    else:
        raise SystemExit(f"unsupported family for the wire: {args.family}")
    clients = tuple(int(c) for c in args.clients.split(","))
    tcfg = TrainerConfig(
        n_clients=args.n_clients, tau=args.tau, layout=args.layout,
        consistency=args.consistency, project_every=args.project_every,
        transport="tcp", server_addrs=tuple(args.addrs.split(",")),
        local_clients=clients, reconnect_limit=args.reconnect_limit,
        snapshot_every=args.snapshot_every,
        snapshot_dir=args.snapshot_dir)
    if args.restore:
        # Worker restart: rebuild from the latest local snapshot and resume
        # at the recorded round; the servers' barrier has been waiting for
        # this client's missing pushes.
        trainer = Trainer.restore(cfg, tokens, mask, config=tcfg,
                                  seed=args.seed, device=args.device)
    else:
        trainer = Trainer(cfg, tokens, mask, config=tcfg, seed=args.seed,
                          device=args.device)
    t0 = time.perf_counter()
    rounds_done = 0
    while trainer.round_idx < args.n_rounds:
        trainer.step()
        rounds_done += 1
        if args.die_after_round is not None \
                and trainer.round_idx >= args.die_after_round:
            # Deterministic kill point: step() wrote the round-N snapshot
            # before we get here, so the relaunched --restore incarnation
            # resumes at exactly N.
            print(f"DYING round {trainer.round_idx}", flush=True)
            os._exit(42)
    trainer._sync()
    dt = time.perf_counter() - t0
    stats = trainer.family.stats_dict(trainer.shared)
    n_eval = args.eval_docs or trainer.tokens.shape[0]
    result = {
        "mode": "train",
        "clients": list(clients),
        "rounds": args.n_rounds,
        "rounds_done": rounds_done,
        "restored": bool(args.restore),
        "rounds_per_s": rounds_done / max(dt, 1e-9),
        "checksums": {n: _checksum(v) for n, v in stats.items()},
        "sums": {n: float(v.double().sum()) for n, v in stats.items()},
        "perplexity": trainer.perplexity(trainer.tokens[:n_eval],
                                         trainer.mask[:n_eval]),
        "counters": trainer.remote.counters(),
        "launches": {n: c for n, c in _build.LAUNCHES.items() if c},
        "device": str(trainer.device),
    }
    trainer.close()
    return result


def _run_stress(args) -> dict[str, Any]:
    clients = tuple(int(c) for c in args.clients.split(","))
    fam = family_mod.get(args.family)
    remote = RemoteParameterServer(
        args.addrs.split(","), family=fam, n_clients=args.n_clients,
        vocab_size=args.vocab_size, consistency=args.consistency,
        timeout=args.timeout, device=args.device)
    shape = (args.vocab_size, args.n_topics)
    zero = {n: np.zeros(shape, np.float32) for n in fam.delta_names}
    aggs = {a.out for a in fam.aggregates}
    init_stats = dict(zero)
    for n in fam.shared_stats:
        if n not in init_stats and n in aggs:
            init_stats[n] = np.zeros((args.n_topics,), np.float32)
    for c in clients:
        remote.init_push(c, fam.shared_from_dict(init_stats))
    version: int | None = None
    for r in range(args.n_rounds):
        _shared, v, refreshed = remote.pull(r, version)
        if refreshed:
            version = v
        for c in clients:
            d = stress_delta(r, c, shape)
            remote.push(r, c, {n: d for n in fam.delta_names})
    sr, _clocks = remote.clock(min_round=args.n_rounds)
    final = remote.pull_keys(list(fam.delta_names))
    result = {
        "mode": "stress",
        "clients": list(clients),
        "rounds": args.n_rounds,
        "server_round": sr,
        "checksums": {n: _checksum(v) for n, v in final.items()},
        "sums": {n: float(v.sum()) for n, v in final.items()},
        "counters": remote.counters(),
    }
    remote.close()
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="parameter-server client process (repro_torch.net)")
    ap.add_argument("--mode", choices=("train", "stress"), default="train")
    ap.add_argument("--addrs", required=True,
                    help="comma-separated host:port shard servers")
    ap.add_argument("--clients", required=True,
                    help="comma-separated global client ids this process "
                         "owns")
    ap.add_argument("--family", default="lda")
    ap.add_argument("--vocab-size", type=int, default=64)
    ap.add_argument("--n-topics", type=int, default=4)
    ap.add_argument("--corpus-topics", type=int, default=None,
                    help="topics of the synthetic corpus (default: "
                         "--n-topics)")
    ap.add_argument("--n-clients", type=int, default=2)
    ap.add_argument("--n-rounds", type=int, default=4)
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--layout", default="scan")
    ap.add_argument("--consistency", default="bsp")
    ap.add_argument("--project-every", type=int, default=1)
    ap.add_argument("--n-docs", type=int, default=16)
    ap.add_argument("--doc-len", type=int, default=12)
    ap.add_argument("--corpus-seed", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--reconnect-limit", type=int, default=3,
                    help="bounded retry budget per RPC (each unit is one "
                         "reconnect attempt with exponential backoff)")
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--snapshot-every", type=int, default=0)
    ap.add_argument("--restore", action="store_true",
                    help="resume from the latest snapshot in "
                         "--snapshot-dir (worker restart)")
    ap.add_argument("--die-after-round", type=int, default=None,
                    help="exit(42) after completing this round "
                         "(deterministic kill point for failover tests)")
    ap.add_argument("--eval-docs", type=int, default=0,
                    help="documents of the final perplexity (0 = all)")
    ap.add_argument("--device", default="cuda",
                    help="where the trainer runs: cuda (default) or cpu")
    ap.add_argument("--out", default=None, help="result JSON path")
    args = ap.parse_args(argv)

    result = _run_train(args) if args.mode == "train" else _run_stress(args)
    payload = json.dumps(result, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
    print(payload, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
