"""The parameter-server process role (port of ``repro.net.server``).

A :class:`ShardServer` hosts one contiguous vocabulary row-range
``[row_lo, row_hi)`` of the shared sufficient statistics over TCP,
speaking :mod:`repro_torch.net.protocol` (frames byte-compatible with the
reference's, so either package's client talks to either package's
server).  ``serve_shards`` stands up the ``n_shards`` row-range servers of
a :class:`repro_torch.core.server.ShardSpec` partition in one process (one
listener, and one handler thread per connection, each).

The store lives on ``device`` (``cuda`` unless ``device="cpu"`` is
passed, :mod:`repro_torch.device`): a (V, K) add is a fraction of a
millisecond on the card.  Frames are still encoded and decoded on the
host, so an array crosses the host-device boundary once per frame:
decoded arrays move to the device when a mutation is applied, and a pull
copies the store's slices back to the host.

Bit-exactness with the in-process
:class:`~repro_torch.core.server.ParameterServer` is the design
constraint; the store mirrors the in-process arithmetic exactly:

* the canonical store is the plain dict of row-sliced sharded statistics
  (``n_wk[lo:hi]``, …); every mutation is elementwise, and elementwise
  ops on a row slice equal the same ops on the dense array restricted to
  those rows, so any shard count is bit-exact with the dense statistics;
* INIT merges per-client initial statistics in **ascending client id**
  (fold-left), the order of ``Trainer._merge_shared``;
* pushes buffer per ``(round, client)`` and a round finalizes only when
  all ``n_clients`` deltas are present (the BSP barrier); the round total
  is summed in ascending client order, then applied once;
* projection applies the family's elementwise shared rules
  (:mod:`repro_torch.core.projection`) to the row slices on the
  ``project_every`` cadence, right after the round's push; aggregates
  (n_k, m_k, s_k) are **never** stored here: clients re-derive them from
  the assembled rows.

Consistency policies map onto the wire: a PULL carries the client's
cached version and the server answers NOT_MODIFIED when
``policy.needs_refresh(round, version)`` is False (SSP's versioned stale
cache); a refreshing PULL blocks until the barrier has finalized every
earlier round; async pushes apply immediately in arrival order and async
pulls never block.  Per-client clocks live here; the read-my-writes lag
rides at the client edge (the server only sees post-filter deltas).

Failure containment: a malformed frame raises
:class:`~repro_torch.net.protocol.ProtocolError` inside that connection's
handler thread, which sends a best-effort ERROR frame and closes that
connection only; the store is mutated only after a frame fully decodes,
and only under the server lock.  Blocking waits (barrier pulls,
SNAPSHOT/CLOCK with ``min_round``) are bounded by ``barrier_timeout``
and answer ERROR instead of hanging.

Fault tolerance:

* **idempotent mutation replay**: every PUSH/PUSH_SPARSE/INIT is keyed
  ``(client, seq)`` with ``seq = round`` for pushes and ``-1`` for INIT.
  A bounded mutation log keeps ``(content digest, recorded reply)`` per
  key; a replayed frame whose digest matches returns the recorded ack
  without touching the store, a same-key frame with different content is
  an error, and a replay-flagged frame for a pruned or finalized round
  acks ``{"ignored": true}``;
* **shard snapshot/restore**: the full barrier state (store, aux, pending
  deltas, ghost markers, clocks, round, eviction set, mutation log)
  persists through :mod:`repro_torch.checkpoint.ckpt`, in the reference's
  leaf names, on a round cadence and on SNAPSHOT_WRITE; a restarted shard
  restores it (SNAPSHOT_RESTORE or ``--restore``) and resumes mid-run;
* **barrier eviction**: handler sockets carry timeouts and SO_KEEPALIVE; a
  client whose every connection is gone becomes a suspect and, past the
  liveness deadline, is evicted from the round barrier (rounds finalize
  from the remaining contributors, its clock freezes).  Any later frame
  from the client un-evicts it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import socket
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint import ckpt
from repro_torch.core import family as family_mod
from repro_torch.core import projection
from repro_torch.core import server as server_mod
from repro_torch.net import protocol
from repro_torch.net.protocol import MsgType, ProtocolError


def sharded_stat_names(family, stats: dict[str, Any],
                       vocab_size: int) -> tuple[str, ...]:
    """The statistics the wire row-shards: 2-D with a leading vocabulary
    dimension (the predicate of ``ParameterServer._is_sharded``), for numpy
    arrays and tensors alike."""
    return tuple(n for n, v in stats.items()
                 if len(v.shape) == 2 and v.shape[0] == vocab_size)


class _BarrierTimeout(RuntimeError):
    """A bounded server-side wait expired (slow or dead peer)."""


# Finalized rounds whose mutation-log entries are kept for replay dedup;
# older entries answer ``ignored`` to replay-flagged frames.  Must cover
# the client replay window (client.REPLAY_WINDOW) with slack.
MUTLOG_WINDOW = 64

_GHOST_DIGEST = "__ghost__"


def mutation_digest(deltas: dict[str, np.ndarray] | None) -> str:
    """Content digest of a mutation's host arrays, the reference's: names,
    shapes, dtypes and raw bytes, so a replayed frame is accepted iff it
    is byte-identical to the recorded application."""
    if deltas is None:
        return _GHOST_DIGEST
    h = hashlib.sha256()
    for n in sorted(deltas):
        v = np.ascontiguousarray(deltas[n])
        h.update(n.encode())
        h.update(str(v.shape).encode())
        h.update(v.dtype.str.encode())
        h.update(v.tobytes())
    return h.hexdigest()


def _host(v: torch.Tensor) -> np.ndarray:
    return v.detach().cpu().numpy()


class ShardServer:
    """One row-range shard of the parameter server, served over TCP.

    The server needs the family only for its stat names, merge rules and
    elementwise projection rules, never for sampling or evaluation."""

    def __init__(self, family_name: str, *, vocab_size: int,
                 n_clients: int, rows: tuple[int, int] | None = None,
                 consistency: str = "bsp", project_every: int = 1,
                 host: str = "127.0.0.1", port: int = 0,
                 barrier_timeout: float = 60.0,
                 liveness_timeout: float = 15.0,
                 snapshot_dir: str | None = None,
                 snapshot_every: int = 0,
                 snapshot_name: str = "shard", device=None):
        self.family = family_mod.get(family_name)
        if type(self.family).post_round is not family_mod.ModelFamily.post_round:
            raise NotImplementedError(
                f"family {family_name!r} overrides post_round (cross-client "
                "auxiliary resampling needs every client's locals at the "
                "barrier) — not servable over the wire; use the in-process "
                "transport")
        self.device = device_mod.resolve(device)
        self.family_name = family_name
        self.vocab_size = vocab_size
        self.n_clients = n_clients
        self.rows = (0, vocab_size) if rows is None else (int(rows[0]),
                                                          int(rows[1]))
        if not 0 <= self.rows[0] < self.rows[1] <= vocab_size:
            raise ValueError(f"bad row range {self.rows} for V={vocab_size}")
        self.policy = server_mod.make_consistency(consistency)
        self.project_every = project_every
        self.barrier_timeout = barrier_timeout
        self.liveness_timeout = liveness_timeout
        self.snapshot_dir = snapshot_dir
        self.snapshot_every = int(snapshot_every)
        # Stable per-shard snapshot name: a restarted process serving the
        # same row range finds its own files.
        self._snap_name = f"{snapshot_name}-{self.rows[0]}-{self.rows[1]}"

        self._cond = threading.Condition()
        # Canonical row-sliced store and unsharded aux (merged at INIT,
        # served verbatim; clients re-derive the aggregates), on device.
        self._store: dict[str, torch.Tensor] | None = None
        self._aux: dict[str, torch.Tensor] = {}
        self._sharded: tuple[str, ...] = ()
        self._init_parts: dict[int, tuple[dict, dict]] = {}
        self._pending: dict[int, dict[int, dict[str, torch.Tensor] | None]] = {}
        self._round = 0
        self._clocks = np.zeros((n_clients,), np.int64)
        # The shared rules whose operands are all row-sharded: the only
        # ones a row range can apply locally.
        self._rules: tuple[projection.Rule, ...] = ()
        # Idempotency: (client, seq) -> (content digest, recorded reply).
        # Pending slots may hold None: a ghost push (no delta, no clock).
        self._mutlog: dict[tuple[int, int], tuple[str, dict]] = {}
        # Liveness: client -> eviction deadline while every connection
        # that served it is gone; past it the client moves to _evicted.
        self._suspects: dict[int, float] = {}
        self._evicted: set[int] = set()
        self._evictions = 0
        self._live_conns: dict[int, set[int]] = {}
        self._conn_seq = 0
        self._snapshots_written = 0
        self._stop = False
        self._protocol_errors = 0
        self._latency_s: list[float] = []
        self._conn_counters: list[dict[str, Any]] = []
        self._threads: list[threading.Thread] = []

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(max(16, 2 * n_clients))
        self.address: tuple[str, int] = self._listener.getsockname()[:2]
        self._accept_thread: threading.Thread | None = None

    def _dev(self, v: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(v)).to(self.device)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ShardServer":
        t = threading.Thread(target=self._accept_loop,
                             name=f"shard-accept-{self.address[1]}",
                             daemon=True)
        t.start()
        self._accept_thread = t
        return self

    def close(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)

    def __enter__(self) -> "ShardServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- accept/IO
    def _accept_loop(self) -> None:
        self._listener.settimeout(0.2)
        while not self._stop:
            try:
                sock, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve_conn, args=(sock,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _serve_conn(self, sock: socket.socket) -> None:
        # Per-socket timeout and keepalive: a dead or half-open peer
        # surfaces as a transport error within the liveness deadline.
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        except OSError:
            pass
        sock.settimeout(min(1.0, max(self.liveness_timeout, 0.05)))
        conn = protocol.FramedConnection(sock)
        clients: set[int] = set()
        with self._cond:
            self._conn_seq += 1
            conn_id = self._conn_seq
            self._live_conns[conn_id] = clients
        try:
            while not self._stop:
                try:
                    mt, meta, arrays = conn.recv()
                except protocol.IdleTimeout:
                    # An idle peer is normal; the tick runs the liveness
                    # sweep for everyone else's dead clients.
                    with self._cond:
                        self._sweep_liveness_locked()
                    continue
                except protocol.ConnectionClosed:
                    break
                except protocol.TransportError as e:
                    raise ProtocolError(
                        f"shard rows {list(self.rows)} lost the connection "
                        f"serving clients {sorted(clients)}: {e}") from e
                self._note_clients(clients, meta)
                t0 = time.perf_counter()
                try:
                    reply = self._dispatch(mt, meta, arrays)
                except _BarrierTimeout as e:
                    conn.send(MsgType.ERROR, {"error": str(e)})
                    continue
                except (KeyError, ValueError, TypeError,
                        NotImplementedError) as e:
                    # Well-framed but semantically bad request: tell the
                    # peer why, then drop it.
                    conn.send(MsgType.ERROR,
                              {"error": f"{type(e).__name__}: {e}"})
                    break
                conn.send(*reply)
                with self._cond:
                    self._latency_s.append(time.perf_counter() - t0)
                if mt is MsgType.SHUTDOWN:
                    with self._cond:
                        self._stop = True
                        self._cond.notify_all()
                    break
        except ProtocolError as e:
            # Malformed frame or dead transport: the store was never
            # touched, so only this connection dies.
            with self._cond:
                self._protocol_errors += 1
            try:
                conn.send(MsgType.ERROR, {"error": str(e)})
            except OSError:
                pass
        finally:
            with self._cond:
                self._live_conns.pop(conn_id, None)
                self._mark_suspects_locked(clients)
                self._conn_counters.append(conn.counters())
            conn.close()

    def _note_clients(self, clients: set[int], meta: dict) -> None:
        """Record which client ids this connection serves (HELLO sends the
        list, mutations name one) and clear their suspect or evicted
        status: any frame from a client proves it is alive."""
        fresh: set[int] = set()
        announced = meta.get("clients")
        if isinstance(announced, (list, tuple)):
            for x in announced:
                try:
                    fresh.add(int(x))
                except (TypeError, ValueError):
                    pass
        if "client" in meta:
            try:
                fresh.add(int(meta["client"]))
            except (TypeError, ValueError):
                pass
        if not fresh:
            return
        clients.update(fresh)
        with self._cond:
            revived = False
            for c in fresh:
                self._suspects.pop(c, None)
                if c in self._evicted:
                    self._evicted.discard(c)
                    revived = True
            if revived:
                self._cond.notify_all()

    # ----------------------------------------------------------- liveness
    def _mark_suspects_locked(self, clients: set[int]) -> None:
        """A connection died: its clients become eviction suspects unless
        another live connection still serves them."""
        still: set[int] = set()
        for s in self._live_conns.values():
            still |= s
        now = time.monotonic()
        for c in clients:
            if c in still or c in self._evicted:
                continue
            self._suspects.setdefault(c, now + self.liveness_timeout)

    def _sweep_liveness_locked(self) -> None:
        """Evict suspects past their deadline: the barrier stops requiring
        them and their clocks freeze."""
        if not self._suspects:
            return
        now = time.monotonic()
        expired = [c for c, dl in self._suspects.items() if now >= dl]
        if not expired:
            return
        for c in expired:
            del self._suspects[c]
            self._evicted.add(c)
            self._evictions += 1
        if self._store is not None:
            self._advance_locked()
        self._cond.notify_all()

    # ------------------------------------------------------------ dispatch
    def _dispatch(self, mt: MsgType, meta: dict, arrays: dict):
        if mt is MsgType.HELLO:
            return self._on_hello(meta)
        if mt is MsgType.INIT:
            return self._on_init(meta, arrays)
        if mt is MsgType.PULL:
            return self._on_pull(meta)
        if mt is MsgType.PULL_KEYS:
            return self._on_pull_keys(meta)
        if mt is MsgType.PUSH:
            return self._on_push(meta, arrays)
        if mt is MsgType.PUSH_SPARSE:
            return self._on_push_sparse(meta, arrays)
        if mt is MsgType.PROJECT:
            with self._cond:
                self._require_store()
                self._project_locked()
            return MsgType.OK, {"server_round": self._round}, None
        if mt is MsgType.SNAPSHOT:
            return self._on_snapshot(meta)
        if mt is MsgType.SNAPSHOT_WRITE:
            return self._on_snapshot_write(meta)
        if mt is MsgType.SNAPSHOT_RESTORE:
            return self._on_snapshot_restore(meta)
        if mt is MsgType.CLOCK:
            return self._on_clock(meta)
        if mt is MsgType.REJOIN:
            return self._on_rejoin(meta)
        if mt is MsgType.STATS:
            return MsgType.OK, self.stats(), None
        if mt is MsgType.SHUTDOWN:
            return MsgType.OK, {"server_round": self._round}, None
        raise ValueError(f"message type {mt.name} is not a request")

    def _on_hello(self, meta: dict):
        for field, mine in (("family", self.family_name),
                            ("vocab_size", self.vocab_size),
                            ("n_clients", self.n_clients),
                            ("consistency", self.policy.key)):
            theirs = meta.get(field)
            if theirs != mine:
                raise ValueError(
                    f"handshake mismatch on {field}: client says "
                    f"{theirs!r}, server has {mine!r}")
        return MsgType.WELCOME, {
            "rows": list(self.rows),
            "vocab_size": self.vocab_size,
            "n_clients": self.n_clients,
            "consistency": self.policy.key,
            "project_every": self.project_every,
            "server_round": self._round,
        }, None

    def _on_init(self, meta: dict, arrays: dict):
        c = int(meta["client"])
        if not 0 <= c < self.n_clients:
            raise ValueError(f"client id {c} out of range")
        sharded = tuple(meta["sharded"])
        lo, hi = self.rows
        part = {n: arrays[n] for n in sharded}
        for n, v in part.items():
            if v.ndim != 2 or v.shape[0] != hi - lo:
                raise ValueError(
                    f"INIT stat {n!r} has shape {v.shape}; this server "
                    f"owns rows [{lo}, {hi}) and expects ({hi - lo}, K)")
        aux = {n: arrays[n] for n in arrays if n not in sharded}
        digest = mutation_digest(dict(arrays))
        with self._cond:
            rec = self._mutlog.get((c, -1))
            if rec is not None:
                if rec[0] == digest:
                    # Idempotent replay of an applied INIT: recorded reply.
                    return MsgType.OK, dict(rec[1]), None
                raise ValueError(
                    f"conflicting INIT replay for client {c}: same "
                    "sequence, different content digest")
            if self._store is not None:
                if meta.get("replay"):
                    # Sealed by a snapshot restore that did not carry the
                    # log entry: the INIT is already in the restored store.
                    return MsgType.OK, {"server_round": self._round,
                                        "client": c, "ignored": True}, None
                raise ValueError("INIT after the store was sealed")
            if self._sharded and self._sharded != sharded:
                raise ValueError(f"INIT sharded-name mismatch: {sharded} "
                                 f"vs {self._sharded}")
            self._sharded = sharded
            self._init_parts[c] = ({n: self._dev(v) for n, v in part.items()},
                                   {n: self._dev(v) for n, v in aux.items()})
            if len(self._init_parts) == self.n_clients:
                self._seal_store_locked()
                self._cond.notify_all()
            reply = {"server_round": self._round,
                     "initialized": self._store is not None, "client": c}
            self._mutlog[(c, -1)] = (digest, reply)
        return MsgType.OK, dict(reply), None

    def _seal_store_locked(self) -> None:
        """Merge the per-client initial statistics in ascending client id
        (fold-left, replicated stats from the lowest id): the op order of
        ``Trainer._merge_shared``."""
        cids = sorted(self._init_parts)
        store, aux = self._init_parts[cids[0]]
        store, aux = dict(store), dict(aux)
        for c in cids[1:]:
            part, auxc = self._init_parts[c]
            for n in store:
                store[n] = store[n] + part[n]
            for n in aux:
                if n in self.family.replicated_stats or aux[n].dim() == 0:
                    continue
                aux[n] = aux[n] + auxc[n]
        self._store, self._aux = store, aux
        self._init_parts.clear()
        self._resolve_rules_locked()

    def _resolve_rules_locked(self) -> None:
        names = set(self._sharded)
        self._rules = tuple(
            r for r in self.family.shared_rules
            if {r.a} | ({r.b} if r.b else set()) <= names)

    def _require_store(self) -> None:
        if self._store is None:
            self._wait_locked(lambda: self._store is not None,
                              "store initialization (INIT barrier)")

    def _wait_locked(self, pred, what: str) -> None:
        deadline = time.monotonic() + self.barrier_timeout
        while not pred():
            if self._stop:
                raise _BarrierTimeout("server is shutting down")
            # A short tick: a waiter also runs the liveness sweep, so a
            # barrier stalled by a dead client resolves at the eviction
            # deadline, not at barrier_timeout.
            self._sweep_liveness_locked()
            if pred():
                return
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise _BarrierTimeout(
                    f"timed out after {self.barrier_timeout:.1f}s waiting "
                    f"for {what} (server at round {self._round})")
            self._cond.wait(timeout=min(remaining, 0.25))

    def _state_arrays_locked(self) -> dict[str, np.ndarray]:
        """The store and aux as host arrays (one device-to-host copy)."""
        arrays = {n: _host(v) for n, v in self._store.items()}
        arrays.update({n: _host(v) for n, v in self._aux.items()})
        return arrays

    def _on_pull(self, meta: dict):
        r = int(meta["round"])
        version = meta.get("cached_version")
        with self._cond:
            if self.policy.caches and version is not None \
                    and not self.policy.needs_refresh(r, int(version)):
                # The cached version is within the staleness bound: no
                # wait, no payload (SSP's fast path).
                return MsgType.NOT_MODIFIED, {
                    "version": int(version), "server_round": self._round}, None
            self._require_store()
            if not self.policy.immediate:
                # Barrier: a refreshing pull for round r sees every round
                # < r applied (a client pulls r before pushing r).
                self._wait_locked(lambda: self._round >= r,
                                  f"round barrier {r}")
            return MsgType.STATE, {
                "version": r, "server_round": self._round,
                "sharded": list(self._sharded), "rows": list(self.rows),
            }, self._state_arrays_locked()

    def _on_pull_keys(self, meta: dict):
        with self._cond:
            self._require_store()
            names = meta.get("names") or list(self._sharded)
            lo, hi = self.rows
            glo = int(meta.get("lo", lo))
            ghi = int(meta.get("hi", hi))
            clo, chi = max(glo, lo), min(ghi, hi)
            if clo >= chi:
                arrays = {}
            else:
                arrays = {n: _host(self._store[n][clo - lo:chi - lo])
                          for n in names}
            return MsgType.STATE, {
                "version": self._round, "server_round": self._round,
                "rows": [clo, chi], "sharded": list(names)}, arrays

    def _on_push(self, meta: dict, arrays: dict):
        r, c = int(meta["round"]), int(meta["client"])
        if not 0 <= c < self.n_clients:
            raise ValueError(f"client id {c} out of range")
        lo, hi = self.rows
        with self._cond:
            self._require_store()
            if meta.get("ghost"):
                # Simulated-fault barrier filler: fills the client's slot
                # so the round finalizes, with no delta and no clock tick.
                return self._apply_push_locked(
                    r, c, None, replay=bool(meta.get("replay")))
            deltas = {}
            for n in self._sharded:
                v = arrays[n]
                if tuple(v.shape) != tuple(self._store[n].shape):
                    raise ValueError(
                        f"PUSH delta {n!r} has shape {v.shape}, store has "
                        f"{tuple(self._store[n].shape)} (rows [{lo}, {hi}))")
                deltas[n] = v
            return self._apply_push_locked(
                r, c, deltas, replay=bool(meta.get("replay")))

    def _on_push_sparse(self, meta: dict, arrays: dict):
        """The COO row-sliced push frame: ``rows`` carries shard-local row
        ids, each delta stat a packed (R, K) value block.

        Every index is validated (integer dtype, 1-D, in range, strictly
        increasing, value blocks exactly (R, K)) before the store is
        touched, so a malformed frame answers ERROR and leaves the store as
        it was.  The densified delta then rides the dense push's barrier
        path: a scatter of disjoint rows into zeros rebuilds the sender's
        dense delta bit for bit."""
        r, c = int(meta["round"]), int(meta["client"])
        if not 0 <= c < self.n_clients:
            raise ValueError(f"client id {c} out of range")
        lo, hi = self.rows
        if "rows" not in arrays:
            raise ValueError("PUSH_SPARSE frame is missing the 'rows' array")
        rows = arrays["rows"]
        if rows.ndim != 1 or not np.issubdtype(rows.dtype, np.integer):
            raise ValueError(
                f"PUSH_SPARSE rows must be a 1-D integer array, got "
                f"shape {rows.shape} dtype {rows.dtype}")
        rows = rows.astype(np.int64)
        n_local = hi - lo
        if int(meta.get("n_rows", n_local)) != n_local:
            raise ValueError(
                f"PUSH_SPARSE n_rows={meta.get('n_rows')} does not match "
                f"this shard's row slice [{lo}, {hi})")
        if rows.size and (np.any(rows < 0) or np.any(rows >= n_local)):
            raise ValueError(
                f"PUSH_SPARSE row index out of range [0, {n_local}) "
                f"(rows [{lo}, {hi}))")
        if rows.size and np.any(np.diff(rows) <= 0):
            raise ValueError(
                "PUSH_SPARSE rows must be strictly increasing (duplicate "
                "or unsorted row indices would mis-apply the scatter-add)")
        with self._cond:
            self._require_store()
            deltas = {}
            for n in self._sharded:
                if n not in arrays:
                    raise ValueError(f"PUSH_SPARSE frame is missing packed "
                                     f"rows for stat {n!r}")
                v = arrays[n]
                shape = tuple(self._store[n].shape)
                want = (rows.size,) + shape[1:]
                if v.shape != want:
                    raise ValueError(
                        f"PUSH_SPARSE values {n!r} have shape {v.shape}; "
                        f"{len(rows)} row indices over store {shape} "
                        f"require {want}")
                # Densified on the host: the mutation log's digest is the
                # reference's, over the dense delta.
                dense = np.zeros(shape, v.dtype)
                dense[rows] = v
                deltas[n] = dense
            return self._apply_push_locked(
                r, c, deltas, replay=bool(meta.get("replay")))

    def _apply_push_locked(self, r: int, c: int,
                           deltas: dict[str, np.ndarray] | None, *,
                           replay: bool = False):
        """Shared tail of the dense, sparse and ghost pushes: the mutation
        log's check, the policy split (async immediate against barrier
        buffering), and the ack.

        The sequence number of a push is its round: a key hit with a
        matching digest returns the recorded ack; a hit with another digest
        is refused; a miss for an already-finalized round is refused unless
        replay-flagged, which acks ``ignored``."""
        digest = mutation_digest(deltas)
        rec = self._mutlog.get((c, r))
        if rec is not None:
            if rec[0] == digest:
                return MsgType.OK, dict(rec[1]), None
            raise ValueError(
                f"conflicting PUSH replay (round {r}, client {c}): same "
                "sequence number, different delta digest")
        if self.policy.immediate:
            # Async: apply on arrival (Gauss-Seidel in arrival order).
            if deltas is not None:
                for n, v in deltas.items():
                    self._store[n] = self._store[n] + self._dev(v)
                self._clocks[c] += 1
            mask = self._clock_mask_locked()
            done = int(self._clocks[mask].min()) if mask.any() \
                else self._round
            if self.project_every and done > self._round:
                for m in range(self._round, done):
                    if m % self.project_every == 0:
                        self._project_locked()
            if done > self._round:
                self._round = done
            reply = {"server_round": self._round, "round": r, "client": c}
            self._mutlog[(c, r)] = (digest, reply)
            self._prune_mutlog_locked()
            self._cond.notify_all()
            return MsgType.OK, dict(reply), None
        if r < self._round:
            if replay:
                return MsgType.OK, {"server_round": self._round,
                                    "round": r, "client": c,
                                    "ignored": True}, None
            raise ValueError(
                f"PUSH for already-finalized round {r} "
                f"(server at {self._round})")
        slot = self._pending.setdefault(r, {})
        if c in slot:
            # Unreachable while the mutation log covers pending rounds.
            raise ValueError(f"duplicate PUSH (round {r}, client {c})")
        slot[c] = (None if deltas is None
                   else {n: self._dev(v) for n, v in deltas.items()})
        reply = {"server_round": self._round, "round": r, "client": c}
        self._mutlog[(c, r)] = (digest, reply)
        self._advance_locked()
        reply["server_round"] = self._round
        return MsgType.OK, dict(reply), None

    def _clock_mask_locked(self) -> np.ndarray:
        """Clients whose clocks still gate round advancement: everyone not
        evicted."""
        mask = np.ones((self.n_clients,), bool)
        for c in self._evicted:
            mask[c] = False
        return mask

    def _required_locked(self) -> list[int]:
        """The barrier's required contributors: every non-evicted client."""
        return [c for c in range(self.n_clients)
                if c not in self._evicted]

    def _advance_locked(self) -> None:
        """Finalize every consecutive complete round: sum the pending
        deltas in ascending client order, apply once, advance the
        contributors' clocks, project on cadence.  A round is complete when
        every required (non-evicted) client has a slot; ghost slots (None)
        count for completeness but add no delta and tick no clock."""
        while True:
            required = self._required_locked()
            slot = self._pending.get(self._round)
            if not required or slot is None \
                    or not all(c in slot for c in required):
                break
            r = self._round
            slot = self._pending.pop(r)
            contributors = [c for c in sorted(slot) if slot[c] is not None]
            total: dict[str, torch.Tensor] | None = None
            for c in contributors:
                d = slot[c]
                total = (dict(d) if total is None
                         else {n: total[n] + d[n] for n in total})
            if total is not None:
                for n in total:
                    self._store[n] = self._store[n] + total[n]
            for c in contributors:
                self._clocks[c] += 1
            if self.project_every and r % self.project_every == 0:
                self._project_locked()
            self._round = r + 1
            self._prune_mutlog_locked()
            if self.snapshot_dir and self.snapshot_every \
                    and self._round % self.snapshot_every == 0:
                self._snapshot_locked(self.snapshot_dir, self._round)
            self._cond.notify_all()

    def _prune_mutlog_locked(self) -> None:
        horizon = self._round - MUTLOG_WINDOW
        if horizon <= 0:
            return
        stale = [k for k in self._mutlog if 0 <= k[1] < horizon]
        for k in stale:
            del self._mutlog[k]

    def _project_locked(self) -> None:
        """The family's elementwise shared rules on the row slices."""
        if not self._rules:
            return
        stats = projection.project(dict(self._store), self._rules)
        self._store = {n: stats[n] for n in self._store}

    def _on_snapshot(self, meta: dict):
        min_round = int(meta.get("min_round", 0))
        with self._cond:
            self._require_store()
            self._wait_locked(lambda: self._round >= min_round,
                              f"snapshot barrier {min_round}")
            return MsgType.STATE, {
                "version": self._round, "server_round": self._round,
                "sharded": list(self._sharded), "rows": list(self.rows),
                "clocks": [int(x) for x in self._clocks]}, \
                self._state_arrays_locked()

    def _on_clock(self, meta: dict):
        min_round = meta.get("min_round")
        with self._cond:
            if min_round is not None:
                self._wait_locked(lambda: self._round >= int(min_round),
                                  f"clock barrier {min_round}")
            return MsgType.OK, {
                "server_round": self._round,
                "clocks": [int(x) for x in self._clocks]}, None

    def _on_rejoin(self, meta: dict):
        c = int(meta["client"])
        if not 0 <= c < self.n_clients:
            raise ValueError(f"client id {c} out of range")
        action = meta.get("action", "join")
        with self._cond:
            if action == "leave":
                # Voluntary leave: liveness eviction, but at once.
                self._suspects.pop(c, None)
                if c not in self._evicted:
                    self._evicted.add(c)
                    self._evictions += 1
                if self._store is not None:
                    self._advance_locked()
                self._cond.notify_all()
                return MsgType.OK, {"server_round": self._round,
                                    "client": c, "evicted": True}, None
            # Clear any pending push the crashed incarnation left in
            # unfinalized rounds and the matching log entries, so the fresh
            # incarnation's different delta is not a digest conflict.
            self._suspects.pop(c, None)
            self._evicted.discard(c)
            for slot in self._pending.values():
                slot.pop(c, None)
            for k in [k for k in self._mutlog
                      if k[0] == c and k[1] >= self._round]:
                del self._mutlog[k]
            self._cond.notify_all()
            return MsgType.OK, {"server_round": self._round,
                                "client": c}, None

    # ----------------------------------------------------- snapshot/restore
    def _snapshot_locked(self, directory: str, step: int) -> str:
        """Persist the full barrier state as one flat npz (the reference's
        leaf names): arrays carry the store, aux and pending deltas; one
        JSON blob everything else (round, clocks, evictions, ghosts,
        mutation log)."""
        flat: dict[str, Any] = {}
        for n, v in self._store.items():
            flat[f"store/{n}"] = v
        for n, v in self._aux.items():
            flat[f"aux/{n}"] = v
        ghosts: list[list[int]] = []
        for r, slot in self._pending.items():
            for c, d in slot.items():
                if d is None:
                    ghosts.append([int(r), int(c)])
                else:
                    for n, v in d.items():
                        flat[f"pending/{r}/{c}/{n}"] = v
        blob = {
            "family": self.family_name,
            "vocab_size": self.vocab_size,
            "n_clients": self.n_clients,
            "consistency": self.policy.key,
            "rows": list(self.rows),
            "round": int(self._round),
            "clocks": [int(x) for x in self._clocks],
            "sharded": list(self._sharded),
            "evicted": sorted(int(c) for c in self._evicted),
            "ghosts": ghosts,
            "mutlog": [[int(c), int(s), dg, dict(rm)]
                       for (c, s), (dg, rm) in self._mutlog.items()],
        }
        flat["__meta__"] = np.frombuffer(
            json.dumps(blob).encode("utf-8"), np.uint8).copy()
        path = ckpt.save(directory, self._snap_name, step, flat)
        self._snapshots_written += 1
        return path

    def snapshot_to(self, directory: str | None = None,
                    step: int | None = None) -> str:
        directory = directory or self.snapshot_dir
        if not directory:
            raise ValueError("no snapshot directory configured")
        with self._cond:
            self._require_store()
            return self._snapshot_locked(
                directory, self._round if step is None else int(step))

    def restore_from(self, directory: str | None = None,
                     step: int | None = None) -> int:
        """Reload the shard's state from the newest readable snapshot (of
        either package) and resume serving mid-run.  The identity (family,
        vocabulary, n_clients, consistency, row range) is checked against
        the snapshot's blob."""
        directory = directory or self.snapshot_dir
        if not directory:
            raise ValueError("no snapshot directory configured")
        step, flat = ckpt.load_raw(directory, self._snap_name, step)
        raw = flat.pop("__meta__", None)
        if raw is None:
            raise ValueError(
                f"snapshot {self._snap_name} step {step} has no __meta__ "
                "blob — not a shard-server snapshot")
        blob = json.loads(bytes(raw.tobytes()).decode("utf-8"))
        for field, mine in (("family", self.family_name),
                            ("vocab_size", self.vocab_size),
                            ("n_clients", self.n_clients),
                            ("consistency", self.policy.key),
                            ("rows", list(self.rows))):
            theirs = blob.get(field)
            if theirs != mine:
                raise ValueError(
                    f"snapshot identity mismatch on {field}: snapshot "
                    f"has {theirs!r}, server has {mine!r}")
        store: dict[str, torch.Tensor] = {}
        aux: dict[str, torch.Tensor] = {}
        pending: dict[int, dict[int, dict[str, torch.Tensor] | None]] = {}
        for key, v in flat.items():
            if key.startswith("store/"):
                store[key[len("store/"):]] = self._dev(v)
            elif key.startswith("aux/"):
                aux[key[len("aux/"):]] = self._dev(v)
            elif key.startswith("pending/"):
                _, r, c, n = key.split("/", 3)
                pending.setdefault(int(r), {}).setdefault(
                    int(c), {})[n] = self._dev(v)
            else:
                raise ValueError(f"unknown snapshot leaf {key!r}")
        for r, c in blob.get("ghosts", []):
            pending.setdefault(int(r), {})[int(c)] = None
        with self._cond:
            self._store = store
            self._aux = aux
            self._sharded = tuple(blob["sharded"])
            self._pending = pending
            self._round = int(blob["round"])
            self._clocks = np.asarray(blob["clocks"], np.int64)
            self._evicted = set(int(c) for c in blob.get("evicted", []))
            self._suspects.clear()
            self._mutlog = {(int(c), int(s)): (dg, dict(rm))
                            for c, s, dg, rm in blob.get("mutlog", [])}
            self._init_parts.clear()
            self._resolve_rules_locked()
            self._cond.notify_all()
            return self._round

    def _on_snapshot_write(self, meta: dict):
        directory = meta.get("directory") or self.snapshot_dir
        if not directory:
            raise ValueError(
                "SNAPSHOT_WRITE needs meta['directory'] (the server has "
                "no --snapshot-dir configured)")
        with self._cond:
            self._require_store()
            step = self._round if meta.get("step") is None \
                else int(meta["step"])
            path = self._snapshot_locked(directory, step)
        return MsgType.OK, {"server_round": self._round, "step": step,
                            "name": self._snap_name,
                            "path": os.path.basename(path)}, None

    def _on_snapshot_restore(self, meta: dict):
        directory = meta.get("directory") or self.snapshot_dir
        if not directory:
            raise ValueError(
                "SNAPSHOT_RESTORE needs meta['directory'] (the server "
                "has no --snapshot-dir configured)")
        step = None if meta.get("step") is None else int(meta["step"])
        try:
            restored = self.restore_from(directory, step)
        except (FileNotFoundError, ckpt.CorruptSnapshotError) as e:
            raise ValueError(f"restore failed: {e}") from e
        return MsgType.OK, {"server_round": restored,
                            "name": self._snap_name}, None

    def round_reached(self, n: int) -> bool:
        with self._cond:
            return self._round >= n

    # -------------------------------------------------------------- admin
    def stats(self) -> dict[str, Any]:
        with self._cond:
            live = [dict(c) for c in self._conn_counters]
            lat = sorted(self._latency_s)

            def pct(p: float) -> float:
                if not lat:
                    return 0.0
                return lat[min(len(lat) - 1,
                               int(round(p * (len(lat) - 1))))] * 1e3

            return {
                "server_round": self._round,
                "rows": list(self.rows),
                "clocks": [int(x) for x in self._clocks],
                "evicted": sorted(int(c) for c in self._evicted),
                "suspects": sorted(int(c) for c in self._suspects),
                "evictions": self._evictions,
                "mutlog_entries": len(self._mutlog),
                "snapshots_written": self._snapshots_written,
                "protocol_errors": self._protocol_errors,
                "rpc_count": len(self._latency_s),
                "rpc_p50_ms": pct(0.50),
                "rpc_p99_ms": pct(0.99),
                "bytes_in": sum(c["bytes_in"] for c in live),
                "bytes_out": sum(c["bytes_out"] for c in live),
                "closed_connections": live,
            }


def serve_shards(family_name: str, *, vocab_size: int, n_clients: int,
                 n_shards: int = 1, consistency: str = "bsp",
                 project_every: int = 1, host: str = "127.0.0.1",
                 ports: tuple[int, ...] | None = None,
                 barrier_timeout: float = 60.0,
                 liveness_timeout: float = 15.0,
                 snapshot_dir: str | None = None,
                 snapshot_every: int = 0,
                 restore: bool = False, device=None) -> list[ShardServer]:
    """Start the ``n_shards`` row-range servers of a balanced
    :class:`~repro_torch.core.server.ShardSpec` partition (one listener
    each, all in this process, stores on ``device``) and return them
    running.  Row ranges match ``ShardSpec.rows_of``, so both transports
    shard the vocabulary identically.  With ``restore`` each shard reloads
    its latest snapshot from ``snapshot_dir`` before serving."""
    spec = server_mod.ShardSpec(vocab_size, n_shards)
    servers = []
    for s in range(n_shards):
        srv = ShardServer(
            family_name, vocab_size=vocab_size, n_clients=n_clients,
            rows=spec.rows_of(s), consistency=consistency,
            project_every=project_every, host=host,
            port=0 if ports is None else ports[s],
            barrier_timeout=barrier_timeout,
            liveness_timeout=liveness_timeout,
            snapshot_dir=snapshot_dir, snapshot_every=snapshot_every,
            device=device)
        if restore:
            srv.restore_from(snapshot_dir)
        servers.append(srv.start())
    return servers


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="parameter-server shard process (repro_torch.net)")
    ap.add_argument("--family", default="lda")
    ap.add_argument("--vocab-size", type=int, required=True)
    ap.add_argument("--n-clients", type=int, required=True)
    ap.add_argument("--n-shards", type=int, default=1)
    ap.add_argument("--consistency", default="bsp")
    ap.add_argument("--project-every", type=int, default=1)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--barrier-timeout", type=float, default=60.0)
    ap.add_argument("--liveness-timeout", type=float, default=15.0,
                    help="evict a client from the round barrier this many "
                         "seconds after its last connection died")
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="persist shard state every N finalized rounds "
                         "(0 = only on SNAPSHOT_WRITE)")
    ap.add_argument("--restore", action="store_true",
                    help="reload the latest snapshot from --snapshot-dir "
                         "before serving (shard-process restart)")
    ap.add_argument("--ports", default=None,
                    help="comma-separated listen ports, one per shard — a "
                         "restarted process must rebind its published "
                         "addresses")
    ap.add_argument("--die-after-round", type=int, default=None,
                    help="exit(42) once every shard reaches this round "
                         "(deterministic kill point for failover tests)")
    ap.add_argument("--address-file", default=None,
                    help="write the bound addresses as JSON (the launcher "
                         "polls this instead of parsing stdout)")
    ap.add_argument("--device", default="cuda",
                    help="where the stores live: cuda (default) or cpu")
    args = ap.parse_args(argv)

    ports = None
    if args.ports:
        ports = tuple(int(p) for p in args.ports.split(","))
        if len(ports) != args.n_shards:
            ap.error(f"--ports names {len(ports)} ports for "
                     f"{args.n_shards} shards")
    servers = serve_shards(
        args.family, vocab_size=args.vocab_size, n_clients=args.n_clients,
        n_shards=args.n_shards, consistency=args.consistency,
        project_every=args.project_every, host=args.host, ports=ports,
        barrier_timeout=args.barrier_timeout,
        liveness_timeout=args.liveness_timeout,
        snapshot_dir=args.snapshot_dir,
        snapshot_every=args.snapshot_every, restore=args.restore,
        device=args.device)
    addrs = [f"{h}:{p}" for h, p in (s.address for s in servers)]
    if args.address_file:
        tmp = args.address_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"addresses": addrs}, f)
        os.replace(tmp, args.address_file)
    for a in addrs:
        print(f"READY {a}", flush=True)
    try:
        while any(not s._stop for s in servers):
            if args.die_after_round is not None and all(
                    s.round_reached(args.die_after_round)
                    for s in servers):
                # round_reached takes the store lock, so the round-N
                # snapshot (written under the same lock) is complete
                # before the kill fires.
                print(f"DYING round {args.die_after_round}", flush=True)
                os._exit(42)
            time.sleep(0.1)
    except KeyboardInterrupt:
        pass
    finally:
        for s in servers:
            s.close()
    for s in servers:
        stats = {k: v for k, v in s.stats().items()
                 if k != "closed_connections"}
        print(f"STATS {json.dumps(stats)}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
