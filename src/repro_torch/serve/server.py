"""Online inference service: INFER/INFER_RESULT over the framed wire
protocol (port of ``repro.serve.server``).

An :class:`InferenceServer` owns one frozen snapshot and one
:class:`~repro_torch.serve.engine.FoldInEngine`.  It serves concurrent
clients with a thread per connection; the handlers never touch the
engine: they validate an INFER frame fully, put a ticket on the bounded
admission queue and wait for the batcher thread, the only thread that
touches the engine (and so the card), to deliver the result.

Admission:

* **batching window**: when the engine is idle, the batcher waits up to
  ``max_batch_delay`` seconds after the first queued request, so a burst
  shares one sweep;
* **continuous admission**: while chains run, queued requests are
  admitted at every boundary between sweeps;
* **load shedding**: a full queue answers ERROR ("overloaded: …") at once
  and keeps the connection; the client decides whether to retry.

A chain is a pure function of (snapshot, tokens, seed), so none of this
shows in the results, only in latency.

A failure of the batcher does not hang anyone: every waiting and later
request gets an ERROR naming it, and :meth:`InferenceServer.stats`
reports it (``batcher_alive``, ``batcher_error``).

CLI (``python -m repro_torch.serve.server``): freezes a Trainer snapshot
(either package's), binds, writes ``--address-file``, prints
``READY host:port``; ``--device`` defaults to ``cuda``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import queue as queue_mod
import socket
import threading
import time
import traceback
from typing import Any

import numpy as np

from repro_torch.net import protocol
from repro_torch.net.protocol import MsgType, ProtocolError
from repro_torch.serve import snapshot as snapshot_mod
from repro_torch.serve.engine import FoldInEngine, InferRequest, ServeConfig


class _Ticket:
    """One request in flight: its handler waits on ``event``."""

    __slots__ = ("uid", "tokens", "seed", "event", "result", "error")

    def __init__(self, uid: int, tokens: np.ndarray, seed: int):
        self.uid = uid
        self.tokens = tokens
        self.seed = seed
        self.event = threading.Event()
        self.result = None
        self.error: str | None = None


class InferenceServer:
    """Serve fold-in requests for one frozen snapshot over TCP; the engine
    runs on ``cuda`` unless ``device="cpu"`` is passed."""

    def __init__(self, snap, scfg: ServeConfig | None = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 max_queue: int = 64, max_batch_delay: float = 0.01,
                 request_timeout: float = 300.0,
                 idle_timeout: float = 1.0, device=None):
        self.snap = snap
        self.engine = FoldInEngine(snap, scfg, device=device)
        self.max_queue = max_queue
        self.max_batch_delay = max_batch_delay
        self.request_timeout = request_timeout
        self.idle_timeout = idle_timeout

        self._queue: queue_mod.Queue[_Ticket] = queue_mod.Queue(
            maxsize=max_queue)
        self._lock = threading.Lock()
        self._stop = False
        self._failed: str | None = None
        self._protocol_errors = 0
        self._shed = 0
        self._served = 0
        self._latency_s: list[float] = []
        self._threads: list[threading.Thread] = []

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self.address = self._listener.getsockname()
        self._accept_thread: threading.Thread | None = None
        self._batch_thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "InferenceServer":
        t = threading.Thread(target=self._accept_loop,
                             name=f"infer-accept-{self.address[1]}",
                             daemon=True)
        t.start()
        self._accept_thread = t
        b = threading.Thread(target=self._batch_loop,
                             name="infer-batcher", daemon=True)
        b.start()
        self._batch_thread = b
        return self

    def close(self) -> None:
        self._stop = True
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        if self._batch_thread is not None:
            self._batch_thread.join(timeout=5.0)

    @property
    def stopped(self) -> bool:
        return self._stop

    @property
    def batcher_alive(self) -> bool:
        return (self._batch_thread is not None
                and self._batch_thread.is_alive())

    def stats(self) -> dict[str, Any]:
        with self._lock:
            lat = sorted(self._latency_s)

            def pct(p: float) -> float:
                if not lat:
                    return 0.0
                return lat[min(len(lat) - 1,
                               int(round(p * (len(lat) - 1))))]

            return {
                "served": self._served,
                "shed": self._shed,
                "protocol_errors": self._protocol_errors,
                "latency_p50_ms": pct(0.50) * 1e3,
                "latency_p99_ms": pct(0.99) * 1e3,
                "sweeps_run": self.engine.sweeps_run,
                "batcher_alive": self.batcher_alive,
                "batcher_error": self._failed,
            }

    # --------------------------------------------------------------- batcher
    def _batch_loop(self) -> None:
        """admit → step → harvest, with the batching window when idle.  On
        an exception every ticket it holds, and every one queued later,
        gets an ERROR naming it; the thread stays up to answer them."""
        pending: collections.deque[_Ticket] = collections.deque()
        live: dict[int, _Ticket] = {}
        try:
            self._batch(pending, live)
        except Exception as e:
            self._failed = (f"inference batcher failed: "
                            f"{type(e).__name__}: {e}")
            traceback.print_exc()
            for t in list(pending) + list(live.values()):
                t.error = self._failed
                t.event.set()
            while not self._stop:
                try:
                    t = self._queue.get(timeout=0.1)
                except queue_mod.Empty:
                    continue
                t.error = self._failed
                t.event.set()
            return
        for t in list(pending) + list(live.values()):
            t.error = "server shutting down"
            t.event.set()

    def _batch(self, pending: collections.deque, live: dict) -> None:
        while not self._stop:
            if not pending and not live:
                try:
                    pending.append(self._queue.get(timeout=0.1))
                except queue_mod.Empty:
                    continue
                # Batching window: the rest of a burst shares the first
                # sweep.
                deadline = time.monotonic() + self.max_batch_delay
                while True:
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    try:
                        pending.append(self._queue.get(timeout=left))
                    except queue_mod.Empty:
                        break
            # Continuous admission: take whatever fits now.
            while self.engine.free_slots() > len(pending):
                try:
                    pending.append(self._queue.get_nowait())
                except queue_mod.Empty:
                    break
            while pending:
                t = pending[0]
                try:
                    ok = self.engine.admit(InferRequest(
                        uid=id(t), tokens=t.tokens, seed=t.seed))
                except ValueError as e:
                    # Backstop: handlers validate before enqueueing.
                    t.error = str(e)
                    t.event.set()
                    pending.popleft()
                    continue
                if not ok:
                    break
                live[id(t)] = t
                pending.popleft()
            if not live:
                continue
            self.engine.step()
            for res in self.engine.harvest():
                t = live.pop(res.uid)
                t.result = res
                t.event.set()

    # ----------------------------------------------------------- connections
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

    def _validate(self, meta: dict, arrays: dict) -> _Ticket:
        """Full validation before anything is enqueued: a malformed INFER
        never reaches the engine."""
        uid = meta.get("uid")
        if not isinstance(uid, int) or isinstance(uid, bool):
            raise ValueError(f"INFER meta.uid must be an int, got "
                             f"{type(uid).__name__}")
        seed = meta.get("seed", 0)
        if not isinstance(seed, int) or isinstance(seed, bool):
            raise ValueError("INFER meta.seed must be an int")
        if "tokens" not in arrays:
            raise ValueError("INFER frame has no 'tokens' array")
        toks = np.asarray(arrays["tokens"])
        if toks.ndim != 1:
            raise ValueError(f"tokens must be 1-D, got shape {toks.shape}")
        if toks.dtype.kind not in "iu":
            raise ValueError(f"tokens must be integer, got {toks.dtype}")
        if toks.size == 0:
            raise ValueError("empty document")
        scfg = self.engine.scfg
        if toks.size > scfg.max_len:
            raise ValueError(f"document has {toks.size} tokens, max_len "
                             f"is {scfg.max_len}")
        if int(toks.min()) < 0 or int(toks.max()) >= self.snap.vocab_size:
            raise ValueError("token id out of range for vocab_size "
                             f"{self.snap.vocab_size}")
        return _Ticket(uid, toks.astype(np.int32), seed)

    def _serve_conn(self, sock: socket.socket) -> None:
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        except OSError:
            pass
        sock.settimeout(self.idle_timeout)
        conn = protocol.FramedConnection(sock)
        try:
            while not self._stop:
                try:
                    mt, meta, arrays = conn.recv()
                except protocol.IdleTimeout:
                    continue
                except protocol.ConnectionClosed:
                    break
                except protocol.TransportError as e:
                    raise ProtocolError(
                        f"inference server lost the connection: {e}"
                    ) from e
                if mt is MsgType.SHUTDOWN:
                    conn.send(MsgType.OK, {})
                    self._stop = True
                    break
                if mt is MsgType.STATS:
                    conn.send(MsgType.OK, self.stats())
                    continue
                if mt is not MsgType.INFER:
                    conn.send(MsgType.ERROR,
                              {"error": f"unsupported message {mt.name} "
                                        "on an inference server"})
                    break
                t0 = time.perf_counter()
                try:
                    ticket = self._validate(meta, arrays)
                except ValueError as e:
                    # Well framed but semantically bad: say why, then drop
                    # the connection; its peer's state machine is off.
                    conn.send(MsgType.ERROR,
                              {"error": f"ValueError: {e}"})
                    break
                if self._failed is not None:
                    conn.send(MsgType.ERROR, {"error": self._failed})
                    break
                try:
                    self._queue.put_nowait(ticket)
                except queue_mod.Full:
                    # Load shed: answer at once and keep the connection.
                    with self._lock:
                        self._shed += 1
                    conn.send(MsgType.ERROR,
                              {"error": "overloaded: admission queue "
                                        f"full ({self.max_queue})",
                               "shed": True})
                    continue
                if not ticket.event.wait(self.request_timeout):
                    conn.send(MsgType.ERROR,
                              {"error": "inference timed out"})
                    break
                if ticket.error is not None:
                    conn.send(MsgType.ERROR, {"error": ticket.error})
                    break
                res = ticket.result
                conn.send(MsgType.INFER_RESULT,
                          {"uid": ticket.uid, "n_sweeps": res.n_sweeps},
                          {"theta": np.asarray(res.theta, np.float32),
                           "assignments": np.asarray(res.assignments,
                                                     np.int32)})
                with self._lock:
                    self._served += 1
                    self._latency_s.append(time.perf_counter() - t0)
        except ProtocolError as e:
            # Malformed frame or dead transport: only this connection
            # dies; the engine and every other client are untouched.
            with self._lock:
                self._protocol_errors += 1
            try:
                conn.send(MsgType.ERROR, {"error": str(e)})
            except OSError:
                pass
        finally:
            conn.close()


# ---------------------------------------------------------------------------
# CLI: the inference-server process the loopback launcher starts
# ---------------------------------------------------------------------------

def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="online topic-inference server (repro_torch.serve)")
    ap.add_argument("--family", default="lda")
    ap.add_argument("--vocab-size", type=int, required=True)
    ap.add_argument("--n-topics", type=int, required=True)
    ap.add_argument("--snapshot-dir", required=True,
                    help="Trainer snapshot manifest to freeze")
    ap.add_argument("--snapshot-name", default="trainer")
    ap.add_argument("--n-shards", type=int, default=1)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--n-sweeps", type=int, default=10)
    ap.add_argument("--max-queue", type=int, default=64)
    ap.add_argument("--max-batch-delay", type=float, default=0.01)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--address-file", default=None,
                    help="write the bound address as JSON (the launcher "
                         "polls this instead of parsing stdout)")
    args = ap.parse_args(argv)

    from repro_torch.core import family as family_mod
    fam = family_mod.get(args.family)
    cfg = fam.config_cls(n_topics=args.n_topics,
                         vocab_size=args.vocab_size)
    snap = snapshot_mod.from_checkpoint(
        args.snapshot_dir, cfg, n_shards=args.n_shards,
        name=args.snapshot_name, device=args.device)
    scfg = ServeConfig(max_slots=args.max_slots, max_len=args.max_len,
                       n_sweeps=args.n_sweeps)
    srv = InferenceServer(snap, scfg, host=args.host, port=args.port,
                          max_queue=args.max_queue,
                          max_batch_delay=args.max_batch_delay,
                          device=args.device).start()
    addr = f"{srv.address[0]}:{srv.address[1]}"
    if args.address_file:
        tmp = args.address_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"addresses": [addr]}, f)
        os.replace(tmp, args.address_file)
    print(f"READY {addr}", flush=True)
    try:
        while not srv.stopped:
            time.sleep(0.1)
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()
    stats = srv.stats()
    print(f"STATS {json.dumps(stats)}", flush=True)
    return 0 if stats["batcher_error"] is None else 1


if __name__ == "__main__":
    raise SystemExit(main())
