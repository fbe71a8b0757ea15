"""Seeded TCP chaos proxy for the framed wire protocol (port of
``repro.net.chaos``; sockets only, no torch).

A :class:`ChaosProxy` is a transparent relay interposed between clients
and one shard server: it listens on its own port, dials the upstream
per accepted connection, and forwards *whole frames* in both directions
— except where a :class:`repro_torch.core.fault.FaultPlan`'s network events
(``conn_drop`` / ``frame_truncate`` / ``delay``) schedule misbehavior.

Determinism is the design constraint: every action is a pure function of
``(plan, connection ordinal, client→server frame ordinal)``.  The proxy
assigns connections ordinals in accept order and counts the frames a
connection sends toward the server; an event fires when its ``client``
field matches the connection ordinal (-1 = every connection) and the
frame ordinal falls in ``[start, stop)`` on the event's ``period``.  Two
runs of the same seeded schedule therefore corrupt exactly the same
frames — which is what lets tests assert byte-identical server stores
and identical client retry counts across replays.

Frame-ordinal map for a BSP train/stress client (how to aim an event):
HELLO is frame 0, INIT frame 1, then round ``r`` contributes PULL at
``2 + 2r`` and PUSH at ``3 + 2r`` — so ``FaultEvent("conn_drop",
client=0, start=5, stop=6)`` severs connection 0's round-1 push.

Actions (all counted per connection in :attr:`ChaosProxy.actions`):

``conn_drop``
    Close both sockets *instead of* forwarding the scheduled frame: the
    sender sees a reset/EOF mid-RPC and retries through the idempotent
    replay path; the server sees a dead connection and starts the
    liveness clock for its clients.

``frame_truncate``
    Forward the frame header plus only ``magnitude`` (fraction) of the
    payload, then close: the receiver gets a mid-read EOF — a
    :class:`~repro_torch.net.protocol.TransportError`, never a silently
    corrupt frame (the exact-read discipline turns byte loss into frame
    loss).

``delay``
    Sleep ``magnitude`` seconds, then forward intact — latency without
    loss (barrier and timeout code paths under slow links).

The proxy only ever cuts the stream at boundaries it chose; it never
rewrites bytes, so any corruption the peers observe is the protocol
layer's own truncation handling — fuzzing *placement*, not encoding.
"""

from __future__ import annotations

import socket
import threading
import time
from typing import Any

from repro_torch.core.fault import NET_KINDS, FaultEvent, FaultPlan
from repro_torch.net import protocol


class ChaosProxy:
    """A frame-aware TCP relay that misbehaves on schedule.

    One proxy fronts one upstream shard address.  Accepted connections
    get ordinals in accept order; the scheduled events from
    ``plan.net_events`` fire on the client→server frame stream (the
    mutation direction — where idempotency matters).  Server→client
    frames are relayed verbatim (reply loss still manifests client-side
    as a severed connection when an event kills the link first).
    """

    def __init__(self, upstream: str, plan: FaultPlan | None = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 dial_timeout: float = 10.0):
        up_host, _, up_port = upstream.rpartition(":")
        self.upstream = (up_host, int(up_port))
        self.events: tuple[FaultEvent, ...] = tuple(
            plan.net_events) if plan is not None else ()
        for e in self.events:
            if e.kind not in NET_KINDS:
                raise ValueError(f"not a network fault kind: {e.kind!r}")
        self.dial_timeout = dial_timeout
        self._lock = threading.Lock()
        self._conn_seq = 0
        self._stop = False
        self._threads: list[threading.Thread] = []
        # Observability: per-kind counts of fired actions, plus relayed
        # frame totals — the determinism tests compare these across runs.
        self.actions: dict[str, int] = {k: 0 for k in NET_KINDS}
        self.frames_forwarded = 0
        self.connections = 0

        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(32)
        self.address: tuple[str, int] = self._listener.getsockname()[:2]
        self._accept_thread: threading.Thread | None = None

    @property
    def addr(self) -> str:
        return f"{self.address[0]}:{self.address[1]}"

    # ------------------------------------------------------------ schedule
    def _action(self, conn_ord: int, frame_ord: int
                ) -> tuple[str, float] | None:
        """The scheduled action for this (connection, frame), or None.
        First matching event wins — a pure function of the plan and the
        two ordinals, so replays are exact."""
        for e in self.events:
            if e.client not in (-1, conn_ord):
                continue
            if not e.start <= frame_ord < e.stop:
                continue
            if (frame_ord - e.start) % e.period:
                continue
            return e.kind, e.magnitude
        return None

    # ----------------------------------------------------------- lifecycle
    def start(self) -> "ChaosProxy":
        t = threading.Thread(target=self._accept_loop,
                             name=f"chaos-accept-{self.address[1]}",
                             daemon=True)
        t.start()
        self._accept_thread = t
        return self

    def close(self) -> None:
        self._stop = True
        try:
            self._listener.close()
        except OSError:
            pass
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)

    def __enter__(self) -> "ChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"upstream": f"{self.upstream[0]}:{self.upstream[1]}",
                    "connections": self.connections,
                    "frames_forwarded": self.frames_forwarded,
                    "actions": dict(self.actions)}

    # ------------------------------------------------------------- relay
    def _accept_loop(self) -> None:
        self._listener.settimeout(0.2)
        while not self._stop:
            try:
                downstream, _addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._lock:
                conn_ord = self._conn_seq
                self._conn_seq += 1
                self.connections += 1
            t = threading.Thread(target=self._relay_conn,
                                 args=(downstream, conn_ord), daemon=True)
            t.start()
            self._threads.append(t)

    def _relay_conn(self, downstream: socket.socket, conn_ord: int) -> None:
        try:
            upstream = socket.create_connection(
                self.upstream, timeout=self.dial_timeout)
        except OSError:
            downstream.close()
            return
        for s in (downstream, upstream):
            try:
                s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            s.settimeout(0.5)
        dead = threading.Event()

        def kill() -> None:
            dead.set()
            for s in (downstream, upstream):
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                try:
                    s.close()
                except OSError:
                    pass

        # Server→client direction: verbatim whole-frame relay.
        t = threading.Thread(
            target=self._pump_verbatim, args=(upstream, downstream,
                                              dead, kill), daemon=True)
        t.start()

        # Client→server direction: the scheduled one.
        frame_ord = 0
        try:
            while not (self._stop or dead.is_set()):
                try:
                    frame = self._read_frame(downstream)
                except (protocol.ProtocolError, OSError):
                    break
                if frame is None:
                    continue  # idle tick
                header, payload = frame
                act = self._action(conn_ord, frame_ord)
                frame_ord += 1
                if act is not None:
                    kind, magnitude = act
                    with self._lock:
                        self.actions[kind] += 1
                    if kind == "conn_drop":
                        break
                    if kind == "frame_truncate":
                        keep = int(len(payload) * magnitude)
                        try:
                            upstream.sendall(header + payload[:keep])
                        except OSError:
                            pass
                        break
                    if kind == "delay":
                        time.sleep(magnitude)
                try:
                    upstream.sendall(header + payload)
                except OSError:
                    break
                with self._lock:
                    self.frames_forwarded += 1
        finally:
            kill()
            t.join(timeout=2.0)

    def _pump_verbatim(self, src: socket.socket, dst: socket.socket,
                       dead: threading.Event, kill) -> None:
        while not (self._stop or dead.is_set()):
            try:
                frame = self._read_frame(src)
            except (protocol.ProtocolError, OSError):
                break
            if frame is None:
                continue
            try:
                dst.sendall(frame[0] + frame[1])
            except OSError:
                break
            with self._lock:
                self.frames_forwarded += 1
        kill()

    @staticmethod
    def _read_frame(sock: socket.socket
                    ) -> tuple[bytes, bytes] | None:
        """One whole frame off ``sock`` as (header, payload) bytes, or
        None on an idle boundary tick.  Validates the header (so a
        corrupt length can't make the proxy buffer gigabytes) but leaves
        payload contents untouched."""
        try:
            header = protocol.recv_all(sock, protocol.HEADER_SIZE,
                                       at_boundary=True)
        except protocol.IdleTimeout:
            return None
        _mt, length = protocol._validate_header(header)
        payload = protocol.recv_all(sock, length) if length else b""
        return header, payload


def interpose(addrs: list[str], plan: FaultPlan | None,
              *, host: str = "127.0.0.1") -> tuple[list[str],
                                                   list[ChaosProxy]]:
    """Stand one started proxy in front of each shard address; returns
    (proxied addresses in the same order, the proxies).  With no network
    events in the plan the proxies still relay — a pass-through run
    through the proxy is the control arm of the chaos tests."""
    proxies = [ChaosProxy(a, plan, host=host).start() for a in addrs]
    return [p.addr for p in proxies], proxies
