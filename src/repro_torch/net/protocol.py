"""Framed binary wire protocol (the port's own copy of
``repro.net.protocol``; numpy only).  Frames are byte-compatible with the
reference's: the same header, payload encoding, message-type values and
error classes, so either package's peer talks to the other's.

Frame layout (DESIGN.md §11) — a fixed 16-byte header followed by a
length-prefixed payload:

    offset  size  field
    ------  ----  -----------------------------------------------
       0      4   magic cookie ``b"LVPS"``
       4      1   protocol version (u8, currently 1)
       5      1   message type (u8, :class:`MsgType`)
       6      2   flags (u16 big-endian, reserved — must be 0)
       8      8   payload length (i64 big-endian, signed on purpose:
                  a negative length must be *representable* so it can
                  be rejected, not wrap into a huge read)
      16      n   payload

The payload of an array-carrying message is itself framed:

    u32 meta_len | meta (UTF-8 JSON) | npz bytes (``numpy.savez``)

so every message carries a small JSON metadata dict (round indices,
client ids, versions, error text) plus zero or more named numpy arrays.
JSON for control fields keeps the protocol debuggable on the wire; npz
for bulk keeps the (V, K) count matrices binary and exact (bit-exactness
across the socket is an acceptance criterion — no text round-trips of
floats).

Error contract: every malformed input — truncated header, bad magic,
unsupported version, oversized or negative length, mid-payload
disconnect, undecodable payload — raises :class:`ProtocolError` (or its
subclass :class:`ConnectionClosed` for a clean EOF *between* frames).
Peers catch it, optionally emit a best-effort :data:`MsgType.ERROR`
frame, and close the connection.  Nothing here blocks forever on a bad
frame and nothing mutates shard state before a frame fully decodes.
"""

from __future__ import annotations

import enum
import io
import json
import socket
import struct
import time
from typing import Any

import numpy as np

MAGIC = b"LVPS"
PROTOCOL_VERSION = 1

# magic(4s) version(B) msg_type(B) flags(H) length(q) — network byte order.
HEADER = struct.Struct("!4sBBHq")
HEADER_SIZE = HEADER.size  # 16

# Hard payload ceiling: generous for (V, K) count matrices at any size this
# repo runs, small enough that a corrupt length field can't trigger a
# multi-GiB allocation before being rejected.
MAX_PAYLOAD = 1 << 30

_META_LEN = struct.Struct("!I")


class ProtocolError(RuntimeError):
    """A malformed frame or protocol violation.  The connection that
    raised it must be considered dead: close it.  Server shard state is
    never touched before a frame fully decodes, so a ProtocolError on one
    connection cannot corrupt the store."""


class ConnectionClosed(ProtocolError):
    """The peer closed the socket at a frame boundary (clean EOF).
    Subclass of :class:`ProtocolError` so generic handlers close the
    connection either way, but distinguishable: EOF *inside* a frame is a
    plain ProtocolError (truncation)."""


class TransportError(ProtocolError):
    """The *network* failed (reset, timeout mid-read, EOF inside a
    frame), as opposed to a malformed frame or a semantic refusal.  The
    distinction drives the client's retry policy (DESIGN.md §13): a
    TransportError is safely retryable through the idempotent-replay
    path, a peer ERROR frame or a corrupt frame is not."""


class IdleTimeout(TransportError):
    """The socket timed out at a frame boundary with zero bytes read —
    the peer may be healthy but silent.  Servers use this as the liveness
    sweep tick; clients treat it like any other TransportError."""


class MsgType(enum.IntEnum):
    """Message-type registry (DESIGN.md §11).  Values are wire-stable:
    append only, never renumber."""

    HELLO = 1          # client → server: handshake (family, n_clients, …)
    WELCOME = 2        # server → client: handshake accept + server config
    INIT = 3           # client → server: per-client initial local stats
    PULL = 4           # client → server: versioned cache refresh request
    STATE = 5          # server → client: fresh snapshot (version, arrays)
    NOT_MODIFIED = 6   # server → client: cached version within bound
    PUSH = 7           # client → server: delta frame for a round
    OK = 8             # server → client: generic ack
    PROJECT = 9        # client → server: request constraint projection
    SNAPSHOT = 10      # client → server: admin/eval canonical state
    CLOCK = 11         # client → server: per-client clocks / barrier wait
    REJOIN = 12        # client → server: elastic rejoin (reset lag row)
    STATS = 13         # client → server: per-connection counters
    SHUTDOWN = 14      # client → server: stop serving after reply
    ERROR = 15         # server → client: request failed (meta["error"])
    PULL_KEYS = 16     # client → server: addressed shard-local row slices
    PUSH_SPARSE = 17   # client → server: COO row-sliced delta frame —
    #                    arrays carry "rows" (u32/i32 shard-local row ids,
    #                    strictly increasing, unique) plus one packed
    #                    (R, K) value matrix per delta statistic; meta
    #                    carries round/client plus "sparse" (stat names)
    #                    and "n_rows" (the shard's dense row count, so the
    #                    server can cross-check before scatter-adding).
    SNAPSHOT_WRITE = 18    # client → server: persist shard state to disk
    #                        (meta: directory, optional step) → OK with
    #                        the written step; admin path, DESIGN.md §13.
    SNAPSHOT_RESTORE = 19  # client → server: reload shard state from a
    #                        snapshot (meta: directory, optional step) →
    #                        OK with the restored round; also taken by a
    #                        restarted shard process before serving.
    INFER = 20         # client → inference server: fold one document in —
    #                    meta {"uid": int, "seed": int}, arrays
    #                    {"tokens": (L,) int32}; answered by INFER_RESULT
    #                    (or ERROR: bad doc / queue overflow load-shed).
    #                    DESIGN.md §14.
    INFER_RESULT = 21  # inference server → client: meta {"uid",
    #                    "n_sweeps"}, arrays {"theta": (K,) float32,
    #                    "assignments": (doc_len,) int32}.


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ProtocolError(msg)


def pack_payload(meta: dict[str, Any],
                 arrays: dict[str, np.ndarray] | None = None) -> bytes:
    """``meta`` JSON dict + named numpy arrays → payload bytes
    (``u32 meta_len | JSON | npz``)."""
    meta_bytes = json.dumps(meta, separators=(",", ":")).encode("utf-8")
    buf = io.BytesIO()
    np.savez(buf, **{k: np.asarray(v) for k, v in (arrays or {}).items()})
    return _META_LEN.pack(len(meta_bytes)) + meta_bytes + buf.getvalue()


def unpack_payload(payload: bytes) -> tuple[dict[str, Any],
                                            dict[str, np.ndarray]]:
    """Payload bytes → (meta dict, arrays dict).  Raises
    :class:`ProtocolError` on any undecodable byte."""
    _require(len(payload) >= _META_LEN.size,
             f"payload too short for meta length ({len(payload)} bytes)")
    (meta_len,) = _META_LEN.unpack_from(payload, 0)
    _require(_META_LEN.size + meta_len <= len(payload),
             f"meta length {meta_len} exceeds payload ({len(payload)} bytes)")
    try:
        meta = json.loads(payload[_META_LEN.size:_META_LEN.size + meta_len]
                          .decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ProtocolError(f"undecodable meta JSON: {e}") from e
    _require(isinstance(meta, dict), "meta must be a JSON object")
    npz_bytes = payload[_META_LEN.size + meta_len:]
    arrays: dict[str, np.ndarray] = {}
    if npz_bytes:
        try:
            with np.load(io.BytesIO(npz_bytes), allow_pickle=False) as data:
                arrays = {k: data[k] for k in data.files}
        except Exception as e:  # zipfile/zlib/ValueError zoo — see ckpt.py
            raise ProtocolError(f"undecodable npz section: "
                                f"{type(e).__name__}: {e}") from e
    return meta, arrays


def pack_frame(msg_type: MsgType, meta: dict[str, Any],
               arrays: dict[str, np.ndarray] | None = None) -> bytes:
    payload = pack_payload(meta, arrays)
    return HEADER.pack(MAGIC, PROTOCOL_VERSION, int(msg_type), 0,
                       len(payload)) + payload


def recv_all(sock: socket.socket, n: int, *,
             at_boundary: bool = False) -> bytes:
    """Read exactly ``n`` bytes or raise.

    EOF before the first byte of a frame is a clean close
    (:class:`ConnectionClosed`, when ``at_boundary``); a socket timeout
    there with zero bytes is :class:`IdleTimeout` (the liveness-sweep
    tick); EOF or a socket error anywhere else is a
    :class:`TransportError` (truncation — retryable by clients).
    ``recv`` may return short reads at any time — this loop is the
    exact-read discipline the whole protocol rests on."""
    chunks: list[bytes] = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except (socket.timeout, TimeoutError) as e:
            if at_boundary and got == 0:
                raise IdleTimeout("idle at frame boundary") from e
            raise TransportError(f"socket timeout after {got}/{n} bytes"
                                 ) from e
        except (ConnectionResetError, BrokenPipeError, OSError) as e:
            raise TransportError(f"socket error after {got}/{n} bytes: "
                                 f"{type(e).__name__}") from e
        if not chunk:
            if at_boundary and got == 0:
                raise ConnectionClosed("peer closed connection")
            raise TransportError(
                f"connection closed mid-read ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def _validate_header(header: bytes) -> tuple[MsgType, int]:
    """Header bytes → (message type, payload length).  Every field is
    validated before a single payload byte is read."""
    magic, version, msg_type, flags, length = HEADER.unpack(header)
    _require(magic == MAGIC,
             f"bad magic cookie {magic!r} (expected {MAGIC!r})")
    _require(version == PROTOCOL_VERSION,
             f"unsupported protocol version {version} "
             f"(speaking {PROTOCOL_VERSION})")
    _require(flags == 0, f"nonzero reserved flags 0x{flags:04x}")
    try:
        mt = MsgType(msg_type)
    except ValueError:
        raise ProtocolError(f"unknown message type {msg_type}") from None
    _require(length >= 0, f"negative payload length {length}")
    _require(length <= MAX_PAYLOAD,
             f"payload length {length} exceeds MAX_PAYLOAD {MAX_PAYLOAD}")
    return mt, length


def read_frame(sock: socket.socket) -> tuple[MsgType, dict[str, Any],
                                             dict[str, np.ndarray]]:
    """Read one complete frame: validates magic, version, type, and
    length before a single payload byte is interpreted."""
    mt, length = _validate_header(recv_all(sock, HEADER_SIZE,
                                           at_boundary=True))
    meta, arrays = unpack_payload(recv_all(sock, length))
    return mt, meta, arrays


class FramedConnection:
    """A socket speaking the framed protocol, with per-connection
    counters (bytes in/out, RPC count, per-RPC latency) — the
    observability surface the bench artifact reports."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass
        # encoded bytes: everything on the wire, headers included.
        self.bytes_in = 0
        self.bytes_out = 0
        # payload bytes: the framed data sections only (u32 meta_len +
        # JSON meta + npz) — what a different encoding could shrink; the
        # encoded−payload gap is fixed per-frame header overhead.
        self.payload_in = 0
        self.payload_out = 0
        self.rpc_count = 0
        self.rpc_latency_s: list[float] = []

    def send(self, msg_type: MsgType, meta: dict[str, Any],
             arrays: dict[str, np.ndarray] | None = None) -> None:
        frame = pack_frame(msg_type, meta, arrays)
        self.sock.sendall(frame)
        self.bytes_out += len(frame)
        self.payload_out += len(frame) - HEADER_SIZE

    def recv(self, *, expect: tuple[MsgType, ...] | None = None
             ) -> tuple[MsgType, dict[str, Any], dict[str, np.ndarray]]:
        header = recv_all(self.sock, HEADER_SIZE, at_boundary=True)
        self.bytes_in += HEADER_SIZE
        mt, length = _validate_header(header)
        payload = recv_all(self.sock, length)
        self.bytes_in += length
        self.payload_in += length
        meta, arrays = unpack_payload(payload)
        if mt is MsgType.ERROR:
            raise ProtocolError(f"peer error: {meta.get('error', '?')}")
        if expect is not None and mt not in expect:
            raise ProtocolError(
                f"unexpected {mt.name} (expected "
                f"{'/'.join(e.name for e in expect)})")
        return mt, meta, arrays

    def request(self, msg_type: MsgType, meta: dict[str, Any],
                arrays: dict[str, np.ndarray] | None = None, *,
                expect: tuple[MsgType, ...] | None = None
                ) -> tuple[MsgType, dict[str, Any], dict[str, np.ndarray]]:
        """One RPC: send a frame, read the reply, record latency."""
        t0 = time.perf_counter()
        self.send(msg_type, meta, arrays)
        out = self.recv(expect=expect)
        self.rpc_count += 1
        self.rpc_latency_s.append(time.perf_counter() - t0)
        return out

    def counters(self) -> dict[str, Any]:
        lat = sorted(self.rpc_latency_s)
        def pct(p: float) -> float:
            if not lat:
                return 0.0
            return lat[min(len(lat) - 1, int(round(p * (len(lat) - 1))))]
        return {
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "payload_in": self.payload_in,
            "payload_out": self.payload_out,
            "rpc_count": self.rpc_count,
            "rpc_p50_ms": pct(0.50) * 1e3,
            "rpc_p99_ms": pct(0.99) * 1e3,
        }

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
