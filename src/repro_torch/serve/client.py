"""Inference client (port of ``repro.serve.client``): INFER round-trips
against an inference server of either package, plus the client process
the loopback launcher starts (``python -m repro_torch.serve.client``).
It is numpy only and runs on no device.

The client is deliberately thin — one blocking RPC per document.  Service
concurrency comes from running many client connections (each gets its own
handler thread server-side; the batcher folds their documents into shared
fused sweeps).  A load-shed ERROR ("overloaded: …") is retried with
exponential backoff up to ``retries`` times; any other ERROR propagates.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import time
from typing import Sequence

import numpy as np

from repro_torch.net import protocol
from repro_torch.net.protocol import MsgType, ProtocolError
from repro_torch.serve.engine import (InferRequest, InferResult,
                                      result_checksum)


def _connect(addr: str, timeout: float) -> protocol.FramedConnection:
    host, port = addr.rsplit(":", 1)
    sock = socket.create_connection((host, int(port)), timeout=timeout)
    sock.settimeout(timeout)
    return protocol.FramedConnection(sock)


class InferenceClient:
    """One connection to an inference server."""

    def __init__(self, addr: str, *, timeout: float = 60.0,
                 retries: int = 5, backoff: float = 0.05):
        self.addr = addr
        self.timeout = timeout
        self.retries = retries
        self.backoff = backoff
        self.shed_retries = 0
        self._conn = _connect(addr, timeout)

    def infer(self, uid: int, tokens: Sequence[int], seed: int = 0
              ) -> InferResult:
        """Fold one document in; blocks until the server's chain mixes."""
        arrays = {"tokens": np.asarray(tokens, np.int32)}
        meta = {"uid": int(uid), "seed": int(seed)}
        delay = self.backoff
        for attempt in range(self.retries + 1):
            try:
                _, rmeta, rarr = self._conn.request(
                    MsgType.INFER, meta, arrays,
                    expect=(MsgType.INFER_RESULT,))
            except ProtocolError as e:
                # recv() folds ERROR frames into ProtocolError; only the
                # load-shed refusal is retryable (the server kept the
                # connection open for exactly this).
                if "overloaded" in str(e) and attempt < self.retries:
                    self.shed_retries += 1
                    time.sleep(delay)
                    delay *= 2
                    continue
                raise
            return InferResult(
                uid=int(rmeta["uid"]),
                theta=np.asarray(rarr["theta"], np.float32),
                assignments=np.asarray(rarr["assignments"], np.int32),
                n_sweeps=int(rmeta["n_sweeps"]))
        raise ProtocolError("unreachable")  # pragma: no cover

    def stats(self) -> dict:
        _, meta, _ = self._conn.request(MsgType.STATS, {},
                                        expect=(MsgType.OK,))
        return meta

    def shutdown(self) -> None:
        self._conn.request(MsgType.SHUTDOWN, {}, expect=(MsgType.OK,))

    def counters(self) -> dict:
        return self._conn.counters()

    def close(self) -> None:
        self._conn.close()

    def __enter__(self) -> "InferenceClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def synthetic_docs(vocab_size: int, n_docs: int, max_len: int, seed: int
                   ) -> list[np.ndarray]:
    """Deterministic request corpus shared by the client CLI, the
    launcher's in-process reference, and the benchmark — same seed, same
    documents, everywhere."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab_size,
                         size=int(rng.integers(4, max_len + 1))
                         ).astype(np.int32)
            for _ in range(n_docs)]


def requests_for(client_id: int, *, vocab_size: int, n_docs: int,
                 max_len: int, corpus_seed: int, seed_base: int
                 ) -> list[InferRequest]:
    """The exact request list client ``client_id`` sends: uids are
    partitioned per client, request seeds derive from the uid — so the
    in-process reference can regenerate every request bit-for-bit."""
    docs = synthetic_docs(vocab_size, n_docs, max_len,
                          corpus_seed + client_id)
    return [InferRequest(uid=client_id * 10_000 + i, tokens=d,
                         seed=seed_base + client_id * 10_000 + i)
            for i, d in enumerate(docs)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="inference client process (repro_torch.serve)")
    ap.add_argument("--addr", required=True)
    ap.add_argument("--client-id", type=int, required=True)
    ap.add_argument("--n-docs", type=int, default=8)
    ap.add_argument("--vocab-size", type=int, required=True)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--corpus-seed", type=int, default=7)
    ap.add_argument("--seed-base", type=int, default=1000)
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--out", required=True,
                    help="write per-uid result checksums + latencies as "
                         "JSON (the launcher compares them)")
    args = ap.parse_args(argv)

    reqs = requests_for(args.client_id, vocab_size=args.vocab_size,
                        n_docs=args.n_docs, max_len=args.max_len,
                        corpus_seed=args.corpus_seed,
                        seed_base=args.seed_base)
    checksums: dict[str, str] = {}
    latencies: list[float] = []
    with InferenceClient(args.addr, timeout=args.timeout) as cli:
        for req in reqs:
            t0 = time.perf_counter()
            res = cli.infer(req.uid, req.tokens, seed=req.seed)
            latencies.append((time.perf_counter() - t0) * 1e3)
            checksums[str(res.uid)] = result_checksum(res)
        shed_retries = cli.shed_retries
    payload = {"client_id": args.client_id, "checksums": checksums,
               "latency_ms": latencies, "shed_retries": shed_retries}
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, args.out)
    print(f"DONE {len(checksums)} docs", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
