"""Loopback launcher for the online inference service (port of
``repro.launch.serve``).

Starts one inference-server process (``python -m
repro_torch.serve.server``) and M client processes (``python -m
repro_torch.serve.client``) on 127.0.0.1, against a snapshot trained in
this process with the port's ``Trainer`` and written by
``Trainer.save_snapshot``: a frozen model behind a socket, folded into by
many users at once.

``--smoke`` is the end-to-end check: train a small LDA model, save its
snapshot, serve it from a separate process, fold the same requests in
from 2 client processes, and require every client's result checksums to
equal those of an in-process ``FoldInEngine`` over the same snapshot.
The server and the in-process engine run on ``--device``, ``cuda`` by
default.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any


@dataclass
class ProcResult:
    """Exit status + captured output of one launched process."""
    name: str
    args: list[str]
    returncode: int
    stdout: str
    stderr: str
    result: dict[str, Any] | None = None  # parsed --out JSON, clients only


@dataclass
class ServeLaunchResult:
    address: str
    server: ProcResult | None = None
    clients: list[ProcResult] = field(default_factory=list)
    server_stats: dict[str, Any] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        procs = ([self.server] if self.server else []) + self.clients
        return all(p.returncode == 0 for p in procs)

    def failures(self) -> list[ProcResult]:
        procs = ([self.server] if self.server else []) + self.clients
        return [p for p in procs if p.returncode != 0]


def _python() -> list[str]:
    return [sys.executable]


def _env() -> dict[str, str]:
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _tail(text: str, n: int = 15) -> list[str]:
    return (text or "").strip().splitlines()[-n:]


def _wait_address_file(path: str, proc: subprocess.Popen,
                       timeout: float) -> str:
    """Poll for the server's address file; fail fast if the server died."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"inference server exited early (code {proc.returncode}) "
                f"before publishing its address")
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return list(json.load(f)["addresses"])[0]
            except (json.JSONDecodeError, KeyError, IndexError):
                pass  # torn read before os.replace — retry
        time.sleep(0.05)
    raise TimeoutError(f"server did not publish {path} within "
                       f"{timeout:.0f}s")


def _finish(proc: subprocess.Popen, name: str, args: list[str],
            timeout: float) -> ProcResult:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        return ProcResult(name, args, returncode=-9,
                          stdout=out or "", stderr=(err or "")
                          + f"\n[launcher] killed after {timeout:.0f}s "
                            "timeout")
    return ProcResult(name, args, proc.returncode, out or "", err or "")


def _shutdown_server(address: str, timeout: float = 10.0
                     ) -> dict[str, Any]:
    """Fetch the server's STATS, then tell it to stop (no client knows it
    is the last one out)."""
    from repro_torch.serve.client import InferenceClient
    stats: dict[str, Any] = {}
    try:
        with InferenceClient(address, timeout=timeout) as cli:
            try:
                stats = cli.stats()
            except Exception:
                pass
            cli.shutdown()
    except OSError:
        pass  # already down
    return stats


def train_snapshot(workdir: str, *, family: str, vocab_size: int,
                   n_topics: int, n_docs: int = 64, doc_len: int = 48,
                   n_rounds: int = 5, seed: int = 0, device=None):
    """Train a small model in this process with the port's Trainer and
    write its snapshot, the model the server process freezes.  Returns
    the model config (the server rebuilds it from its flags)."""
    from repro_torch.core import family as family_mod
    from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
    from repro_torch.engine.trainer import Trainer, TrainerConfig

    fam = family_mod.get(family)
    cfg = fam.config_cls(n_topics=n_topics, vocab_size=vocab_size)
    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=n_topics, vocab_size=vocab_size, n_docs=n_docs,
        doc_len=doc_len, seed=seed))
    tcfg = TrainerConfig(layout="sorted", n_clients=1, snapshot_dir=workdir)
    trainer = Trainer(cfg, tokens, mask, config=tcfg, seed=seed,
                      device=device)
    for _ in range(n_rounds):
        trainer.step()
    trainer.save_snapshot()
    return cfg


def launch_serve(*, family: str = "lda", vocab_size: int = 400,
                 n_topics: int = 8, n_clients: int = 2,
                 n_docs: int = 6, max_len: int = 48, max_slots: int = 8,
                 n_sweeps: int = 10, corpus_seed: int = 7,
                 seed_base: int = 1000, train_rounds: int = 5,
                 timeout: float = 420.0, workdir: str | None = None,
                 device=None) -> tuple[ServeLaunchResult, Any]:
    """Train → snapshot → serve from a separate process → M client
    processes.  The trainer and the server run on ``device`` (``cuda``
    unless ``"cpu"`` is passed).  Returns (launch result, model config)."""
    from repro_torch import device as device_mod
    dev = device_mod.resolve(device)
    own_dir = workdir is None
    tmp = tempfile.TemporaryDirectory() if own_dir else None
    workdir = tmp.name if own_dir else workdir
    try:
        cfg = train_snapshot(workdir, family=family,
                             vocab_size=vocab_size, n_topics=n_topics,
                             n_rounds=train_rounds, seed=corpus_seed,
                             device=dev)
        addr_file = os.path.join(workdir, "serve_addr.json")
        srv_args = _python() + ["-m", "repro_torch.serve.server",
                                "--family", family,
                                "--vocab-size", str(vocab_size),
                                "--n-topics", str(n_topics),
                                "--snapshot-dir", workdir,
                                "--max-slots", str(max_slots),
                                "--max-len", str(max_len),
                                "--n-sweeps", str(n_sweeps),
                                "--device", dev.type,
                                "--address-file", addr_file]
        srv = subprocess.Popen(srv_args, stdout=subprocess.PIPE,
                               stderr=subprocess.PIPE, text=True,
                               env=_env())
        result = ServeLaunchResult(address="")
        try:
            result.address = _wait_address_file(addr_file, srv,
                                                timeout=60.0)
        except (RuntimeError, TimeoutError):
            result.server = _finish(srv, "server", srv_args, timeout=5.0)
            return result, cfg

        client_procs = []
        for c in range(n_clients):
            out = os.path.join(workdir, f"client{c}.json")
            cargs = _python() + ["-m", "repro_torch.serve.client",
                                 "--addr", result.address,
                                 "--client-id", str(c),
                                 "--n-docs", str(n_docs),
                                 "--vocab-size", str(vocab_size),
                                 "--max-len", str(max_len),
                                 "--corpus-seed", str(corpus_seed),
                                 "--seed-base", str(seed_base),
                                 "--out", out]
            client_procs.append(
                (subprocess.Popen(cargs, stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True,
                                  env=_env()), cargs, out))
        for i, (proc, cargs, out) in enumerate(client_procs):
            pr = _finish(proc, f"client{i}", cargs, timeout)
            if pr.returncode == 0 and os.path.exists(out):
                with open(out) as f:
                    pr.result = json.load(f)
            result.clients.append(pr)
        result.server_stats = _shutdown_server(result.address)
        result.server = _finish(srv, "server", srv_args, timeout=30.0)
        return result, cfg
    finally:
        if tmp is not None:
            tmp.cleanup()


def _smoke(args) -> int:
    """The serve smoke: the client processes' results must equal those of
    the in-process engine, bit for bit."""
    import tempfile as _tf

    with _tf.TemporaryDirectory() as workdir:
        result, cfg = launch_serve(
            family=args.family, vocab_size=args.vocab_size,
            n_topics=args.n_topics, n_clients=args.n_clients,
            n_docs=args.n_docs, max_len=args.max_len,
            max_slots=args.max_slots, n_sweeps=args.n_sweeps,
            corpus_seed=args.corpus_seed, seed_base=args.seed_base,
            train_rounds=args.train_rounds, timeout=args.timeout,
            workdir=workdir, device=args.device)
        if not result.ok:
            for p in result.failures():
                print(f"FAIL {p.name} rc={p.returncode}",
                      *_tail(p.stderr), sep="\n  ")
            return 1

        # In-process reference: the same snapshot (the same manifest),
        # the same requests, one engine; batching must move no bit.
        from repro_torch.serve import snapshot as snapshot_mod
        from repro_torch.serve.client import requests_for
        from repro_torch.serve.engine import (FoldInEngine, ServeConfig,
                                              result_checksum)
        snap = snapshot_mod.from_checkpoint(workdir, cfg,
                                            device=args.device)
        eng = FoldInEngine(snap, ServeConfig(max_slots=args.max_slots,
                                             max_len=args.max_len,
                                             n_sweeps=args.n_sweeps),
                           device=args.device)
        reqs = []
        for c in range(args.n_clients):
            reqs.extend(requests_for(
                c, vocab_size=args.vocab_size, n_docs=args.n_docs,
                max_len=args.max_len, corpus_seed=args.corpus_seed,
                seed_base=args.seed_base))
        ref = {str(uid): result_checksum(res)
               for uid, res in eng.run(reqs).items()}

        bad = 0
        for pr in result.clients:
            got = pr.result["checksums"]
            for uid, sha in got.items():
                if ref.get(uid) != sha:
                    print(f"MISMATCH {pr.name} uid={uid}: wire {sha[:12]} "
                          f"!= reference {str(ref.get(uid))[:12]}")
                    bad += 1
        total = sum(len(p.result["checksums"]) for p in result.clients)
        if bad or total != args.n_clients * args.n_docs:
            print(f"serve smoke FAILED: {bad} mismatches, "
                  f"{total} results")
            return 1
        stats = result.server_stats
        print(f"serve smoke OK on {args.device}: {total} docs over "
              f"{args.n_clients} client processes bit-exact with "
              "in-process fold-in "
              f"(server p50 {stats.get('latency_p50_ms', 0):.1f} ms, "
              f"p99 {stats.get('latency_p99_ms', 0):.1f} ms, "
              f"shed {stats.get('shed', 0)})")
        return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="loopback launcher: 1 inference server x M "
                    "concurrent clients (repro_torch.serve)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the CI checksum-parity smoke and exit")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="small smoke geometry (--no-reduced serves a "
                         "larger model)")
    ap.add_argument("--family", default="lda")
    ap.add_argument("--n-clients", type=int, default=2)
    ap.add_argument("--n-docs", type=int, default=6)
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--n-sweeps", type=int, default=10)
    ap.add_argument("--corpus-seed", type=int, default=7)
    ap.add_argument("--seed-base", type=int, default=1000)
    ap.add_argument("--train-rounds", type=int, default=5)
    ap.add_argument("--timeout", type=float, default=420.0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    if args.reduced:
        args.vocab_size, args.n_topics, args.max_len = 400, 8, 48
    else:
        args.vocab_size, args.n_topics, args.max_len = 4096, 32, 128

    if args.smoke:
        return _smoke(args)

    result, _cfg = launch_serve(
        family=args.family, vocab_size=args.vocab_size,
        n_topics=args.n_topics, n_clients=args.n_clients,
        n_docs=args.n_docs, max_len=args.max_len,
        max_slots=args.max_slots, n_sweeps=args.n_sweeps,
        corpus_seed=args.corpus_seed, seed_base=args.seed_base,
        train_rounds=args.train_rounds, timeout=args.timeout,
        device=args.device)
    if not result.ok:
        for p in result.failures():
            print(f"FAIL {p.name} rc={p.returncode}",
                  *_tail(p.stderr), sep="\n  ")
        return 1
    lats = [ms for p in result.clients for ms in p.result["latency_ms"]]
    lats.sort()
    total = sum(len(p.result["checksums"]) for p in result.clients)
    p50 = lats[len(lats) // 2] if lats else 0.0
    p99 = lats[min(len(lats) - 1, int(round(0.99 * (len(lats) - 1))))] \
        if lats else 0.0
    print(f"served {total} docs over {len(result.clients)} clients: "
          f"p50 {p50:.1f} ms, p99 {p99:.1f} ms "
          f"(server stats {json.dumps(result.server_stats)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
