"""Multi-process loopback launcher for the out-of-process parameter
server (port of ``repro.launch.loopback``).

Spawns a shard-server process (``python -m repro_torch.net.server``,
hosting ``n_shards`` shards) and M worker processes (``python -m
repro_torch.net.client``) on 127.0.0.1, waits for the server to publish
its addresses, timeout-guards the whole run, and collects exit codes,
logs and per-worker result JSONs: parameter-server processes serving
sampler processes over the loopback interface, with the frames a
cross-machine deployment would use.  Every process runs on ``device``
(``cuda`` by default; ``--device cpu`` for the plain PyTorch versions).

Fault tolerance adds two layers:

* ``chaos_plan``: a :class:`repro_torch.core.fault.FaultPlan` whose
  network events are interposed as :class:`repro_torch.net.chaos.
  ChaosProxy` relays between the workers and each shard address; the
  proxies' action counts land in the result.
* :func:`launch_failover`: the kill-and-rejoin choreography.  The shard
  process and one worker carry ``--die-after-round`` and the launcher
  supervises: it relaunches the shard process with ``--restore --ports``
  (same addresses, state from its own snapshot) and the worker with
  ``--restore`` (locals from its trainer snapshot, servers caught up by
  idempotent replay).

On abnormal exit the result carries diagnostics: the last stderr lines of
every failed process and each live shard's STATS frame.

``--smoke``: 1 shard process and 2 worker processes (one global client
each), then an in-process ``Trainer`` on the same corpus and seed; the
BSP result must be bit-exact (checksums equal across the socket).
``--failover-smoke``: the same parity through chaos proxies while one
shard process and one worker process are killed and restarted mid-run.
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
    expected: bool = False  # a scheduled --die-after-round kill (exit 42)


@dataclass
class LaunchResult:
    addresses: list[str]
    servers: list[ProcResult] = field(default_factory=list)
    clients: list[ProcResult] = field(default_factory=list)
    # Chaos-proxy action counts (one dict per interposed shard address).
    proxies: list[dict[str, Any]] = field(default_factory=list)
    # {"server": n, "client": n} relaunches performed by launch_failover.
    restarts: dict[str, int] = field(default_factory=dict)
    # Populated on abnormal exit: stderr tails of failed processes plus
    # the shards' per-connection RPC counters (STATS frames).
    diagnostics: dict[str, Any] = field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(p.returncode == 0 or (p.expected and p.returncode == 42)
                   for p in self.servers + self.clients)

    def failures(self) -> list[ProcResult]:
        return [p for p in self.servers + self.clients
                if p.returncode != 0 and not (p.expected
                                              and p.returncode == 42)]


def _python() -> list[str]:
    return [sys.executable]


def _env() -> dict[str, str]:
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _tail(text: str, n: int = 15) -> list[str]:
    """The last ``n`` non-empty-ish lines of a captured stream — what a
    failure diagnosis actually needs from a long log."""
    return (text or "").strip().splitlines()[-n:]


def _wait_address_file(path: str, proc: subprocess.Popen,
                       timeout: float) -> list[str]:
    """Poll for the server's address file; fail fast if the server died."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"server process exited early (code {proc.returncode}) "
                f"before publishing addresses")
        if os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                return list(data["addresses"])
            except (json.JSONDecodeError, KeyError):
                pass  # torn read before os.replace — retry
        time.sleep(0.05)
    raise TimeoutError(f"server did not publish {path} "
                       f"within {timeout:.0f}s")


def _send_shutdown(addresses: list[str], timeout: float = 10.0) -> None:
    """Tell each shard server to stop.  Client processes can't do this —
    none of them knows it is the last one out — so the launcher owns
    server lifetime."""
    import socket

    from repro_torch.net import protocol

    for addr in addresses:
        host, port = addr.rsplit(":", 1)
        try:
            sock = socket.create_connection((host, int(port)),
                                            timeout=timeout)
        except OSError:
            continue  # already down
        conn = protocol.FramedConnection(sock)
        try:
            conn.request(protocol.MsgType.SHUTDOWN, {},
                         expect=(protocol.MsgType.OK,))
        except (protocol.ProtocolError, OSError):
            pass
        finally:
            conn.close()


def _query_server_stats(addresses: list[str],
                        timeout: float = 5.0) -> list[dict[str, Any]]:
    """Each live shard's STATS frame (server round, clocks, evictions,
    per-connection RPC counters) — the server half of the abnormal-exit
    diagnostics.  Unreachable shards report instead of raising."""
    import socket

    from repro_torch.net import protocol

    out: list[dict[str, Any]] = []
    for addr in addresses:
        host, port = addr.rsplit(":", 1)
        try:
            sock = socket.create_connection((host, int(port)),
                                            timeout=timeout)
        except OSError as e:
            out.append({"address": addr, "error": f"unreachable: {e}"})
            continue
        conn = protocol.FramedConnection(sock)
        try:
            _, meta, _ = conn.request(protocol.MsgType.STATS, {},
                                      expect=(protocol.MsgType.OK,))
            out.append({"address": addr, **meta})
        except (protocol.ProtocolError, OSError) as e:
            out.append({"address": addr, "error": str(e)})
        finally:
            conn.close()
    return out


def _diagnose(result: LaunchResult, addresses: list[str],
              server_alive: bool) -> None:
    """Fill ``result.diagnostics`` for an abnormal exit: stderr tails of
    every failed process, plus the shards' per-connection RPC counters
    while they are still answering."""
    if result.ok:
        return
    result.diagnostics = {
        "failures": {
            p.name: {"returncode": p.returncode,
                     "stderr_tail": _tail(p.stderr)}
            for p in result.failures()},
        "server_stats": (_query_server_stats(addresses)
                         if server_alive else []),
    }


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


def _interpose(addresses: list[str], chaos_plan):
    """Stand chaos proxies in front of ``addresses`` (always, when a
    plan is given — a plan with no net events is the pass-through
    control arm); returns (addresses clients should dial, proxies)."""
    if chaos_plan is None:
        return addresses, []
    from repro_torch.net.chaos import interpose
    return interpose(addresses, chaos_plan)


def launch_loopback(*,
                    family: str = "lda",
                    vocab_size: int = 64,
                    n_topics: int = 4,
                    n_shards: int = 1,
                    client_sets: tuple[tuple[int, ...], ...] = ((0,), (1,)),
                    mode: str = "train",
                    n_rounds: int = 3,
                    tau: int = 1,
                    consistency: str = "bsp",
                    layout: str = "scan",
                    n_docs: int = 16,
                    doc_len: int = 12,
                    corpus_seed: int = 3,
                    seed: int = 0,
                    timeout: float = 300.0,
                    workdir: str | None = None,
                    chaos_plan=None,
                    extra_client_args: tuple[str, ...] = (),
                    device: str = "cuda",
                    ) -> LaunchResult:
    """Spawn 1 server process hosting ``n_shards`` shards plus one client
    process per entry of ``client_sets``, all on ``device``, and wait for
    everything.

    With ``chaos_plan`` (a :class:`repro_torch.core.fault.FaultPlan`) the
    clients dial :class:`~repro_torch.net.chaos.ChaosProxy` relays instead
    of the shards directly; the proxies' action counts land in
    ``result.proxies``.

    Returns a :class:`LaunchResult`; raises nothing on nonzero client
    exits (inspect ``.ok`` / ``.failures()``) but does raise if the
    server never comes up."""
    n_clients = sum(len(cs) for cs in client_sets)
    tmp = tempfile.mkdtemp(prefix="loopback_") if workdir is None else workdir
    addr_file = os.path.join(tmp, "addresses.json")

    server_args = _python() + [
        "-m", "repro_torch.net.server",
        "--family", family,
        "--vocab-size", str(vocab_size),
        "--n-clients", str(n_clients),
        "--n-shards", str(n_shards),
        "--consistency", consistency,
        "--barrier-timeout", str(timeout),
        "--address-file", addr_file,
        "--device", device,
    ]
    env = _env()
    server = subprocess.Popen(server_args, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
    try:
        addresses = _wait_address_file(addr_file, server, timeout)
    except Exception:
        server.kill()
        out, err = server.communicate()
        sys.stderr.write(f"[launcher] server stdout:\n{out}\n"
                         f"[launcher] server stderr:\n{err}\n")
        raise

    client_addrs, proxies = _interpose(addresses, chaos_plan)
    result = LaunchResult(addresses=addresses)
    client_procs: list[tuple[subprocess.Popen, str, list[str], str]] = []
    for i, cs in enumerate(client_sets):
        out_json = os.path.join(tmp, f"client{i}.json")
        cargs = _python() + [
            "-m", "repro_torch.net.client",
            "--mode", mode,
            "--addrs", ",".join(client_addrs),
            "--clients", ",".join(str(c) for c in cs),
            "--family", family,
            "--vocab-size", str(vocab_size),
            "--n-topics", str(n_topics),
            "--n-clients", str(n_clients),
            "--n-rounds", str(n_rounds),
            "--tau", str(tau),
            "--consistency", consistency,
            "--layout", layout,
            "--n-docs", str(n_docs),
            "--doc-len", str(doc_len),
            "--corpus-seed", str(corpus_seed),
            "--seed", str(seed),
            "--timeout", str(timeout),
            "--device", device,
            "--out", out_json,
        ] + list(extra_client_args)
        proc = subprocess.Popen(cargs, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
        client_procs.append((proc, f"client{i}", cargs, out_json))

    deadline = time.monotonic() + timeout
    for proc, name, cargs, out_json in client_procs:
        left = max(1.0, deadline - time.monotonic())
        pr = _finish(proc, name, cargs, left)
        if pr.returncode == 0 and os.path.exists(out_json):
            with open(out_json) as f:
                pr.result = json.load(f)
        result.clients.append(pr)

    # Diagnostics want the shards' counters while they still answer.
    if any(p.returncode != 0 for p in result.clients):
        result.diagnostics["server_stats"] = _query_server_stats(addresses)

    for p in proxies:
        result.proxies.append(p.stats())
        p.close()
    _send_shutdown(addresses)
    # A hung server must not hang the launcher: bounded wait, then kill.
    try:
        out, err = server.communicate(timeout=30.0)
        rc = server.returncode
    except subprocess.TimeoutExpired:
        server.kill()
        out, err = server.communicate()
        rc = -9
    result.servers.append(ProcResult("server", server_args, rc,
                                     out or "", err or ""))
    if not result.ok:
        stats = result.diagnostics.get("server_stats", [])
        _diagnose(result, addresses, server_alive=False)
        result.diagnostics["server_stats"] = stats
    return result


def _strip_flag(args: list[str], flag: str) -> list[str]:
    """``args`` without ``flag`` and its value (two-token options)."""
    out: list[str] = []
    i = 0
    while i < len(args):
        if args[i] == flag:
            i += 2
            continue
        out.append(args[i])
        i += 1
    return out


def launch_failover(*,
                    family: str = "lda",
                    vocab_size: int = 64,
                    n_topics: int = 4,
                    n_shards: int = 1,
                    client_sets: tuple[tuple[int, ...], ...] = ((0,), (1,)),
                    n_rounds: int = 6,
                    tau: int = 1,
                    consistency: str = "bsp",
                    layout: str = "scan",
                    kill_server_round: int | None = None,
                    kill_client: int | None = None,
                    kill_client_round: int | None = None,
                    chaos_plan=None,
                    n_docs: int = 16,
                    doc_len: int = 12,
                    corpus_seed: int = 3,
                    seed: int = 0,
                    timeout: float = 300.0,
                    liveness_timeout: float = 120.0,
                    reconnect_limit: int = 64,
                    workdir: str | None = None,
                    device: str = "cuda",
                    ) -> LaunchResult:
    """The kill-and-rejoin choreography over real processes (§5.4 on the
    wire), every process on ``device``.

    The shard process snapshots every finalized round; with
    ``kill_server_round`` it ``exit(42)``\\ s once every shard reaches
    that round, and the launcher relaunches it with ``--restore --ports``
    so it rebinds the *same* addresses and resumes from its snapshot —
    the clients ride it out through bounded RPC retry and replay their
    buffered mutations on reconnect.  With ``kill_client`` (an index
    into ``client_sets``) that worker snapshots every round, dies after
    ``kill_client_round``, and is relaunched with ``--restore`` to
    resume mid-run — the barrier, protected by ``liveness_timeout``,
    waits instead of evicting.  ``chaos_plan`` interposes chaos proxies
    exactly as :func:`launch_loopback`.

    Under BSP the final statistics must be bit-exact with the
    undisturbed in-process run: the property ``--failover-smoke`` and
    ``tests/test_torch_wire_failover.py`` assert.
    """
    n_clients = sum(len(cs) for cs in client_sets)
    tmp = tempfile.mkdtemp(prefix="failover_") if workdir is None else workdir
    addr_file = os.path.join(tmp, "addresses.json")
    srv_snap = os.path.join(tmp, "server_snapshots")
    env = _env()

    base_server_args = _python() + [
        "-m", "repro_torch.net.server",
        "--family", family,
        "--vocab-size", str(vocab_size),
        "--n-clients", str(n_clients),
        "--n-shards", str(n_shards),
        "--consistency", consistency,
        "--barrier-timeout", str(timeout),
        "--liveness-timeout", str(liveness_timeout),
        "--snapshot-dir", srv_snap,
        "--snapshot-every", "1",
        "--address-file", addr_file,
        "--device", device,
    ]
    server_args = list(base_server_args)
    if kill_server_round is not None:
        server_args += ["--die-after-round", str(kill_server_round)]
    server = subprocess.Popen(server_args, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
    try:
        addresses = _wait_address_file(addr_file, server, timeout)
    except Exception:
        server.kill()
        out, err = server.communicate()
        sys.stderr.write(f"[launcher] server stdout:\n{out}\n"
                         f"[launcher] server stderr:\n{err}\n")
        raise
    ports = ",".join(a.rsplit(":", 1)[1] for a in addresses)

    client_addrs, proxies = _interpose(addresses, chaos_plan)
    result = LaunchResult(addresses=addresses,
                          restarts={"server": 0, "client": 0})

    running: dict[str, list] = {}  # name -> [proc, args, out_json, victim]
    for i, cs in enumerate(client_sets):
        out_json = os.path.join(tmp, f"client{i}.json")
        cargs = _python() + [
            "-m", "repro_torch.net.client",
            "--mode", "train",
            "--addrs", ",".join(client_addrs),
            "--clients", ",".join(str(c) for c in cs),
            "--family", family,
            "--vocab-size", str(vocab_size),
            "--n-topics", str(n_topics),
            "--n-clients", str(n_clients),
            "--n-rounds", str(n_rounds),
            "--tau", str(tau),
            "--consistency", consistency,
            "--layout", layout,
            "--n-docs", str(n_docs),
            "--doc-len", str(doc_len),
            "--corpus-seed", str(corpus_seed),
            "--seed", str(seed),
            "--timeout", str(timeout),
            "--reconnect-limit", str(reconnect_limit),
            "--device", device,
            "--out", out_json,
        ]
        if i == kill_client:
            if kill_client_round is None:
                raise ValueError("kill_client requires kill_client_round")
            cargs += ["--snapshot-dir",
                      os.path.join(tmp, f"client{i}_snapshots"),
                      "--snapshot-every", "1",
                      "--die-after-round", str(kill_client_round)]
        proc = subprocess.Popen(cargs, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)
        running[f"client{i}"] = [proc, cargs, out_json, i == kill_client]

    deadline = time.monotonic() + timeout
    server_alive = True
    while running and time.monotonic() < deadline:
        # --- shard-process supervision -------------------------------
        if server_alive and server.poll() is not None:
            out, err = server.communicate()
            expected = server.returncode == 42
            result.servers.append(ProcResult(
                "server#killed" if expected else "server", server_args,
                server.returncode, out or "", err or "",
                expected=expected))
            if not expected:
                server_alive = False  # unexpected death: let clients fail
            else:
                result.restarts["server"] += 1
                # The stale address file must not satisfy the readiness
                # poll before the restarted process has actually bound.
                try:
                    os.remove(addr_file)
                except FileNotFoundError:
                    pass
                server_args = list(base_server_args) + [
                    "--restore", "--ports", ports]
                server = subprocess.Popen(
                    server_args, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True, env=env)
                _wait_address_file(addr_file, server,
                                   max(1.0, deadline - time.monotonic()))
        # --- worker-process supervision ------------------------------
        for name in list(running):
            proc, cargs, out_json, victim = running[name]
            rc = proc.poll()
            if rc is None:
                continue
            out, err = proc.communicate()
            if rc == 42 and victim:
                result.clients.append(ProcResult(
                    f"{name}#killed", cargs, rc, out or "", err or "",
                    expected=True))
                result.restarts["client"] += 1
                new_args = _strip_flag(cargs, "--die-after-round") \
                    + ["--restore"]
                proc2 = subprocess.Popen(
                    new_args, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, text=True, env=env)
                running[name] = [proc2, new_args, out_json, False]
                continue
            pr = ProcResult(name, cargs, rc, out or "", err or "")
            if rc == 0 and os.path.exists(out_json):
                with open(out_json) as f:
                    pr.result = json.load(f)
            result.clients.append(pr)
            del running[name]
        time.sleep(0.1)

    # Anything still running at the deadline is hung: kill + record.
    for name, (proc, cargs, out_json, _victim) in running.items():
        result.clients.append(_finish(proc, name, cargs, timeout=1.0))

    if any(p.returncode != 0 and not p.expected for p in result.clients):
        result.diagnostics["server_stats"] = _query_server_stats(addresses)

    for p in proxies:
        result.proxies.append(p.stats())
        p.close()
    if server_alive:
        _send_shutdown(addresses)
        try:
            out, err = server.communicate(timeout=30.0)
            rc = server.returncode
        except subprocess.TimeoutExpired:
            server.kill()
            out, err = server.communicate()
            rc = -9
        result.servers.append(ProcResult("server", server_args, rc,
                                         out or "", err or ""))
    if not result.ok:
        stats = result.diagnostics.get("server_stats", [])
        _diagnose(result, addresses, server_alive=False)
        result.diagnostics["server_stats"] = stats
    return result


def _reference_run(n_rounds: int, *, n_topics: int = 4,
                   vocab_size: int = 64, n_docs: int = 16, doc_len: int = 12,
                   corpus_seed: int = 3, seed: int = 0, corpus_topics=None,
                   eval_docs: int = 0, layout: str = "scan",
                   device: str = "cuda") -> dict[str, Any]:
    """The undisturbed in-process BSP run (two clients; the reference's
    default scan layout unless ``layout`` says otherwise) on the workers'
    corpus and seed: per-stat checksums and the perplexity a worker
    reports, what a tcp run is compared against bit for bit."""
    from repro_torch.core.lda import LDAConfig
    from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
    from repro_torch.engine.trainer import Trainer, TrainerConfig
    from repro_torch.net.client import _checksum

    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=corpus_topics or n_topics, vocab_size=vocab_size,
        n_docs=n_docs, doc_len=doc_len, seed=corpus_seed))
    ref = Trainer(LDAConfig(n_topics=n_topics, vocab_size=vocab_size),
                  tokens, mask,
                  config=TrainerConfig(layout=layout, n_clients=2, tau=1),
                  seed=seed, device=device)
    for _ in range(n_rounds):
        ref.step()
    n_eval = eval_docs or ref.tokens.shape[0]
    shared = ref.shared
    return {"checksums": {n: _checksum(v) for n, v in
                          ref.family.stats_dict(shared).items()},
            "perplexity": ref.perplexity(ref.tokens[:n_eval],
                                         ref.mask[:n_eval])}


def _dump_failures(tag: str, res: LaunchResult) -> None:
    for p in res.failures():
        sys.stderr.write(f"[{tag}] {p.name} exit {p.returncode}\n"
                         f"--- stdout ---\n{p.stdout}\n"
                         f"--- stderr ---\n{p.stderr}\n")
    if res.diagnostics:
        sys.stderr.write(f"[{tag}] diagnostics: "
                         f"{json.dumps(res.diagnostics, indent=2)}\n")


def _smoke(device: str = "cuda") -> int:
    """Loopback BSP must be bit-exact with in-process BSP."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="loopback_") as tmp:
        res = launch_loopback(client_sets=((0,), (1,)), n_rounds=3,
                              timeout=240.0, workdir=tmp, device=device)
    if not res.ok:
        _dump_failures("smoke", res)
        return 1

    # Both client processes must agree on the final state...
    sums = [p.result["checksums"] for p in res.clients]
    if sums[0] != sums[1]:
        sys.stderr.write(f"[smoke] client checksums disagree: {sums}\n")
        return 1

    # ...and match an in-process reference run exactly.
    ref_sums = _reference_run(3, device=device)["checksums"]
    if ref_sums != sums[0]:
        sys.stderr.write(f"[smoke] loopback != in-process: "
                         f"{sums[0]} vs {ref_sums}\n")
        return 1
    dt = time.perf_counter() - t0
    print(f"loopback smoke OK: 1 server + 2 client procs, BSP bit-exact "
          f"with in-process ({dt:.1f}s)")
    return 0


def failover_plan():
    """The failover smoke's chaos plan: connection ordinal 0 (the first
    worker to reach the proxy) loses the connection instead of delivering
    its round-1 push (frame 5); every connection's round-0 pull (frame 2)
    is delayed.  A reconnected connection gets a fresh ordinal, so the
    drop fires exactly once."""
    from repro_torch.core.fault import FaultEvent, FaultPlan
    return FaultPlan.scripted(
        FaultEvent("conn_drop", client=0, start=5, stop=6, period=1),
        FaultEvent("delay", client=-1, start=2, stop=3, period=1,
                   magnitude=0.02))


def _failover_smoke(device: str = "cuda") -> int:
    """BSP through chaos proxies with a connection drop on the push path,
    one shard-process restart from its snapshot and one worker-process
    kill-and-rejoin: still bit-exact with the undisturbed in-process
    run."""

    t0 = time.perf_counter()
    n_rounds = 6
    with tempfile.TemporaryDirectory(prefix="failover_") as tmp:
        res = launch_failover(client_sets=((0,), (1,)), n_rounds=n_rounds,
                              kill_server_round=3,
                              kill_client=1, kill_client_round=2,
                              chaos_plan=failover_plan(), timeout=420.0,
                              workdir=tmp, device=device)
    if not res.ok:
        _dump_failures("failover-smoke", res)
        return 1
    if res.restarts != {"server": 1, "client": 1}:
        sys.stderr.write(f"[failover-smoke] expected exactly one shard "
                         f"and one worker restart, got {res.restarts}\n")
        return 1
    drops = sum(p["actions"]["conn_drop"] for p in res.proxies)
    if drops < 1:
        sys.stderr.write("[failover-smoke] the scheduled conn_drop never "
                         f"fired (proxies: {res.proxies})\n")
        return 1

    finals = [p for p in res.clients if p.returncode == 0 and p.result]
    sums = [p.result["checksums"] for p in finals]
    if not sums or any(s != sums[0] for s in sums):
        sys.stderr.write(f"[failover-smoke] client checksums disagree: "
                         f"{sums}\n")
        return 1
    ref_sums = _reference_run(n_rounds, device=device)["checksums"]
    if ref_sums != sums[0]:
        sys.stderr.write(f"[failover-smoke] disturbed tcp run != "
                         f"in-process: {sums[0]} vs {ref_sums}\n")
        return 1
    dt = time.perf_counter() - t0
    print(f"failover smoke OK: chaos proxy ({drops} drop), 1 shard "
          f"restart from snapshot, 1 worker kill-and-rejoin, BSP "
          f"bit-exact with in-process ({dt:.1f}s)")
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="loopback multi-process launcher (repro_torch.net)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the end-to-end parity smoke and exit")
    ap.add_argument("--failover-smoke", action="store_true",
                    help="run the chaos + kill-and-rejoin parity smoke "
                         "and exit")
    ap.add_argument("--family", default="lda")
    ap.add_argument("--vocab-size", type=int, default=64)
    ap.add_argument("--n-topics", type=int, default=4)
    ap.add_argument("--n-shards", type=int, default=1)
    ap.add_argument("--n-client-procs", type=int, default=2)
    ap.add_argument("--clients-per-proc", type=int, default=1)
    ap.add_argument("--mode", choices=("train", "stress"), default="train")
    ap.add_argument("--n-rounds", type=int, default=3)
    ap.add_argument("--tau", type=int, default=1)
    ap.add_argument("--consistency", default="bsp")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--device", default="cuda",
                    help="where every process runs: cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.smoke:
        return _smoke(args.device)
    if args.failover_smoke:
        return _failover_smoke(args.device)

    sets = tuple(
        tuple(range(i * args.clients_per_proc,
                    (i + 1) * args.clients_per_proc))
        for i in range(args.n_client_procs))
    res = launch_loopback(
        family=args.family, vocab_size=args.vocab_size,
        n_topics=args.n_topics, n_shards=args.n_shards, client_sets=sets,
        mode=args.mode, n_rounds=args.n_rounds, tau=args.tau,
        consistency=args.consistency, timeout=args.timeout,
        device=args.device)
    for p in res.servers + res.clients:
        status = "ok" if p.returncode == 0 else f"EXIT {p.returncode}"
        print(f"{p.name}: {status}")
    if not res.ok:
        _dump_failures("launch", res)
    return 0 if res.ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
