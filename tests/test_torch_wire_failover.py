"""The kill-and-rejoin scenario over real processes on the CPU (mirror of
``tests/test_failover_tcp.py``), and the loopback launcher's smoke.

A loopback BSP run through the chaos proxy with a connection drop on the
push path, the shard-server process killed at its round barrier and
restarted from its own snapshot, and one worker process killed mid-run
and relaunched with ``--restore`` must end with the statistics of the
undisturbed in-process run, bit for bit.
"""

from __future__ import annotations

import pytest

from repro_torch.core.fault import FaultEvent, FaultPlan
from repro_torch.launch import loopback
from repro_torch.launch.loopback import _reference_run, launch_failover

N_ROUNDS = 6


def test_tcp_kill_and_rejoin_bsp_bitexact(tmp_path):
    plan = FaultPlan.scripted(
        # The first worker connection loses its round-1 push (frame 5).
        FaultEvent("conn_drop", client=0, start=5, stop=6, period=1))
    res = launch_failover(
        client_sets=((0,), (1,)), n_rounds=N_ROUNDS,
        kill_server_round=3,                  # shard dies at round 3
        kill_client=1, kill_client_round=2,   # worker dies after round 2
        chaos_plan=plan, timeout=300.0, workdir=str(tmp_path),
        device="cpu")
    assert res.ok, [(p.name, p.returncode, p.stderr[-2000:])
                    for p in res.failures()] + [res.diagnostics]
    assert res.restarts == {"server": 1, "client": 1}
    killed = [p.name for p in res.servers + res.clients if p.expected]
    assert sorted(killed) == ["client1#killed", "server#killed"]
    assert sum(p["actions"]["conn_drop"] for p in res.proxies) == 1
    finals = [p.result for p in res.clients
              if p.returncode == 0 and p.result]
    assert len(finals) == 2
    ref = _reference_run(N_ROUNDS, device="cpu")
    for r in finals:
        assert r["checksums"] == ref["checksums"]
        assert r["device"] == "cpu" and r["launches"] == {}
    assert finals[0]["perplexity"] == pytest.approx(ref["perplexity"])
    restored = next(r for r in finals if r["restored"])
    assert restored["rounds_done"] == N_ROUNDS - 2


def test_loopback_smoke_on_the_cpu(capsys):
    """``python -m repro_torch.launch.loopback --smoke --device cpu``: one
    shard process, two worker processes, bit-exact with in-process."""
    assert loopback.main(["--smoke", "--device", "cpu"]) == 0
    assert "BSP bit-exact with in-process" in capsys.readouterr().out
