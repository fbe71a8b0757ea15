"""End-to-end example of the PyTorch/CUDA port (the counterpart of
``examples/distributed_lvm.py``): the paper's distributed system —
multi-client parameter-server inference for LDA / PDP / HDP with eventual
consistency, communication filters, constraint projection, snapshots and
failover — through the port's ``engine.Trainer``.

    PYTHONPATH=src python examples/distributed_lvm_torch.py --model pdp \\
        --clients 4
    PYTHONPATH=src python examples/distributed_lvm_torch.py --model lda \\
        --filter topk --fail-client 1
    PYTHONPATH=src python examples/distributed_lvm_torch.py --model hdp \\
        --layout sorted --device cpu

The multi-process form of the same rounds is
``repro_torch.core.distributed.make_round_fn`` on a process mesh that
``repro_torch.launch.mesh.run_on_mesh`` starts (clients = ranks of the
``data`` axis, the server's rows laid over the ``model`` axis); this
example drives the same logic client by client in one process, and
exercises:

  - τ local sweeps against a frozen snapshot (bounded staleness, §5.2-5.3),
  - the parameter server with a pluggable consistency policy
    (``--consistency bsp|ssp:2|async``) over vocabulary-sharded state
    (``--server-shards``),
  - the position-scan or the token-sorted layout (``--layout``),
  - magnitude-priority + uniform-sampling delta filters (§5.3),
  - constraint projection on shared and client-local polytopes (§5.5),
  - fault injection with kill-and-rejoin recovery from periodic
    snapshots (``--fail-client`` builds a ``core.fault.FaultPlan`` crash
    window and turns on ``snapshot_every``, so the crashed client rejoins
    mid-run by restoring its locals and taking a forced-fresh pull —
    §5.4; ``--chaos-seed`` gives a seeded-random multi-fault plan).

Every round runs on ``--device``: ``cuda`` (the default) or ``cpu``.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

from repro_torch.checkpoint import ckpt
from repro_torch.core import hdp, lda, pdp, ps
from repro_torch.core.fault import FaultPlan
from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
from repro_torch.engine import Trainer, TrainerConfig


def main(argv: list[str] | None = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["lda", "pdp", "hdp"], default="pdp")
    ap.add_argument("--layout", choices=["scan", "sorted"], default="scan")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=12)
    ap.add_argument("--tau", type=int, default=2,
                    help="local sweeps per sync round (staleness)")
    ap.add_argument("--consistency", default="bsp",
                    help="server policy: bsp | ssp:<bound> | async")
    ap.add_argument("--server-shards", type=int, default=1,
                    help="vocabulary shards of the server's canonical "
                         "statistics")
    ap.add_argument("--filter", choices=["dense", "topk"], default="dense")
    ap.add_argument("--fail-client", type=int, default=-1,
                    help="client id to crash mid-run and rejoin from its "
                         "snapshot (§5.4 kill-and-rejoin demo)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="seeded-random multi-fault plan (crashes, "
                         "stragglers, lost pushes, failed pulls)")
    ap.add_argument("--snapshot-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the rounds run: cuda (default) or cpu")
    args = ap.parse_args(argv)

    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=8, vocab_size=400, n_docs=256, doc_len=64, seed=0))

    if args.model == "lda":
        cfg = lda.LDAConfig(n_topics=8, vocab_size=400, mh_steps=2)
    elif args.model == "pdp":
        cfg = pdp.PDPConfig(n_topics=8, vocab_size=400, alpha=0.1,
                            discount=0.1, concentration=5.0, mh_steps=4,
                            stirling_n_max=256)
    else:
        cfg = hdp.HDPConfig(n_topics=16, vocab_size=400, b0=1.0, b1=2.0,
                            mh_steps=4)

    fspec = (ps.FilterSpec(kind="topk", k_rows=50, random_rows=12)
             if args.filter == "topk" else ps.FilterSpec())
    plan = None
    if args.chaos_seed is not None:
        plan = FaultPlan.random(args.chaos_seed, args.clients, args.rounds,
                                p_crash=0.05, p_straggle=0.05,
                                p_lost_push=0.05, p_failed_pull=0.03)
    elif args.fail_client >= 0:
        plan = FaultPlan.crash(args.fail_client, args.rounds // 3,
                               2 * args.rounds // 3)
    # Periodic snapshots back the rejoin protocol (and Trainer.restore).
    snap_dir = args.snapshot_dir or tempfile.mkdtemp(prefix="lvm_snap_")

    print(f"model={args.model} layout={args.layout} clients={args.clients} "
          f"tau={args.tau} consistency={args.consistency} "
          f"server_shards={args.server_shards} filter={args.filter} "
          f"faults={len(plan.events) if plan else 0} device={args.device} "
          f"snapshots={snap_dir}")
    t0 = time.time()
    trainer = Trainer(cfg, tokens, mask, device=args.device,
                      config=TrainerConfig(
                          layout=args.layout, n_clients=args.clients,
                          tau=args.tau, consistency=args.consistency,
                          n_server_shards=args.server_shards, filter=fspec,
                          fault_plan=plan,
                          snapshot_every=max(2, args.rounds // 4),
                          snapshot_dir=snap_dir))
    res = trainer.run(args.rounds, eval_every=max(1, args.rounds // 6))
    for i, ppl in enumerate(res.perplexities):
        print(f"eval {i}: perplexity={ppl:9.2f}"
              f"  violations={res.violations[i]:.0f}")
    if plan:
        print(f"rejoins={trainer.rejoins} pull_failures="
              f"{trainer.pull_failures}")
    print(f"total {time.time() - t0:.1f}s, "
          f"~{res.tokens_per_s / 1e3:.1f}k tokens/s/round")

    # Record the run's summary curves next to the Trainer's snapshots.
    path = ckpt.save(snap_dir, f"{args.model}_run", args.rounds, {
        "perplexities": np.asarray(res.perplexities),
        "iter_times": np.asarray(res.iter_times),
    })
    print(f"snapshot written: {path}")
    return res


if __name__ == "__main__":
    main()
