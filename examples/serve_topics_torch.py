"""Online topic inference end to end with the PyTorch/CUDA port: train →
freeze → fold new documents in through the slot-based continuous-batching
engine (the counterpart of ``examples/serve_topics.py``).

    PYTHONPATH=src python examples/serve_topics_torch.py --model lda
    PYTHONPATH=src python examples/serve_topics_torch.py --model hdp \\
        --docs 12 --sweeps 8 --service --device cpu

Trains a small model with ``repro_torch.engine.Trainer``, freezes its
shared statistics and alias tables into a
:class:`repro_torch.serve.InferenceSnapshot`, then folds held-out
documents in:

  - in process through :class:`repro_torch.serve.FoldInEngine` (admit →
    one sweep across all live slots → harvest θ_d),
  - with ``--service``, also over loopback TCP through
    ``repro_torch.serve.server`` and two ``InferenceClient`` connections
    at once, and checks that the served results equal the in-process ones
    bit for bit (a document's chain depends only on the snapshot, its
    tokens and its request seed, never on its batch-mates).

One document is also folded in through :func:`reference_fold_in` (the
training sweep with its deltas dropped) and compared bit for bit.
Everything runs on ``--device``: ``cuda`` (the default) or ``cpu``.
"""

from __future__ import annotations

import argparse
import threading
import time

import numpy as np

from repro_torch.core import family as fam_mod
from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
from repro_torch.engine import Trainer, TrainerConfig
from repro_torch.serve import (FoldInEngine, InferRequest, ServeConfig,
                               fold_in_perplexity, from_trainer,
                               reference_fold_in, result_checksum)
from repro_torch.serve.client import InferenceClient
from repro_torch.serve.engine import InferResult
from repro_torch.serve.server import InferenceServer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="lda",
                    choices=sorted(fam_mod.FAMILIES))
    ap.add_argument("--docs", type=int, default=8,
                    help="held-out documents to fold in")
    ap.add_argument("--sweeps", type=int, default=5,
                    help="local MHW sweeps per document")
    ap.add_argument("--slots", type=int, default=4,
                    help="concurrent documents per sweep")
    ap.add_argument("--rounds", type=int, default=4,
                    help="training rounds before freezing")
    ap.add_argument("--vocab", type=int, default=400)
    ap.add_argument("--topics", type=int, default=8)
    ap.add_argument("--doc-len", type=int, default=48)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--service", action="store_true",
                    help="also serve over loopback TCP with two "
                         "concurrent clients")
    args = ap.parse_args()

    fam = fam_mod.get(args.model)
    cfg = fam.config_cls(n_topics=args.topics, vocab_size=args.vocab)
    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=args.topics, vocab_size=args.vocab,
        n_docs=64 + args.docs, doc_len=args.doc_len, seed=0))

    print(f"training {args.model} (V={args.vocab}, K={args.topics}) "
          f"for {args.rounds} rounds on {args.device} ...")
    trainer = Trainer(cfg, tokens[:64], mask[:64],
                      config=TrainerConfig(layout="sorted", n_clients=1),
                      seed=0, device=args.device)
    for _ in range(args.rounds):
        trainer.step()
    snap = from_trainer(trainer, device=args.device)
    print(f"frozen snapshot: family={snap.family_name} "
          f"V={snap.vocab_size} K={snap.n_topics}")

    ho_tokens = np.asarray(tokens[64:])
    ho_mask = np.asarray(mask[64:], bool)
    lens = ho_mask.sum(axis=1).astype(int)
    reqs = [InferRequest(uid=i, tokens=ho_tokens[i, :lens[i]],
                         seed=100 + i) for i in range(args.docs)]

    scfg = ServeConfig(max_slots=args.slots, max_len=args.doc_len,
                       n_sweeps=args.sweeps)
    eng = FoldInEngine(snap, scfg, device=args.device)
    t0 = time.time()
    results = eng.run(reqs)
    dt = time.time() - t0
    print(f"folded {len(results)} docs in {dt:.1f}s "
          f"({len(results) / dt:.2f} docs/s, {eng.sweeps_run} sweeps)")
    for i in range(min(3, args.docs)):
        top = np.argsort(results[i].theta)[::-1][:3]
        print(f"  doc {i}: top topics {top.tolist()} "
              f"theta {np.round(results[i].theta[top], 3).tolist()}")

    ppl = fold_in_perplexity(
        snap, np.stack([results[i].theta for i in range(args.docs)]),
        ho_tokens[:args.docs], ho_mask[:args.docs])
    print(f"fold-in held-out perplexity: {ppl:.2f}")

    _, theta, z = reference_fold_in(snap, reqs[0].tokens, reqs[0].seed,
                                    n_sweeps=args.sweeps,
                                    max_len=args.doc_len, device=args.device)
    ref = InferResult(uid=0, theta=theta, assignments=z,
                      n_sweeps=args.sweeps)
    ok = result_checksum(ref) == result_checksum(results[0])
    print(f"reference_fold_in parity: {'bit-exact' if ok else 'DIVERGED'}")
    assert ok

    if args.service:
        server = InferenceServer(snap, scfg, device=args.device).start()
        addr = "%s:%d" % server.address
        served: dict[int, InferResult] = {}
        lock = threading.Lock()

        def client_main(part: list[InferRequest]) -> None:
            with InferenceClient(addr, timeout=300.0) as cli:
                for r in part:
                    res = cli.infer(r.uid, r.tokens, seed=r.seed)
                    with lock:
                        served[res.uid] = res

        try:
            threads = [threading.Thread(target=client_main, args=(p,))
                       for p in (reqs[0::2], reqs[1::2])]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            stats = server.stats()
        finally:
            server.close()
        agree = (len(served) == args.docs and all(
            result_checksum(served[i]) == result_checksum(results[i])
            for i in range(args.docs)))
        print(f"service over loopback: {len(served)} docs via 2 clients, "
              f"p50 {stats['latency_p50_ms']:.1f} ms, "
              f"p99 {stats['latency_p99_ms']:.1f} ms, "
              f"{'bit-exact' if agree else 'DIVERGED'} vs in-process")
        assert agree


if __name__ == "__main__":
    main()
