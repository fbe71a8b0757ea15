"""Quickstart for the PyTorch/CUDA port: the unified ModelFamily + Trainer
API on a synthetic power-law corpus (the counterpart of
``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --model pdp
    PYTHONPATH=src python examples/quickstart_torch.py --model hdp \\
        --layout sorted
    PYTHONPATH=src python examples/quickstart_torch.py --method exact \\
        --iters 4 --device cpu

Corpus → model config → ``repro_torch.engine.Trainer`` (pull → sample →
filter → push → project rounds) → held-out perplexity, topics/word and
the consistency check.  ``--layout scan`` (the default) runs the
position scan, with MHW's dense draws and accepts on kernels 8 and 9 on
the card; ``--method exact`` is the full-conditional sampler, scan layout
only.  ``--layout sorted`` runs the token-sorted sweep kernels.  Every
round runs on ``--device``: ``cuda`` (the default) or ``cpu``.
"""

from __future__ import annotations

import argparse

from repro_torch.core import hdp, lda, pdp
from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
from repro_torch.engine import Trainer, TrainerConfig


def model_config(model: str, topics: int, vocab: int):
    """The reference quickstart's hyperparameters.  K is taken as given
    (for HDP the truncation level)."""
    if model == "lda":
        return lda.LDAConfig(n_topics=topics, vocab_size=vocab, alpha=0.1,
                             beta=0.01, mh_steps=2)
    if model == "pdp":
        return pdp.PDPConfig(n_topics=topics, vocab_size=vocab, alpha=0.1,
                             discount=0.1, concentration=5.0, mh_steps=4,
                             stirling_n_max=256)
    return hdp.HDPConfig(n_topics=topics, vocab_size=vocab, b0=1.0,
                         b1=2.0, mh_steps=4)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=["lda", "pdp", "hdp"], default="lda")
    ap.add_argument("--layout", choices=["scan", "sorted"], default="scan")
    ap.add_argument("--method", choices=["mhw", "exact"], default="mhw")
    ap.add_argument("--topics", type=int, default=8)
    ap.add_argument("--vocab", type=int, default=500)
    ap.add_argument("--docs", type=int, default=256)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--clients", type=int, default=1)
    ap.add_argument("--alias-refresh-every", type=int, default=2,
                    help="rounds between alias-table rebuilds (staleness)")
    ap.add_argument("--device", default="cuda",
                    help="where the rounds run: cuda (default) or cpu")
    args = ap.parse_args(argv)

    tokens, mask, _ = make_topic_corpus(CorpusConfig(
        n_topics=args.topics, vocab_size=args.vocab, n_docs=args.docs,
        doc_len=64, seed=0))
    n_tokens = int(mask.sum())
    cfg = model_config(args.model, args.topics, args.vocab)
    print(f"corpus: {args.docs} docs, {n_tokens} tokens, V={args.vocab}, "
          f"K={cfg.n_topics}, model={args.model}, layout={args.layout}, "
          f"method={args.method}, device={args.device}")
    trainer = Trainer(cfg, tokens, mask, config=TrainerConfig(
        layout=args.layout, method=args.method, n_clients=args.clients,
        alias_refresh_every=args.alias_refresh_every), seed=0,
        device=args.device)

    eval_every = max(1, args.iters // 4)
    res = trainer.run(args.iters, eval_every=eval_every, eval_docs=32)
    for i, ppl in enumerate(res.perplexities):
        tpw = res.topics_per_word[i]
        print(f"eval {i}: perplexity={ppl:8.2f}  topics/word={tpw:5.2f}")
    print(f"throughput: {res.tokens_per_s / 1e3:8.1f}k tokens/s")

    err = trainer.consistency_error()
    print("done — sufficient-statistics consistency:",
          "OK" if err == 0.0 else f"VIOLATED (max err {err})")


if __name__ == "__main__":
    main()
