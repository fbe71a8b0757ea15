"""Time the two sweep kernels of the PyTorch/CUDA port on one full chunk,
with and without their MH steps, for one or more checkouts of the repo.

Usage (on a machine with a CUDA card, nvcc and PyTorch built for CUDA):

    python3 tools/torch_sweep_split.py [ROOT ...]

Each ROOT is the root of a checkout (default: this one); giving the same
roots in the order parent, change, change, parent compares two versions
on one card.  Each root runs in a process of its own (the package names
collide): it builds that checkout's kernels, makes chip_smoke.py's corpus
(K=1024, V=131072, 65,536 documents of 256 tokens), sets up the LDA and
then the PDP trainer (two clients, BSP) at their initial state, and times
kernel 1 (``mhw_sweep_fused``) and kernel 4 (``pdp_sweep_fused``) on
client 0's first sorted chunk (2,097,152 positions) with this checkout's
``chip_smoke.split_ms`` (S = mh_steps uniform rows, and S = 0) and
reports the chunk with its ``chip_smoke.chunk_figures``: the measuring
code is this checkout's for every root, only the kernels are the root's.
Each root's result is one ``SPLIT`` JSON line; all of them also go to
chiprun_out/sweep_split.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def worker(root: Path) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke                   # puts this checkout's src on the path
    sys.path.insert(0, str(root / "src"))   # ... behind the root's
    import torch

    from repro_torch.core import lda, pdp, stirling
    from repro_torch.data import segment
    from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
    from repro_torch.engine import Trainer, TrainerConfig
    from repro_torch.kernels import _build
    from repro_torch.kernels import mhw_fused as kmf

    dev = torch.device("cuda")
    _build.build_all()
    ccfg = CorpusConfig(n_topics=64, vocab_size=131072, n_docs=65536,
                        doc_len=256, seed=0)
    tokens, mask, _ = make_topic_corpus(ccfg)
    tcfg = TrainerConfig(layout="sorted", n_clients=2, consistency="bsp")
    out = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)

    def chunk(tr, cfg):
        lay = tr.layouts[0][0]
        bounds = segment.chunk_bounds(ccfg.doc_len, cfg.sorted_chunks)
        e = tr.family.encode(cfg, tr.locals_[0])[:, bounds[0]:bounds[1]]
        return lay, segment.sort_values(lay, e.reshape(-1))

    cfg = lda.LDAConfig(n_topics=1024, vocab_size=131072)
    tr = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
    tables, stale = tr.family.build_alias(cfg, tr.shared)
    shared, n_dk = tr.shared, tr.locals_[0].n_dk
    lay, z = chunk(tr, cfg)
    prior = tr.family.sparse_prior(cfg, shared)
    ms = chip_smoke.split_ms(lambda uni: kmf.mhw_sweep_fused(
        *tables, stale, shared.n_wk, shared.n_k, prior, lay.rows, lay.docs,
        z, n_dk, *uni, beta=cfg.beta, beta_bar=cfg.beta * cfg.vocab_size),
        gen, dev, cfg.n_topics, cfg.mh_steps, lay.rows.shape[0])
    out["mhw_sweep_fused"] = {f"ms_S{s}": t for s, t in ms.items()}
    out["lda_chunk"] = chip_smoke.chunk_figures(lay.rows, lay.docs, n_dk,
                                                cfg.vocab_size)
    del tr, tables, stale, shared, n_dk, lay, z
    torch.cuda.empty_cache()

    pcfg = pdp.PDPConfig(n_topics=1024, vocab_size=131072)
    tr = Trainer(pcfg, tokens, mask, config=tcfg, seed=0, device=dev)
    shared, n_dk = tr.shared, tr.locals_[0].n_dk
    tables, stale = tr.family.build_alias(pcfg, shared)
    lay, e = chunk(tr, pcfg)
    stirl = stirling.as_tensor(pcfg.stirling_n_max, pcfg.discount, dev)
    prior = tr.family.sparse_prior(pcfg, shared)
    ms = chip_smoke.split_ms(lambda uni: kmf.pdp_sweep_fused(
        *tables, stale, shared.m_wk, shared.s_wk, shared.m_k, shared.s_k,
        stirl, prior, lay.rows, lay.docs, e, n_dk, *uni,
        b=pcfg.concentration, a=pcfg.discount, gamma=pcfg.gamma,
        gamma_bar=pcfg.gamma * pcfg.vocab_size),
        gen, dev, 2 * pcfg.n_topics, pcfg.mh_steps, lay.rows.shape[0])
    out["pdp_sweep_fused"] = {f"ms_S{s}": t for s, t in ms.items()}
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--worker"]:
        print("SPLIT " + json.dumps(worker(Path(argv[1]).resolve())),
              flush=True)
        return 0
    roots = argv or [str(HERE)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"CARD {card}", flush=True)
    results = []
    for root in roots:
        proc = subprocess.run([sys.executable, __file__, "--worker", root],
                              capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            raise SystemExit(f"{root}: exit {proc.returncode}")
        line = next(x for x in proc.stdout.splitlines()
                    if x.startswith("SPLIT "))
        print(line, flush=True)
        results.append(json.loads(line[6:]))
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "sweep_split.json").write_text(json.dumps(
        {"card": card, "runs": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
