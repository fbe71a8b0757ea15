"""Time the training rounds of the PyTorch/CUDA port, for one or more
checkouts of the repo on one card: LDA, PDP and HDP, each in cadence and
in incremental mode, as chip_smoke.py trains them.

Usage (on a machine with a CUDA card, nvcc and PyTorch built for CUDA):

    python3 tools/torch_round_split.py [ROOT ...]

Each ROOT is the root of a checkout (default: this one); giving the same
roots in the order parent, change, change, parent compares two versions
on one card.  Each root runs in a process of its own (the package names
collide): it builds that checkout's kernels, makes chip_smoke.py's corpus
(K=1024, V=131072, 65,536 documents of 256 tokens, 12,605,194 tokens) and
trains each family at chip_smoke.py's settings (two clients, BSP; the
incremental mode rebuilds the 4,096 most drifted rows a round and the
whole table every 16 rounds) for ``WARM`` rounds and then ``TIMED``
rounds, each on the host's clock closed by ``torch.cuda.synchronize()``.
The first incremental round builds its tables in full, so only the timed
rounds, all incremental, are reported: their median and each one.  The
counts must stay exact (``consistency_error() == 0.0``) after the last.
The trainer code and the kernels are the root's; the settings and the
timing are this checkout's.  Each root's result is one ``ROUNDS`` JSON
line; all of them also go to chiprun_out/round_split.json.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
WARM = 2
TIMED = 8


def worker(root: Path) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke                   # puts this checkout's src on the path
    sys.path.insert(0, str(root / "src"))   # ... behind the root's
    import torch

    from repro_torch.core import hdp, lda, pdp
    from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
    from repro_torch.engine import Trainer, TrainerConfig
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    _build.build_all()
    ccfg = CorpusConfig(n_topics=64, vocab_size=131072, n_docs=65536,
                        doc_len=256, seed=0)
    tokens, mask, _ = make_topic_corpus(ccfg)
    modes = {
        "cadence": TrainerConfig(layout="sorted", n_clients=2,
                                 consistency="bsp"),
        "incremental": TrainerConfig(
            layout="sorted", n_clients=2, consistency="bsp",
            alias_rebuild_threshold=0.0,
            alias_rebuild_rows=chip_smoke.GATHER_ROWS,
            alias_full_rebuild_every=16)}
    families = {"lda": lda.LDAConfig(n_topics=1024, vocab_size=131072),
                "pdp": pdp.PDPConfig(n_topics=1024, vocab_size=131072),
                "hdp": hdp.HDPConfig(n_topics=1024, vocab_size=131072)}
    out = {"root": str(root), "card": torch.cuda.get_device_name(0),
           "tokens": int(mask.sum())}
    for fam, cfg in families.items():
        for mode, tcfg in modes.items():
            tr = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
            ms = []
            for rnd in range(WARM + TIMED):
                torch.cuda.synchronize()
                t = time.perf_counter()
                tr.step()
                torch.cuda.synchronize()
                if rnd >= WARM:
                    ms.append((time.perf_counter() - t) * 1e3)
            err = tr.consistency_error()
            if err != 0.0:
                raise AssertionError(f"{fam} {mode}: consistency {err}")
            out[f"{fam}_{mode}"] = {"median_ms": statistics.median(ms),
                                    "round_ms": ms}
            del tr
            torch.cuda.empty_cache()
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--worker"]:
        print("ROUNDS " + json.dumps(worker(Path(argv[1]).resolve())),
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
                    if x.startswith("ROUNDS "))
        print(line, flush=True)
        results.append(json.loads(line[7:]))
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "round_split.json").write_text(json.dumps(
        {"card": card, "runs": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
