"""Time the full alias builds of the PyTorch/CUDA port, kernel 2
(``alias_build``) and kernel 6 (``alias_build_fused``), for one or more
checkouts of the repo on one card.

Usage (on a machine with a CUDA card, nvcc and PyTorch built for CUDA):

    python3 tools/torch_alias_split.py [ROOT ...]

Each ROOT is a directory holding ``src/repro_torch/csrc/alias_build.cu``
(default: this checkout); giving the roots in the order parent, change,
change, parent compares two versions on one card.  The tool compiles every
root's source at once with this checkout's nvcc flags into
``build/alias_split/``, loads its ``alias_build`` and ``alias_build_fused``
C entry points with ctypes, and times them in one process on the same
inputs, with this checkout's ``chip_smoke.time_ms``: kernel 2 on the LDA
dense term (131072×1024) and on the PDP dense term (131072×2048) of
chip_smoke.py's corpus at the trainers' initial state, and kernel 6 on the
LDA statistics.  Each root's tables are compared with the plain version's
(``core.alias.build``, ``kernels/ref.py``) and reported as ``bit_equal``;
a copy ablated on purpose may differ.  Each root's result is one
``ALIAS_SPLIT`` JSON line; all of them also go to
chiprun_out/alias_split.json.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
SOURCE = Path("src") / "repro_torch" / "csrc" / "alias_build.cu"


def build(roots: list[Path]) -> list[Path]:
    """Compile each root's alias_build.cu, all at once; the libraries."""
    from repro_torch.kernels import _build

    out_dir = HERE / "build" / "alias_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = []
    for n, root in enumerate(roots):
        src = root / SOURCE
        digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
        lib = out_dir / f"{n}-{digest}.so"
        jobs.append((lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {lib.name}:\n{log}")
    return [lib for lib, _ in jobs]


def entry(lib: ctypes.CDLL, name: str):
    from repro_torch.kernels import _build

    fn = getattr(lib, name)
    fn.argtypes = _build.SIGNATURES[name][1]
    fn.restype = ctypes.c_int
    return fn


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(HERE))
    import chip_smoke                   # puts this checkout's src on the path
    import torch

    from repro_torch.core import alias as alias_mod
    from repro_torch.core import lda, pdp
    from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
    from repro_torch.engine import Trainer, TrainerConfig
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        raise SystemExit("torch_alias_split: no CUDA device")
    roots = [Path(r).resolve() for r in (argv or [str(HERE)])]
    card = chip_smoke.card_line()
    print(f"CARD {card}", flush=True)
    libs = [ctypes.CDLL(str(lib)) for lib in build(roots)]
    dev = torch.device("cuda")

    ccfg = CorpusConfig(n_topics=64, vocab_size=131072, n_docs=65536,
                        doc_len=256, seed=0)
    tokens, mask, _ = make_topic_corpus(ccfg)
    tcfg = TrainerConfig(layout="sorted", n_clients=2, consistency="bsp")
    cfg = lda.LDAConfig(n_topics=1024, vocab_size=131072)
    tr = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
    n_wk, n_k = tr.shared.n_wk, tr.shared.n_k
    dp_lda = lda.dense_probs(cfg, tr.shared)
    del tr
    pcfg = pdp.PDPConfig(n_topics=1024, vocab_size=131072)
    tr = Trainer(pcfg, tokens, mask, config=tcfg, seed=0, device=dev)
    dp_pdp = pdp.dense_probs(pcfg, tr.shared)
    del tr
    torch.cuda.empty_cache()
    hyper = dict(alpha=cfg.alpha, beta=cfg.beta,
                 beta_bar=cfg.beta * cfg.vocab_size)

    def dense(fn, p):
        def run():
            r, k = p.shape
            prob = torch.empty((r, k), dtype=torch.float32, device=dev)
            alias = torch.empty((r, k), dtype=torch.int32, device=dev)
            mass = torch.empty((r,), dtype=torch.float32, device=dev)
            err = fn(p.data_ptr(), r, k, prob.data_ptr(), alias.data_ptr(),
                     mass.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"alias_build failed: error {err}")
            return prob, alias, mass
        return run

    def fused(fn):
        def run():
            v, k = n_wk.shape
            prob = torch.empty((v, k), dtype=torch.float32, device=dev)
            alias = torch.empty((v, k), dtype=torch.int32, device=dev)
            mass = torch.empty((v,), dtype=torch.float32, device=dev)
            err = fn(n_wk.data_ptr(), n_k.data_ptr(), v, k, hyper["alpha"],
                     hyper["beta"], hyper["beta_bar"], prob.data_ptr(),
                     alias.data_ptr(), mass.data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"alias_build_fused failed: error {err}")
            return prob, alias, mass
        return run

    want = {"k2_lda_1024": alias_mod.build(dp_lda),
            "k2_pdp_2048": alias_mod.build(dp_pdp),
            "k6_lda_1024": ref.alias_build_fused_ref(
                n_wk, n_k, alpha=cfg.alpha, beta=cfg.beta,
                vocab_size=cfg.vocab_size)}
    results = []
    for root, lib in zip(roots, libs):
        k2, k6 = entry(lib, "alias_build"), entry(lib, "alias_build_fused")
        runs = {"k2_lda_1024": dense(k2, dp_lda),
                "k2_pdp_2048": dense(k2, dp_pdp),
                "k6_lda_1024": fused(k6)}
        out = {"root": str(root), "card": card}
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, want[name]))
            del got
            out[name] = {"ms": chip_smoke.time_ms(run, 5),
                         "bit_equal": equal}
        print("ALIAS_SPLIT " + json.dumps(out), flush=True)
        results.append(out)
    save = HERE / "chiprun_out"
    save.mkdir(exist_ok=True)
    (save / "alias_split.json").write_text(json.dumps(
        {"card": card, "runs": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
