"""Time the alias builds of the PyTorch/CUDA port, for one or more
checkouts of the repo on one card: the full builds, kernel 2
(``alias_build``) and kernel 6 (``alias_build_fused``), and the
incremental ones, kernel 3 (``alias_build_gather_fused``) and kernel 5
(``alias_build_rows``).

Usage (on a machine with a CUDA card, nvcc and PyTorch built for CUDA):

    python3 tools/torch_alias_split.py [ROOT ...]

Each ROOT is a directory holding ``src/repro_torch/csrc/alias_build.cu``
(default: this checkout); giving the roots in the order parent, change,
change, parent compares two versions on one card.  The tool compiles every
root's source at once with this checkout's nvcc flags into
``build/alias_split/``, loads its four C entry points with ctypes, and
times them in one process on the same inputs, with this checkout's
``chip_smoke.time_ms``, from chip_smoke.py's corpus:

* kernel 2 on the LDA dense term (131072×1024) and on the PDP dense term
  (131072×2048) at the trainers' initial state, and kernel 6 on the LDA
  statistics;
* kernel 3 on the R rows of LDA's n_wk with the largest counts, with
  LDA's prior α·1, and on the R rows of an HDP trainer's n_wk that drifted
  most in its first round, with its prior b1·θ0;
* kernel 5 on the R rows of the PDP dense term with the largest m_wk +
  s_wk mass (the compacted block, width 2048);

each incremental build at R = 64 (the trainer's default
``alias_rebuild_rows``), 512 and 4096 (chip_smoke.py's).  Each case is
timed three ways: ``ms``, CUDA events around a call (``chip_smoke.time_ms``,
which counts the host's work of queuing the launch); ``device_ms``, the
kernel alone on the device's clock, from its profiler records
(``chip_smoke.device_ms``); and ``enqueue_us``, the host microseconds a
call takes to queue it.  Each root's
outputs are compared with the plain version's (``core.alias.build``,
``kernels/ref.py``) and reported as ``bit_equal``;
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


ROWS = (64, 512, 4096)


def main(argv: list[str]) -> int:
    sys.path.insert(0, str(HERE))
    import chip_smoke                   # puts this checkout's src on the path
    import torch

    from repro_torch.core import alias as alias_mod
    from repro_torch.core import hdp, lda, pdp
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
    top = max(ROWS)

    def top_rows(score):
        return torch.argsort(-score, stable=True)[:top].to(torch.int32)

    ccfg = CorpusConfig(n_topics=64, vocab_size=131072, n_docs=65536,
                        doc_len=256, seed=0)
    tokens, mask, _ = make_topic_corpus(ccfg)
    tcfg = TrainerConfig(layout="sorted", n_clients=2, consistency="bsp")
    cfg = lda.LDAConfig(n_topics=1024, vocab_size=131072)
    v, k = cfg.vocab_size, cfg.n_topics
    tr = Trainer(cfg, tokens, mask, config=tcfg, seed=0, device=dev)
    n_wk, n_k = tr.shared.n_wk, tr.shared.n_k
    dp_lda = lda.dense_probs(cfg, tr.shared)
    del tr
    pcfg = pdp.PDPConfig(n_topics=1024, vocab_size=131072)
    tr = Trainer(pcfg, tokens, mask, config=tcfg, seed=0, device=dev)
    dp_pdp = pdp.dense_probs(pcfg, tr.shared)
    rows_pdp = top_rows((tr.shared.m_wk + tr.shared.s_wk).sum(1))
    del tr
    hcfg = hdp.HDPConfig(n_topics=1024, vocab_size=131072)
    tr = Trainer(hcfg, tokens, mask, config=tcfg, seed=0, device=dev)
    before = tr.shared.n_wk.clone()
    tr.step()                      # θ0 resampled from the CRT table counts
    h_wk, h_k = tr.shared.n_wk, tr.shared.n_k
    rows_hdp = top_rows((h_wk - before).abs().sum(1))
    prior_hdp = tr.family.sparse_prior(hcfg, tr.shared)
    del tr, before
    torch.cuda.empty_cache()
    hyper = dict(alpha=cfg.alpha, beta=cfg.beta, beta_bar=cfg.beta * v)
    stream = torch.cuda.current_stream

    def outputs(r, width, with_dense=False):
        """prob, alias, mass (and kernel 3's dense rows)."""
        out = [torch.empty((r, width), dtype=torch.float32, device=dev),
               torch.empty((r, width), dtype=torch.int32, device=dev),
               torch.empty((r,), dtype=torch.float32, device=dev)]
        if with_dense:
            out.append(torch.empty((r, width), dtype=torch.float32,
                                   device=dev))
        return out

    def dense(fn, p):
        def run():
            r, width = p.shape
            out = outputs(r, width)
            err = fn(p.data_ptr(), r, width, *(t.data_ptr() for t in out),
                     stream().cuda_stream)
            if err:
                raise RuntimeError(f"alias build failed: error {err}")
            return out
        return run

    def fused(fn):
        def run():
            out = outputs(v, k)
            err = fn(n_wk.data_ptr(), n_k.data_ptr(), v, k, hyper["alpha"],
                     hyper["beta"], hyper["beta_bar"],
                     *(t.data_ptr() for t in out), stream().cuda_stream)
            if err:
                raise RuntimeError(f"alias_build_fused failed: error {err}")
            return out
        return run

    def gather(fn, wk, nk, prior, rows, beta):
        def run():
            r = rows.shape[0]
            out = outputs(r, k, with_dense=True)
            err = fn(wk.data_ptr(), nk.data_ptr(), prior.data_ptr(),
                     rows.data_ptr(), r, k, beta, beta * v,
                     *(t.data_ptr() for t in out), stream().cuda_stream)
            if err:
                raise RuntimeError(f"alias_build_gather_fused failed: "
                                   f"error {err}")
            return out
        return run

    prior_lda = torch.full((k,), cfg.alpha, dtype=torch.float32, device=dev)
    k3_inputs = {"lda": (n_wk, n_k, prior_lda, top_rows(n_wk.sum(1)),
                         cfg.beta),
                 "hdp": (h_wk, h_k, prior_hdp, rows_hdp, hcfg.beta)}
    want = {"k2_lda_1024": alias_mod.build(dp_lda),
            "k2_pdp_2048": alias_mod.build(dp_pdp),
            "k6_lda_1024": ref.alias_build_fused_ref(
                n_wk, n_k, alpha=cfg.alpha, beta=cfg.beta,
                vocab_size=cfg.vocab_size)}
    blocks = {r: dp_pdp[rows_pdp[:r].long()] for r in ROWS}
    for r in ROWS:
        for name, (wk, nk, prior, rows, beta) in k3_inputs.items():
            want[f"k3_{name}_R{r}"] = ref.alias_build_gather_fused_ref(
                wk, nk, prior, rows[:r], beta=beta, beta_bar=beta * v)
        want[f"k5_pdp_R{r}"] = alias_mod.build(blocks[r])
    results = []
    for root, lib in zip(roots, libs):
        k2, k6 = entry(lib, "alias_build"), entry(lib, "alias_build_fused")
        k3 = entry(lib, "alias_build_gather_fused")
        k5 = entry(lib, "alias_build_rows")
        runs = {"k2_lda_1024": dense(k2, dp_lda),
                "k2_pdp_2048": dense(k2, dp_pdp),
                "k6_lda_1024": fused(k6)}
        for r in ROWS:
            for name, (wk, nk, prior, rows, beta) in k3_inputs.items():
                runs[f"k3_{name}_R{r}"] = gather(k3, wk, nk, prior,
                                                 rows[:r].contiguous(), beta)
            runs[f"k5_pdp_R{r}"] = dense(k5, blocks[r])
        out = {"root": str(root), "card": card}
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, want[name]))
            del got
            reps = 5 if name[:2] in ("k2", "k6") else 20
            out[name] = {"ms": chip_smoke.time_ms(run, reps),
                         "device_ms": chip_smoke.device_ms(run, reps),
                         "enqueue_us": chip_smoke.enqueue_us(run),
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
