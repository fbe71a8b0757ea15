"""Time the document-list build and the draw kernels of the PyTorch/CUDA
port, for one or more checkouts of the repo on one card: the list build
that runs before every sweep launch (``csrc/doc_topics.cu``), kernel 7
(``alias_sample_sorted``), kernel 8 (``alias_sample``) and kernel 9
(``mh_accept``).

Usage (on a machine with a CUDA card, nvcc and PyTorch built for CUDA):

    python3 tools/torch_kernel_split.py [ROOT ...]

Each ROOT is a directory holding ``src/repro_torch/csrc/doc_topics.cu``
(with its ``sweep_common.cuh``), ``alias_sample.cu`` and ``mh_accept.cu``
(default: this checkout); giving the roots in the order parent, change,
change, parent compares two versions on one card.  The tool compiles every
root's sources at once with this checkout's nvcc flags into
``build/kernel_split/``, loads their C entry points with ctypes, and times
them in one process on the same inputs, from chip_smoke.py's corpus and
trainer settings:

* the list build on client 0's n_dk of an LDA trainer at its initial
  state (32,768 × 1024, the shape each sweep launch of the smoke reads);
* kernels 7, 8 and 9 on chip_smoke.py's draws chunk
  (``chip_smoke.draw_inputs``), after the three cadence rounds of fused
  LDA that precede it in the smoke: the sorted draws, the same draws
  shuffled, and the Metropolis step; and kernel 8's entry on the sorted
  draws (``alias_sample_on_sorted``), to compare its body with kernel 7's
  on kernel 7's input.

Each case is timed three ways: ``ms``, CUDA events around a call
(``chip_smoke.time_ms``); ``device_ms``, the kernel alone on the device's
clock, from its profiler records (``chip_smoke.device_ms``); and
``enqueue_us``, the host microseconds a call takes to queue it.  Each
output is compared with the plain version's (``kernels/ref.py``; the
list counts up to each document's k_d) and reported as ``bit_equal``.
The inputs' figures come first, on a ``FIGURES`` line: the bytes each
function must move, and for kernels 7 and 8 the bytes a card with 32-byte
sectors moves at least (``chip_smoke.draw_bytes``), each with its time at
3.35 TB/s, and the real draws and those that read the alias table (the
gathers kernels 7 and 8 issue).  Each root's result is one ``KERNEL_SPLIT`` JSON line.  Last, a
``GATHERS`` line: one PyTorch gather (``index_select``) of the real draws'
prob points in the shuffled and in the sorted order, on the device's
clock, a yardstick of what the order of the gathers costs.  All of it also
goes to chiprun_out/kernel_split.json.  About a minute for four roots,
the trainer's set-up included.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CSRC = Path("src") / "repro_torch" / "csrc"
SOURCES = ("doc_topics", "alias_sample", "mh_accept")
ROUNDS = 3                      # chip_smoke.py's fused-LDA cadence rounds


def build(roots: list[Path]) -> list[dict[str, Path]]:
    """Compile each root's sources, all at once; per root, the library of
    each source."""
    from repro_torch.kernels import _build

    out_dir = HERE / "build" / "kernel_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs, libs = [], []
    for n, root in enumerate(roots):
        libs.append({})
        for stem in SOURCES:
            src = root / CSRC / f"{stem}.cu"
            digest = hashlib.sha256(
                src.read_bytes() + b"".join(h.read_bytes() for h in sorted(
                    (root / CSRC).glob("*.cuh")))).hexdigest()[:12]
            lib = out_dir / f"{n}-{stem}-{digest}.so"
            libs[-1][stem] = lib
            jobs.append((lib, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                 str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for lib, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {lib.name}:\n{log}")
    return libs


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

    from repro_torch.core import lda
    from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
    from repro_torch.engine import Trainer, TrainerConfig
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_split: no CUDA device")
    roots = [Path(r).resolve() for r in (argv or [str(HERE)])]
    card = chip_smoke.card_line()
    print(f"CARD {card}", flush=True)
    libs = [{stem: ctypes.CDLL(str(p)) for stem, p in lib.items()}
            for lib in build(roots)]
    dev = torch.device("cuda")

    ccfg = CorpusConfig(n_topics=64, vocab_size=131072, n_docs=65536,
                        doc_len=256, seed=0)
    tokens, mask, _ = make_topic_corpus(ccfg)
    cfg = lda.LDAConfig(n_topics=1024, vocab_size=131072,
                        fused_alias_build=True)
    tr = Trainer(cfg, tokens, mask, config=TrainerConfig(
        layout="sorted", n_clients=2, consistency="bsp"), seed=0, device=dev)
    n_dk = tr.locals_[0].n_dk.clone()
    for _ in range(ROUNDS):
        tr.step()
    inp = chip_smoke.draw_inputs(dev, tr, cfg, ccfg)
    del tr
    torch.cuda.empty_cache()
    stream = torch.cuda.current_stream
    d, k = n_dk.shape
    v = cfg.vocab_size
    tables = inp["tables"]
    b = inp["rows"].shape[0]

    def lists(fn):
        def run():
            words = torch.empty((d, ref.doc_words(k), 2), dtype=torch.int32,
                                device=dev)
            counts = torch.empty((d, k), dtype=torch.int16, device=dev)
            err = fn(n_dk.data_ptr(), d, k, words.data_ptr(),
                     counts.data_ptr(), stream().cuda_stream)
            if err:
                raise RuntimeError(f"doc_topic_lists failed: error {err}")
            return words, counts
        return run

    def draws(fn, rows, slot, coin):
        def run():
            out = torch.empty((b,), dtype=torch.int32, device=dev)
            err = fn(tables.prob.data_ptr(), tables.alias.data_ptr(),
                     rows.data_ptr(), slot.data_ptr(), coin.data_ptr(), b, v,
                     k, out.data_ptr(), stream().cuda_stream)
            if err:
                raise RuntimeError(f"alias draws failed: error {err}")
            return (out,)
        return run

    def accept(fn):
        args = (inp["z"], inp["slot"], inp["lp_z"], inp["lp_c"], inp["lq"],
                inp["lq"], inp["u"])

        def run():
            out = torch.empty((b,), dtype=torch.int32, device=dev)
            err = fn(*(t.data_ptr() for t in args), b, out.data_ptr(),
                     stream().cuda_stream)
            if err:
                raise RuntimeError(f"mh_accept failed: error {err}")
            return (out,)
        return run, ref.mh_accept_ref(*args)

    want_w, want_c = ref.doc_topic_lists_ref(n_dk)
    valid = (torch.arange(k, device=dev)[None, :]
             < want_w[:, -1, 1].long()[:, None])
    sorted_in = (inp["rows"], inp["slot"], inp["coin"])
    shuffled_in = (inp["rows_sh"], inp["slot_sh"], inp["coin_sh"])
    want = {"alias_sample_sorted": ref.alias_sample_ref(
                tables.prob, tables.alias, *sorted_in),
            "alias_sample": ref.alias_sample_ref(
                tables.prob, tables.alias, *shuffled_in)}
    parts, sectors = chip_smoke.draw_bytes(inp, k)
    figures = {"lists_bytes": d * k * 4 + d * ref.doc_words(k) * 8
               + int(want_w[:, -1, 1].sum()) * 2,
               "draws_bytes": sum(parts.values()), "draws_bytes_parts": parts,
               "sector_bytes": sum(sectors.values()),
               "sector_bytes_parts": sectors}
    real = inp["real"]
    key = inp["r"][real] * k + inp["slot"][real].long()
    figures["real_draws"] = int(real.sum())
    figures["alias_draws"] = int((~(inp["coin"][real]
                                    < tables.prob.view(-1)[key])).sum())
    for name in ("lists_bytes", "draws_bytes", "sector_bytes"):
        figures[name.replace("bytes", "ms")] = chip_smoke.bound(
            figures[name], 0)[0]
    print("FIGURES " + json.dumps(figures), flush=True)
    want["alias_sample_on_sorted"] = want["alias_sample_sorted"]
    symbols = {"doc_topic_lists": "doc_topics",
               "alias_sample_sorted": "alias_sample",
               "alias_sample": "alias_sample",
               "alias_sample_on_sorted": "alias_sample",
               "mh_accept": "mh_accept"}
    results = []
    for root, lib in zip(roots, libs):
        k9, want["mh_accept"] = accept(entry(lib["mh_accept"], "mh_accept"))
        runs = {"doc_topic_lists": lists(entry(lib["doc_topics"],
                                               "doc_topic_lists")),
                "alias_sample_sorted": draws(entry(
                    lib["alias_sample"], "alias_sample_sorted"), *sorted_in),
                "alias_sample": draws(entry(lib["alias_sample"],
                                            "alias_sample"), *shuffled_in),
                "alias_sample_on_sorted": draws(entry(
                    lib["alias_sample"], "alias_sample"), *sorted_in),
                "mh_accept": k9}
        out = {"root": str(root), "card": card}
        for name, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            if name == "doc_topic_lists":
                equal = (torch.equal(got[0], want_w)
                         and torch.equal(got[1][valid], want_c[valid]))
            else:
                equal = torch.equal(got[0], want[name])
            del got
            out[name] = {"ms": chip_smoke.time_ms(run, 20),
                         "device_ms": chip_smoke.device_ms(run, 20,
                                                           symbols[name]),
                         "enqueue_us": chip_smoke.enqueue_us(run),
                         "bit_equal": equal}
        print("KERNEL_SPLIT " + json.dumps(out), flush=True)
        results.append(out)
    # Yardsticks, not used by the port: one PyTorch gather of the real
    # draws' prob points, in the shuffled order kernel 8 reads them and in
    # the sorted order kernel 7 does, on the device's clock.
    flat = tables.prob.view(-1)
    keys = {}
    for order, (rows, slot, _) in (("shuffled", shuffled_in),
                                   ("sorted", sorted_in)):
        real = rows < v
        keys[order] = rows[real].long() * k + slot[real].long()
    from torch.profiler import ProfilerActivity, profile

    gathers = {}
    for order, key in keys.items():
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flat.index_select(0, key)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if not names:
            gathers[order] = "not measured: no kernel record"
            continue
        gathers[order] = {"kernel": names[-1][:90],
                          "device_ms": chip_smoke.device_ms(
                              lambda: flat.index_select(0, key), 20,
                              names[-1])}
    figures["prob_gather_device_ms"] = gathers
    print("GATHERS " + json.dumps(gathers), flush=True)
    save = HERE / "chiprun_out"
    save.mkdir(exist_ok=True)
    (save / "kernel_split.json").write_text(json.dumps(
        {"card": card, "figures": figures, "runs": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
