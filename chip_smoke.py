"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

Usage (from the root of a checkout, on a machine with a CUDA card, nvcc
and PyTorch built for CUDA):

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. card: name and power limit (nvidia-smi); no CUDA device is a failure.
2. build: the kernels under src/repro_torch/csrc, one nvcc per source.
3. kernels against their plain PyTorch versions, on the card, at the main
   path's shapes, built from the full-size corpus's own statistics:
   alias build (V=131072, K=1024), gather build (R=4096 rows) and the
   sweep (a 262,144-token slice of a real chunk), each timed with CUDA
   events beside its plain version and its memory bound.
4. training at full size: LDA K=1024 over V=131072 on ~12.6M tokens, two
   clients, BSP, 4 rounds with full alias rebuilds then 3 rounds of
   incremental rebuilds.  After every round: consistency_error() == 0.0,
   no projection violations; held-out perplexity must fall.  The launch
   counters are zeroed just before and read just after, and every kernel
   must have launched.

The last lines are the kernels JSON, the card, and the result JSON.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM non-tensor-core fp32
SWEEP_SLICE = 262_144
GATHER_ROWS = 4096
SWEEP_MISMATCH_TOL = 1e-3      # share of chains that may differ (see below)
DIST_ABS, DIST_REL = 2e-6, 1e-4  # encoded distribution vs p/Σp


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase(name: str, t0: float) -> None:
    print(f"PHASE {name} ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def time_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in units in the last place between two f32
    tensors of equal sign."""
    ia = a.contiguous().view(torch.int32).to(torch.int64)
    ib = b.contiguous().view(torch.int32).to(torch.int64)
    return int((ia - ib).abs().max()) if a.numel() else 0


def encoded(prob: torch.Tensor, alias: torch.Tensor) -> torch.Tensor:
    """The distribution each alias row draws from."""
    k = prob.shape[1]
    q = prob.double().clone()
    q.scatter_add_(1, alias.long(), 1.0 - prob.double())
    return q / k


def check_tables(name, p, prob, alias, mass, prob_ref, alias_ref, mass_ref):
    """Kernel and plain tables agree bit for bit on rows whose float32
    masses agree bit for bit, and both encode the row's exact distribution
    p/Σp (summed in float64) to DIST_ABS + DIST_REL·(p/Σp): a float32 row
    sum over K = 1024 terms is off by up to (K−1)·2⁻²⁴ ≈ 6e-5 relative,
    which scales every entry, and the pairing's float32 subtractions add a
    few ulp of 1/K per slot.  Returns match statistics."""
    same = mass == mass_ref
    if not (torch.equal(alias[same], alias_ref[same])
            and torch.equal(prob[same], prob_ref[same])):
        raise AssertionError(f"{name}: tables differ on rows whose mass "
                             "is bit-equal")
    exact = p.double().sum(1, keepdim=True)
    target = torch.where(exact > 0, p.double() / exact.clamp_min(1e-300),
                         torch.full_like(exact, 1.0 / p.shape[1]))
    errs = {}
    for who, pr, al in (("kernel", prob, alias), ("plain", prob_ref,
                                                  alias_ref)):
        err = (encoded(pr, al) - target).abs()
        if not bool((err <= DIST_ABS + DIST_REL * target).all()):
            raise AssertionError(f"{name}: {who} table is off the row's "
                                 f"distribution by up to {float(err.max())}")
        errs[who] = float(err.max())
    rel = float(((mass - mass_ref).abs() / mass_ref.abs().clamp_min(1e-30))
                .max())
    if not rel <= 1e-4:
        raise AssertionError(f"{name}: row masses differ by {rel:.3g}")
    return {"rows_mass_bit_equal": float(same.float().mean()),
            "alias_match_rate": float((alias == alias_ref).float().mean()),
            "prob_max_ulp": ulps(prob, prob_ref),
            "max_abs_err": float((prob - prob_ref).abs().max()),
            "dist_max_err": errs["kernel"]}


def profile_round(trainer) -> None:
    """One more round under torch.profiler: device time by kernel and the
    device's busy share of the round's wall time.  Its launches are not
    main-path launches, so the counters are restored afterwards."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build
    saved = dict(_build.LAUNCHES)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    _build.LAUNCHES.clear()
    _build.LAUNCHES.update(saved)
    rows = []
    for e in prof.key_averages():
        # Device-side entries only (kernels, copies); the host ops that
        # launched them report the same time again.
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key[:90]))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"PROFILE one cadence round: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms, idle share "
          f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for ms, n, k in rows[:15]:
        print(f"  {ms:9.2f} ms {n:6d} x {k}")


def held_out_docs(phi: np.ndarray, n_docs: int, doc_len: int, seed: int):
    """Documents drawn as the corpus draws them, from its own topics."""
    rng = np.random.default_rng(seed)
    k, v = phi.shape
    tokens = np.zeros((n_docs, doc_len), np.int32)
    mask = np.zeros((n_docs, doc_len), bool)
    for d in range(n_docs):
        length = int(rng.integers(doc_len // 2, doc_len + 1))
        zs = rng.choice(k, size=length, p=rng.dirichlet(np.full(k, 0.2)))
        for t in np.unique(zs):
            idx = np.nonzero(zs == t)[0]
            tokens[d, idx] = rng.choice(v, size=idx.size, p=phi[t])
        mask[d, :length] = True
    return tokens, mask


def main() -> int:
    t0 = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    card = card_line()
    print(f"CARD {card}", flush=True)
    dev = torch.device("cuda")
    phase("card", t0)

    from repro_torch.kernels import _build
    t = time.perf_counter()
    secs = _build.build_all()
    print(f"BUILD {secs:.1f} s nvcc (all sources in parallel)")
    for stem, log in sorted(_build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{stem}] {line.strip()}")
    phase("build", t)

    from repro_torch.core import alias as alias_mod
    from repro_torch.core import lda, mhw
    from repro_torch.data import segment
    from repro_torch.data.synthetic import CorpusConfig, make_topic_corpus
    from repro_torch.engine import Trainer, TrainerConfig
    from repro_torch.kernels import alias_build as kab
    from repro_torch.kernels import mhw_fused as kmf
    from repro_torch.kernels import ops, ref

    t = time.perf_counter()
    ccfg = CorpusConfig(n_topics=64, vocab_size=131072, n_docs=65536,
                        doc_len=256, seed=0)
    tokens, mask, phi = make_topic_corpus(ccfg)
    ho_tokens, ho_mask = held_out_docs(phi, 32, ccfg.doc_len, seed=1)
    n_tok = int(mask.sum())
    print(f"CORPUS {ccfg} tokens={n_tok} ({time.perf_counter() - t:.1f} s)")
    if n_tok >= 1 << 24:
        raise AssertionError("counts must stay below 2^24 to stay exact")
    cfg = lda.LDAConfig(n_topics=1024, vocab_size=131072)
    v, k = cfg.vocab_size, cfg.n_topics
    beta_bar = cfg.beta * v
    phase("corpus", t)

    # ---------------------------------------------------------- phase 3
    t = time.perf_counter()
    tc_cad = TrainerConfig(layout="sorted", n_clients=2, consistency="bsp")
    tr = Trainer(cfg, tokens, mask, config=tc_cad, seed=0, device=dev)
    shared = tr.shared
    dp = lda.dense_probs(cfg, shared)
    rows_k3 = torch.argsort(-shared.n_wk.sum(1), stable=True)[
        :GATHER_ROWS].to(torch.int32)
    prior = torch.full((k,), cfg.alpha, dtype=torch.float32, device=dev)
    report = []

    # Kernel 2: full build.
    prob, alias, mass = kab.alias_build(dp)
    prob_r, alias_r, mass_r = alias_mod.build(dp)
    stats2 = check_tables("alias_build", dp, prob, alias, mass, prob_r,
                          alias_r, mass_r)
    ms2 = time_ms(lambda: kab.alias_build(dp), 5)
    plain2 = time_ms(lambda: alias_mod.build(dp), 2)
    # Reads p; writes prob and alias (V, K) and mass (V,).
    bytes2 = v * k * 4 + v * k * 8 + v * 4
    b2, by2 = bound(bytes2, 0)
    report.append({
        "name": "alias_build", "route": "cuda",
        "source": "src/repro_torch/csrc/alias_build.cu",
        "replaces": "src/repro/kernels/alias_build.py:186",
        "ms": ms2, "plain_ms": plain2, "bound_ms": b2, "bound_by": by2,
        "library_ms": None, "bytes": bytes2, **stats2})
    print(f"KERNEL alias_build {json.dumps(report[-1])}", flush=True)

    # Kernel 3: gather build of R rows; its rows must equal the full build's.
    g = kab.alias_build_gather_fused(shared.n_wk, shared.n_k, prior, rows_k3,
                                     beta=cfg.beta, beta_bar=beta_bar)
    g_r = ref.alias_build_gather_fused_ref(shared.n_wk, shared.n_k, prior,
                                           rows_k3, beta=cfg.beta,
                                           beta_bar=beta_bar)
    if not torch.equal(g[3], g_r[3]):
        raise AssertionError("gather build: dense rows differ from plain")
    ridx = rows_k3.long()
    if not (torch.equal(g[3], dp[ridx]) and torch.equal(g[0], prob[ridx])
            and torch.equal(g[1], alias[ridx])
            and torch.equal(g[2], mass[ridx])):
        raise AssertionError("gather build differs from the full build's "
                             "rows")
    stats3 = check_tables("alias_build_gather_fused", g_r[3], g[0], g[1],
                          g[2], g_r[0], g_r[1], g_r[2])

    def run3(fn):
        return lambda: fn(shared.n_wk, shared.n_k, prior, rows_k3,
                          beta=cfg.beta, beta_bar=beta_bar)
    ms3 = time_ms(run3(kab.alias_build_gather_fused), 10)
    plain3 = time_ms(run3(ref.alias_build_gather_fused_ref), 2)
    r = GATHER_ROWS
    # Reads the R gathered n_wk rows, n_k, prior and rows; writes prob,
    # alias and dense (R, K) and mass (R,).
    bytes3 = r * k * 4 + 2 * k * 4 + r * 4 + r * k * 12 + r * 4
    b3, by3 = bound(bytes3, 0)
    report.append({
        "name": "alias_build_gather_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/alias_build.cu",
        "replaces": "src/repro/kernels/alias_build.py:379",
        "ms": ms3, "plain_ms": plain3, "bound_ms": b3, "bound_by": by3,
        "library_ms": None, "bytes": bytes3, "partial_equals_full": True,
        **stats3})
    print(f"KERNEL alias_build_gather_fused {json.dumps(report[-1])}",
          flush=True)

    # Kernel 1: a slice of client 0's first chunk.
    lay = tr.layouts[0][0]
    bounds = segment.chunk_bounds(ccfg.doc_len, cfg.sorted_chunks)
    z_c = tr.locals_[0].z[:, bounds[0]:bounds[1]].reshape(-1)
    e_s = segment.sort_values(lay, z_c)
    sl = slice(0, SWEEP_SLICE)
    rows1, docs1, z01 = lay.rows[sl], lay.docs[sl], e_s[sl]
    n_dk = tr.locals_[0].n_dk
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    uni = ops._step_uniforms(gen, k, cfg.mh_steps, SWEEP_SLICE, dev)
    args1 = (prob, alias, mass, dp, shared.n_wk, shared.n_k, prior, rows1,
             docs1, z01, n_dk, *uni)
    z_kernel = kmf.mhw_sweep_fused(*args1, beta=cfg.beta, beta_bar=beta_bar)
    z_plain = mhw.sorted_chain(*args1, beta=cfg.beta, beta_bar=beta_bar)
    mismatch = float((z_kernel != z_plain).float().mean())
    # A mismatch can only come from rounding: the kernel sums the sparse
    # weights in 32 sequential blocks plus a warp scan of their totals,
    # the plain version with torch.cumsum, so a target within rounding of
    # a cdf step can land one topic apart (and the chain then continues
    # from another state), as can log() near an accept tie.
    if not mismatch <= SWEEP_MISMATCH_TOL:
        raise AssertionError(f"sweep: {mismatch:.3g} of chains differ "
                             f"(> {SWEEP_MISMATCH_TOL})")
    ms1 = time_ms(lambda: kmf.mhw_sweep_fused(*args1, beta=cfg.beta,
                                              beta_bar=beta_bar), 10)
    plain1 = time_ms(lambda: mhw.sorted_chain(*args1, beta=cfg.beta,
                                              beta_bar=beta_bar), 3)
    # What the chain must move for this slice: the full n_wk row of each
    # word and n_dk row of each document it touches; prob and alias at the
    # distinct (word, slot) entries its draws name; mass once per word;
    # stale at z0 and at each step's candidate (counted per read, at most
    # (1 + mh_steps)·4 B a token); rows, z0 and z out for every position;
    # docs and the five uniform streams for real tokens only (padding
    # exits before reading them).
    real = rows1 < v
    n_real = int(real.sum())
    r_real = rows1[real].long()
    u_rows = int(torch.unique(r_real).numel())
    u_docs = int(torch.unique(docs1[real]).numel())
    u_slots = int(torch.unique(r_real * k + uni[0][:, real].long()).numel())
    b = SWEEP_SLICE
    steps = cfg.mh_steps
    bytes1 = (u_rows * k * 4 + u_docs * k * 4 + 2 * k * 4 + u_rows * 4
              + u_slots * 8 + (1 + steps) * n_real * 4
              + b * 12 + n_real * 4 + steps * n_real * 20)
    ops1 = n_real * k * 8
    b1, by1 = bound(bytes1, ops1)
    full_b = lay.rows.shape[0]
    full_real = int((lay.rows < v).sum())
    uni_full = ops._step_uniforms(gen, k, cfg.mh_steps, full_b, dev)
    e_full = segment.sort_values(lay, z_c)
    ms1_full = time_ms(lambda: kmf.mhw_sweep_fused(
        prob, alias, mass, dp, shared.n_wk, shared.n_k, prior, lay.rows,
        lay.docs, e_full, n_dk, *uni_full, beta=cfg.beta,
        beta_bar=beta_bar), 5)
    report.append({
        "name": "mhw_sweep_fused", "route": "cuda",
        "source": "src/repro_torch/csrc/mhw_fused.cu",
        "replaces": "src/repro/kernels/mhw_fused.py:153",
        "ms": ms1, "plain_ms": plain1, "bound_ms": b1, "bound_by": by1,
        "library_ms": None, "tokens": b, "mismatch_rate": mismatch,
        "max_abs_err": int((z_kernel - z_plain).abs().max()),
        "bytes": bytes1, "bytes_parts": {
            "n_wk_rows": u_rows * k * 4, "n_dk_rows": u_docs * k * 4,
            "prob_alias_points": u_slots * 8,
            "stale_points": (1 + steps) * n_real * 4,
            "n_k_prior_mass": 2 * k * 4 + u_rows * 4,
            "streams": b * 12 + n_real * 4 + steps * n_real * 20},
        "full_chunk_tokens": full_b, "full_chunk_real_tokens": full_real,
        "full_chunk_ms": ms1_full})
    print(f"KERNEL mhw_sweep_fused {json.dumps(report[-1])}", flush=True)
    trainers = {"cadence": tr}
    del tr, shared, dp, n_dk, prob, alias, mass, prob_r, alias_r, mass_r
    del g, g_r, args1, uni_full, e_full, z_kernel, z_plain
    torch.cuda.empty_cache()
    phase("kernels", t)

    # ---------------------------------------------------------- phase 4
    t = time.perf_counter()
    state_bytes = (v * k * 4 * 7 + 2 * 32768 * k * 4
                   + 2 * n_tok * 4 * 4 + 5 * cfg.mh_steps * 2_200_000 * 4)
    print(f"MEMORY reckoned ~{state_bytes / 2**30:.1f} GiB: n_wk, its "
          "delta, the push sum, stale, prob, alias and the build's "
          "transients as (V,K) f32; two (D,K) n_dk; layouts; uniforms")
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    chunks = cfg.sorted_chunks
    modes = (("cadence", tc_cad, 4),
             ("incremental", TrainerConfig(
                 layout="sorted", n_clients=2, consistency="bsp",
                 alias_rebuild_threshold=0.0, alias_rebuild_rows=4096,
                 alias_full_rebuild_every=16), 3))
    for name, tcfg, rounds in modes:
        trainer = trainers.pop(name, None) or Trainer(
            cfg, tokens, mask, config=tcfg, seed=0, device=dev)
        before = dict(_build.LAUNCHES)
        ppl, step_s = [], 0.0
        for rnd in range(rounds):
            torch.cuda.synchronize()
            ts = time.perf_counter()
            trainer.step()
            torch.cuda.synchronize()
            step_s += time.perf_counter() - ts
            err = trainer.consistency_error()
            viol = trainer.family.count_violations(trainer.shared)
            ppl.append(trainer.perplexity(ho_tokens, ho_mask))
            print(f"ROUND {name} {rnd} consistency_error={err} "
                  f"violations={viol} heldout_perplexity={ppl[-1]:.3f}",
                  flush=True)
            if err != 0.0 or viol != 0:
                raise AssertionError(f"{name} round {rnd}: consistency "
                                     f"{err}, violations {viol}")
            if not np.isfinite(ppl[-1]):
                raise AssertionError(f"{name}: perplexity {ppl[-1]}")
        if not ppl[-1] < ppl[0]:
            raise AssertionError(f"{name}: perplexity did not fall: {ppl}")
        launched = {n: _build.LAUNCHES[n] - before.get(n, 0)
                    for n in _build.SIGNATURES}
        want = rounds * tcfg.n_clients * chunks
        if launched["mhw_sweep_fused"] != want:
            raise AssertionError(f"{name}: sweep launched "
                                 f"{launched['mhw_sweep_fused']} times, "
                                 f"expected {want}")
        summary = {
            "rounds": rounds, "rounds_per_s": rounds / step_s,
            "tokens_per_s": n_tok * rounds / step_s,
            "perplexity": ppl, "launches": launched,
            "alias_builds": trainer.alias_builds}
        print(f"TRAIN {name} {json.dumps(summary)}", flush=True)
        if name == "cadence":
            profile_round(trainer)
        del trainer
        torch.cuda.empty_cache()
    counts = dict(_build.LAUNCHES)
    for kernel in ("alias_build", "alias_build_gather_fused",
                   "mhw_sweep_fused"):
        if counts.get(kernel, 0) < 1:
            raise AssertionError(f"{kernel} never launched on the main path")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"MEMORY peak allocated {peak:.2f} GiB")
    for entry in report:
        entry["launches"] = counts[entry["name"]]
    phase("train", t)

    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
