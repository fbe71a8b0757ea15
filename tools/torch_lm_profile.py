"""Profile one training step and one decode step of the PyTorch port's LM
side on one card: smollm-360m at full width and depth, as chip_smoke.py's
phase 16a trains it (8 × 512 tokens, remat, AdamW).

Usage (on a machine with a CUDA card and PyTorch built for CUDA):

    PYTHONPATH=src python3 tools/torch_lm_profile.py

After ``WARM`` steps it times ``TIMED`` steps on the host's clock closed
by ``torch.cuda.synchronize()``, then runs one step and one decode step
(after a prefill of 512 tokens) under ``torch.profiler``.  For each it
prints the wall ms, the device's busy ms (the sum of the kernels' device
time), the count of kernel launches and host ops, the casts' device ms
and calls (``aten::_to_copy``, every ``.to(dtype)``, with the copies it
launches; and ``aten::copy_``'s own device ms), the GEMMs' device ms
(``aten::mm``, ``bmm``, ``addmm``, their ``out_dtype`` forms included),
and the ops and kernels with the most device time; the summary is one
``LMPROFILE`` JSON line, also written to chiprun_out/lm_profile.json
(``--out NAME`` for another file name there).
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "src"))
WARM, TIMED, TOP = 3, 5, 12


def synced_ms(fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def profiled(label: str, fn) -> dict:
    """``fn()`` under the profiler: wall ms, device busy ms, launches."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = synced_ms(fn)
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    ops = [e for e in events if e.device_type.name == "CPU"
           and e.key.startswith("aten::")]
    launches = sum(e.count for e in events if e.key in (
        "cudaLaunchKernel", "cuLaunchKernelEx", "cuLaunchKernel"))
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:TOP]
    by_key = {e.key: e for e in ops}
    casts = by_key.get("aten::_to_copy")
    copies = by_key.get("aten::copy_")
    gemms = [by_key[k] for k in ("aten::mm", "aten::bmm", "aten::addmm")
             if k in by_key]
    out = {"wall_ms": wall, "device_busy_ms": busy,
           "idle_share": max(0.0, 1.0 - busy / wall),
           "launches": launches, "aten_ops": sum(e.count for e in ops),
           "host_ms_a_launch": wall / max(launches, 1),
           "casts_device_ms": casts.device_time_total / 1e3 if casts
           else 0.0,
           "cast_calls": casts.count if casts else 0,
           "copy_self_device_ms": copies.self_device_time_total / 1e3
           if copies else 0.0,
           "gemm_device_ms": sum(e.self_device_time_total
                                 for e in gemms) / 1e3,
           "gemm_calls": sum(e.count for e in gemms),
           "top_ops_device_ms": {e.key: e.self_device_time_total / 1e3
                                 for e in top}}
    print(f"PROFILE {label}: wall {wall:.1f} ms, device busy {busy:.1f} ms, "
          f"{launches} launches, {out['aten_ops']} aten ops; casts "
          f"{out['casts_device_ms']:.1f} ms in {out['cast_calls']} calls "
          f"(copy_ {out['copy_self_device_ms']:.1f} ms), GEMMs "
          f"{out['gemm_device_ms']:.1f} ms in {out['gemm_calls']} calls",
          flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=TOP,
                       max_name_column_width=60), flush=True)
    return out


def main() -> int:
    from repro_torch.configs.registry import ARCHITECTURES
    from repro_torch.data.synthetic import lm_batches
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import TrainConfig, make_train_step

    if not torch.cuda.is_available():
        raise SystemExit("torch_lm_profile: no CUDA device")
    dev = torch.device("cuda")
    cfg = ARCHITECTURES["smollm-360m"]
    params = model.init_params(cfg, device=dev)
    opt = adamw.init(params)
    step = make_train_step(cfg, TrainConfig(peak_lr=1e-3, warmup=6,
                                            total_steps=30), device=dev)
    data = list(lm_batches(cfg.vocab_size, 8, 512, WARM + TIMED + 1, seed=1,
                           kind="affine"))
    ms = []
    for i in range(WARM + TIMED):
        (params, opt, _), t = synced_ms(lambda: step(params, opt, data[i]))
        ms.append(t)
    out = {"arch": cfg.name, "batch": 8, "seq": 512,
           "step_ms": ms[WARM:], "step_ms_median": statistics.median(
               ms[WARM:]),
           "device": torch.cuda.get_device_name(0)}
    out["train_step"] = profiled("train step",
                                 lambda: step(params, opt, data[-1]))
    tokens = next(lm_batches(cfg.vocab_size, 8, 513, 1, seed=2,
                             kind="affine"))["tokens"]
    tokens = torch.as_tensor(tokens, device=dev)
    _, cache = model.prefill(cfg, params, {"tokens": tokens[:, :512]}, 520)
    _, out["prefill_ms"] = synced_ms(lambda: model.prefill(
        cfg, params, {"tokens": tokens[:, :512]}, 520))
    out["decode_step"] = profiled("decode step", lambda: model.decode_step(
        cfg, params, cache, tokens[:, 512:]))
    print(f"LMPROFILE {json.dumps(out)}", flush=True)
    dest = HERE / "chiprun_out"
    dest.mkdir(exist_ok=True)
    name = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv \
        else "lm_profile.json"
    (dest / name).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
