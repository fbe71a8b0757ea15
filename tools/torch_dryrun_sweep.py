"""Run the port's pod dry run over its sweep in parallel processes and
tabulate it.

    PYTHONPATH=src python3 tools/torch_dryrun_sweep.py OUT_DIR [--jobs N]
        [--only ARCH,...] [--modes MODE,...] [--shapes SHAPE,...]
        [--timeout-each SECONDS]

The sweep: megatron on both production meshes (ten architectures × the
four input shapes × 16×16 and 2×16×16, the full-attention architectures'
long_500k documented skips), then zero_seq and zero_batch at train_4k on
16×16 (``--modes`` and ``--shapes`` keep a part of it).  Each workload is one ``python -m repro_torch.launch.dryrun``
process writing its record to ``OUT_DIR/<arch>-<shape>-<mesh>-<mode>.json``
(its log beside it), the slowest first (the SSMs' chunked scans and the
largest models' microbatched train steps run as many fake operations as
they would launch: up to half an hour a workload); ``--jobs`` processes
run at once (the CPU's count less one by default).  It needs no
card: each process is rank 0 of a fake process group under
``FakeTensorMode``.  A workload whose record is already in OUT_DIR is not
run again (a sweep cut short resumes); one that runs past
``--timeout-each`` seconds is stopped and recorded as ``timeout``.  At
the end it writes ``OUT_DIR/sweep.json`` (every record) and prints the
counts (ok, skip, fail, timeout), a table row per workload (bottleneck,
the three roofline terms, resident and peak GiB a rank, collective GB a
step a rank, the run's seconds) and every failure with its error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("internvl2-76b", "mixtral-8x7b", "phi3.5-moe-42b-a6.6b",
         "qwen2-1.5b", "qwen3-14b", "rwkv6-3b", "smollm-360m",
         "stablelm-1.6b", "whisper-large-v3", "zamba2-2.7b")


SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
SSMS = ("zamba2-2.7b", "rwkv6-3b")
BIG = ("internvl2-76b", "mixtral-8x7b", "phi3.5-moe-42b-a6.6b", "qwen3-14b")


def jobs(only: set | None, modes: set | None = None,
         shapes: set | None = None) -> list[tuple]:
    """(arch, mesh flag, mode, shape) of the sweep, the slow ones first."""
    out = []
    for arch in ARCHS:
        if only and arch not in only:
            continue
        for mesh in ("--single-pod", "--multi-pod"):
            out += [(arch, mesh, "megatron", s) for s in SHAPES]
        for mode in ("zero_seq", "zero_batch"):
            out.append((arch, "--single-pod", mode, "train_4k"))
    out = [j for j in out if (not modes or j[2] in modes)
           and (not shapes or j[3] in shapes)]

    def order(job):     # an SSM's prefill, its train steps, then BIG's
        arch, _, mode, shape = job
        ssm = arch in SSMS
        return (not (ssm and shape == "prefill_32k"),
                not (ssm and shape == "train_4k"),
                not (arch in BIG and shape == "train_4k"),
                mode != "megatron")
    return sorted(out, key=order)


def run(job, out_dir: Path, timeout: float | None) -> list[dict]:
    arch, mesh, mode, shape = job
    stem = f"{arch}-{shape}-{mesh.strip('-')}-{mode}"
    out = out_dir / f"{stem}.json"
    if out.exists():
        return json.loads(out.read_text())
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           arch, mesh, "--sharding", mode, "--shape", shape, "--json",
           str(out)]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t = time.time()
    rec = {"arch": arch, "shape": shape, "sharding": mode,
           "mesh": "pod2x16x16" if mesh == "--multi-pod" else "pod16x16"}
    with open(out_dir / f"{stem}.log", "w") as log:
        try:
            rc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            print(f"{stem}: stopped after {timeout:.0f} s", flush=True)
            return [dict(rec, status="timeout", run_s=timeout)]
    print(f"{stem}: exit {rc} in {time.time() - t:.0f} s", flush=True)
    if not out.exists():
        return [dict(rec, status="fail",
                     error=f"the process exited {rc} without records")]
    return json.loads(out.read_text())


def table(records: list[dict]) -> list[str]:
    rows = ["| arch | shape | mesh | mode | status | bottleneck | compute s "
            "| memory s | collective s | resident GiB | peak GiB | coll GB "
            "| run s |", "|" + " --- |" * 13]
    for r in records:
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"{r['sharding']} | {r['status']} |" + " |" * 7
                        + f" {r.get('run_s', '')} |")
            continue
        peak = r["peak_bytes"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['act_mode']} "
            f"| ok | {r['bottleneck']} | {r['t_compute_s']:.3e} | "
            f"{r['t_memory_s']:.3e} | {r['t_collective_s']:.3e} | "
            f"{r['resident_total_bytes'] / 2**30:.2f} | "
            f"{'null' if peak is None else f'{peak / 2**30:.2f}'} | "
            f"{r['coll_bytes'] / 1e9:.2f} | {r['run_s']} |")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out_dir")
    ap.add_argument("--jobs", type=int, default=max(1, (os.cpu_count()
                                                        or 2) - 1))
    ap.add_argument("--only", default="", help="comma-separated archs")
    ap.add_argument("--modes", default="",
                    help="comma-separated sharding modes")
    ap.add_argument("--shapes", default="",
                    help="comma-separated input shapes")
    ap.add_argument("--timeout-each", type=float, default=None,
                    help="stop a workload after this many seconds")
    args = ap.parse_args(argv)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    only = set(args.only.split(",")) if args.only else None
    modes = set(args.modes.split(",")) if args.modes else None
    shapes = set(args.shapes.split(",")) if args.shapes else None
    t = time.time()
    with ThreadPoolExecutor(args.jobs) as pool:
        results = list(pool.map(
            lambda j: run(j, out_dir, args.timeout_each),
            jobs(only, modes, shapes)))
    records = [r for rs in results for r in rs]
    (out_dir / "sweep.json").write_text(json.dumps(records, indent=1))
    counts = {s: sum(r["status"] == s for r in records)
              for s in ("ok", "skip", "fail", "timeout")}
    print(f"\nsweep: {counts} in {time.time() - t:.0f} s, "
          f"{args.jobs} processes")
    print("\n".join(table(records)))
    for r in records:
        if r["status"] == "fail":
            print(f"FAIL {r['arch']} {r['shape']} {r['mesh']} "
                  f"{r['sharding']}: {r['error']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
