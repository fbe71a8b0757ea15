"""Pod dry run: run one step of every (architecture × input shape) workload
as one rank of the production meshes, without allocating a single real
tensor and on no device (port of ``repro.launch.dryrun``).

This is the one entry point of the port that allocates nothing and runs
on no device.  It starts ``torch.distributed``'s fake process group
(backend ``"fake"``, world size 256 or 512) as rank 0, builds
``make_production_mesh`` over it (16×16 (data, model), or 2×16×16 (pod,
data, model)) and, under ``FakeTensorMode``, runs the workload's step once
(``launch/specs.py``: the mesh train step, a served prefill, or one
served decode step): every tensor has the shape and dtype that rank of an
H100 mesh would hold, and no storage; every collective returns at once.
Its record per workload keeps the reference's ``status``: ``ok``,
``skip`` with the reference's ``skip_reason`` (only ``long_500k`` on the
full-attention architectures), or ``fail`` with the error.  A failure is a
fault of the port, not a skip.  An ``ok`` record holds:

* the rank's resident bytes: its parameter, optimiser and cache blocks
  (the serve weights in their compute split, ``model.serve_params``);
* ``peak_bytes``: those plus the largest set of tensors alive at once in
  the step, as ``torch.distributed._tools.mem_tracker.MemTracker`` follows
  the fake tensors (null where the tracker fails);
* the roofline row (``launch/roofline.py``): the analytic compute and
  memory terms and the collective term of the bytes the rank's step
  called (``core.collectives.tally``), by kind.

A train step of n microbatches runs the first two and counts each later
one as a repeat of the second (``make_train_step(repeat_second=True)``):
the tally is mb1 + (n − 1)·mb2 and the peak the larger of the two, exact
in fake mode, where every later microbatch has the second's shapes and
live set (the reference's ``lax.scan`` likewise lowers its body once).

Usage (CPU, no card):

  PYTHONPATH=src python -m repro_torch.launch.dryrun              # all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape decode_32k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --shape train_4k \\
      --single-pod --sharding zero_seq --json out.json

The fake group is destroyed before :func:`main` returns, so the CLI can be
called from a process that runs a real group before or after it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback

import torch.distributed as dist

from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.configs.registry import ARCHITECTURES
from repro_torch.core import collectives
from repro_torch.launch import roofline as rl
from repro_torch.launch import specs as specs_lib
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.train import sharding

MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}


@contextlib.contextmanager
def fake_group(world: int):
    """``torch.distributed``'s fake process group of ``world`` ranks, this
    process rank 0, for the ``with`` body (destroyed after)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run needs a process of its own: a "
                           "process group is running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def mesh_groups(mesh) -> None:
    """Build the flattened groups of every sub-tuple of two or more of the
    mesh's axes before fake tensors appear: the flattening reads the
    mesh's real rank table."""
    names = mesh.mesh_dim_names
    for i in range(len(names)):
        for j in range(i + 1, len(names)):
            sharding.group_of(mesh, (names[i], names[j]))


def _peak(step) -> tuple:
    """(the step's result, the peak bytes MemTracker saw, or None, and
    those bytes by MemTracker's kind of reference: {kind: bytes})."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
        tracker = MemTracker()
    except Exception:  # noqa: BLE001 — the peak is optional
        return step(), None, {}
    with tracker:
        out = step()
    snap = tracker.get_tracker_snapshot("peak")
    kinds: dict = {}
    for v in snap.values():
        for k, n in v.items():
            name = str(getattr(k, "value", k))
            kinds[name] = kinds.get(name, 0) + int(n)
    return out, int(sum(v["Total"] for v in snap.values())), kinds


def run_one(arch: str, shape_name, *, multi_pod: bool = False,
            verbose: bool = True, sharding_mode: str = "megatron",
            cfg=None, mesh_shape: dict | None = None,
            microbatches: int | None = None,
            repeat_second: bool = True) -> dict:
    """One workload as rank 0 of the production mesh, on the fake group
    that must be running (256 ranks, or 512 with ``multi_pod``); returns
    its record.  ``cfg`` (a config in place of the registry's),
    ``shape_name`` an ``InputShape`` and ``mesh_shape`` ({axis: size}, a
    mesh over the running group in place of the production one),
    ``microbatches`` (in place of the reference's count) and
    ``repeat_second=False`` (run every microbatch) are for tests at small
    sizes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cfg or ARCHITECTURES[arch]
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    mesh_name = MESH_NAMES[multi_pod] if mesh_shape is None else \
        "x".join(str(n) for n in mesh_shape.values())
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "sharding": sharding_mode}
    reason = specs_lib.skip_reason(cfg, shape)
    if reason:
        return dict(rec, status="skip", reason=reason)
    t0 = time.time()
    try:
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        else:
            mesh = make_host_mesh(**mesh_shape, device="cpu",
                                  backend=dist.get_backend())
        mesh_groups(mesh)
        chips = mesh.size()
        with FakeTensorMode():
            spec = specs_lib.make_lowering_spec(cfg, shape, mesh,
                                                mode=sharding_mode,
                                                device="cpu",
                                                microbatches=microbatches,
                                                repeat_second=repeat_second)
            resident = spec.resident_bytes()
            with collectives.tally() as counts:
                _, peak, peak_kinds = _peak(spec.run)
        roof = rl.analyze(counts, cfg=spec.cfg, shape=shape,
                          mesh_name=mesh_name, chips=chips,
                          n_microbatches=spec.microbatches)
        total = sum(resident.values())
        rec.update(status="ok", kind=spec.kind, act_mode=spec.act_mode,
                   microbatches=spec.microbatches, **spec.info,
                   moe_groups=spec.cfg.moe_groups,
                   run_s=round(time.time() - t0, 1),
                   resident_bytes=resident, resident_total_bytes=total,
                   peak_bytes=None if peak is None else total + peak,
                   peak_by_kind=peak_kinds,
                   collectives=counts, **roof.row())
        if verbose:
            print(f"[ok]   {arch:22s} {shape.name:12s} {mesh_name:10s} "
                  f"kind={spec.kind:7s} mode={spec.act_mode:10s} "
                  f"run={rec['run_s']:6.1f}s "
                  f"resident/rank={total / 2**30:7.2f}GiB "
                  f"t_comp={roof.t_compute:.3e}s t_mem={roof.t_memory:.3e}s "
                  f"t_coll={roof.t_collective:.3e}s "
                  f"bottleneck={roof.bottleneck}", flush=True)
        return rec
    except Exception as e:  # noqa: BLE001 — report, don't crash the sweep
        if verbose:
            print(f"[FAIL] {arch:22s} {shape.name:12s} {mesh_name}\n"
                  f"{traceback.format_exc()}", flush=True)
        return dict(rec, status="fail", error=f"{type(e).__name__}: {e}")


def run_mesh(archs, shapes, *, multi_pod: bool,
             sharding_mode: str = "megatron") -> list[dict]:
    """Every (arch, shape) on one production mesh, inside its own fake
    group."""
    with fake_group(512 if multi_pod else 256):
        return [run_one(a, s, multi_pod=multi_pod,
                        sharding_mode=sharding_mode)
                for a in archs for s in shapes]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None, help="one architecture id")
    ap.add_argument("--shape", default=None, help="one input-shape name")
    ap.add_argument("--multi-pod", action="store_true",
                    help="only the 2x16x16 multi-pod mesh")
    ap.add_argument("--single-pod", action="store_true",
                    help="only the 16x16 single-pod mesh")
    ap.add_argument("--json", default=None, help="write records to this file")
    ap.add_argument("--sharding", default="megatron",
                    choices=["megatron", "zero_seq", "zero_batch"],
                    help="megatron = paper-faithful baseline; zero_seq = "
                         "ZeRO-3 + sequence-parallel (§Perf optimization)")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else sorted(ARCHITECTURES)
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    if args.multi_pod:
        meshes = [True]
    elif args.single_pod:
        meshes = [False]
    else:
        meshes = [False, True]

    records = []
    for multi_pod in meshes:
        records += run_mesh(archs, shapes, multi_pod=multi_pod,
                            sharding_mode=args.sharding)

    n_ok = sum(r["status"] == "ok" for r in records)
    n_skip = sum(r["status"] == "skip" for r in records)
    n_fail = sum(r["status"] == "fail" for r in records)
    print(f"\ndry-run complete: {n_ok} ok, {n_skip} documented skips, "
          f"{n_fail} failures")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {args.json}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
