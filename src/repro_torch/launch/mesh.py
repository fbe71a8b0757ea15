"""Process meshes (port of ``repro.launch.mesh``): ``make_host_mesh``,
``make_production_mesh`` and the roofline's hardware constants.

JAX runs a mesh as one program over many devices; ``torch.distributed``
runs one process per rank.  :func:`run_on_mesh` starts those processes
(the ``spawn`` start method: CUDA cannot be used in a process forked after
it was initialised), joins them through a ``FileStore`` in a temporary
directory, builds the (data, model) mesh in each with
:func:`make_host_mesh` and calls the given function there; it returns
every rank's result and raises if any rank fails.

The backend follows the device, ``nccl`` for ``cuda`` and ``gloo`` for the
CPU; gloo over CUDA tensors is used only when the caller names it (several
ranks on one card: NCCL refuses two ranks on one device).  A rank on
``cuda`` uses card ``rank % device_count``.

:func:`make_production_mesh` lays the reference's production meshes,
16×16 (data, model) and 2×16×16 (pod, data, model), over the process group
that is already running: 256 or 512 ranks, in the pod dry run
(``launch/dryrun.py``) a fake group of which this process is rank 0.

The roofline's denominators are H100 SXM figures, one rank a card:
``PEAK_FLOPS_BF16`` and ``HBM_BW`` from NVIDIA's H100 data sheet, and one
collective rate a card, ``NVLINK_BW``: NVLink 4's 450 GB/s each way (900
GB/s in all) a GPU.  A 256- or 512-GPU mesh spans nodes of eight cards,
between which NDR InfiniBand gives ~50 GB/s a GPU, so the collective term
taken at the NVLink rate is a lower bound.  The reference keeps one
collective term; so does the port.
"""

from __future__ import annotations

import math
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import device as device_mod

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")

# One card's rates (NVIDIA's H100 SXM data sheet): dense bf16 tensor-core
# FLOP/s, HBM3 bytes/s, NVLink 4 bytes/s each way.
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...],
          device_type: str, what: str) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError(f"{what} needs torch.distributed's process "
                           "group; run_on_mesh starts one per rank")
    n = math.prod(shape)
    if n != dist.get_world_size():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {n} "
                         f"ranks, the job has {dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=axes)


def make_host_mesh(data: int = 1, model: int = 1, *, pod: int | None = None,
                   device=None, backend: str | None = None) -> DeviceMesh:
    """The (data, model) ``DeviceMesh`` over this job's ranks, rank
    ``d·model + m`` at (d, m); with ``pod`` the (pod, data, model) mesh,
    rank ``(p·data + d)·model + m`` at (p, d, m), the reference's axis
    order.  Called in each rank after ``init_process_group``, whose
    backend must be ``backend`` (by default the device's: no rank switches
    backend unasked)."""
    dev = device_mod.resolve(device)
    want = backend or default_backend(dev)
    if dist.is_initialized() and dist.get_backend() != want:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"the mesh asks for {want!r}")
    if pod is None:
        return _mesh((data, model), AXES, dev.type, "make_host_mesh")
    return _mesh((pod, data, model), POD_AXES, dev.type, "make_host_mesh")


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """The reference's production mesh over the running process group:
    (data=16, model=16), 256 ranks, or with ``multi_pod`` (pod=2, data=16,
    model=16), 512 ranks, the pod an outer data-parallel axis.  The group
    may run any backend (the dry run's is the fake one); ``device`` is the
    ranks' device type (``cuda`` unless the CPU is asked for)."""
    dev = device_mod.resolve(device)
    if multi_pod:
        return _mesh((2, 16, 16), POD_AXES, dev.type, "make_production_mesh")
    return _mesh((16, 16), AXES, dev.type, "make_production_mesh")


def _rank_main(job: str, rank: int, data: int, model: int,
               device_type: str, backend: str, store: str, results) -> None:
    world = data * model
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        dev = torch.device("cpu")
        if device_type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        else:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        out = fn(make_host_mesh(data, model, device=dev, backend=backend),
                 dev, *args)
        blob = pickle.dumps(out)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, blob))
    dist.destroy_process_group()


def run_on_mesh(fn: Callable, data: int = 1, model: int = 1, *,
                device=None, backend: str | None = None,
                args: Sequence = (), timeout: float = 900.0) -> list[Any]:
    """Run ``fn(mesh, device, *args)`` in ``data·model`` processes, one per
    rank of a (data, model) mesh, and return their results in rank order.

    ``fn`` and ``args`` are pickled to the processes (``fn`` by its import
    path) and each result comes back pickled by value.  Raises
    ``RuntimeError`` with the traceback of every rank that failed, or when
    a rank dies without a result or ``timeout`` seconds pass; the other
    ranks are then terminated, since they may wait on the failed one in a
    collective."""
    dev = device_mod.resolve(device)
    backend = backend or default_backend(dev)
    world = data * model
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
        # fn and args go through a file: a process start that pickled them
        # into its pipe would block until the process before it had
        # imported torch and read them.
        job = os.path.join(tmp, "job.pkl")
        with open(job, "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main, args=(
            job, r, data, model, dev.type, backend,
            os.path.join(tmp, "store"), results), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict[int, Any] = {}
        failed: dict[int, str] = {}
        pending, exited = set(range(world)), {}
        deadline = time.monotonic() + timeout
        try:
            while pending and not failed:
                try:
                    rank, ok, payload = results.get(timeout=1.0)
                except queue.Empty:
                    now = time.monotonic()
                    if now > deadline:
                        raise RuntimeError(
                            f"run_on_mesh: ranks {sorted(pending)} gave no "
                            f"result in {timeout} s") from None
                    # A rank that ended in error without a result (killed,
                    # or crashed in native code); its last message gets a
                    # few seconds to arrive.
                    for r in sorted(pending):
                        if procs[r].exitcode not in (None, 0):
                            if now - exited.setdefault(r, now) > 5.0:
                                failed[r] = (f"exited with code "
                                             f"{procs[r].exitcode} and no "
                                             "result")
                    continue
                pending.discard(rank)
                if ok:
                    got[rank] = pickle.loads(payload)
                else:
                    failed[rank] = payload
        finally:
            for p in procs:
                if pending:
                    p.terminate()
                p.join(timeout=60)
    if failed:
        raise RuntimeError("run_on_mesh: rank(s) failed:\n" + "\n".join(
            f"--- rank {r} ---\n{msg}" for r, msg in sorted(failed.items())))
    return [got[r] for r in range(world)]
