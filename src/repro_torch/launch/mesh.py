"""Process meshes for the mesh round (port of ``repro.launch.mesh``'s
``make_host_mesh``).

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

The reference's ``make_production_mesh`` and its TPU v5e roofline
constants belong to the LM stack's pod dry run and wait for ROADMAP.md
queue A.13c.
"""

from __future__ import annotations

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


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_host_mesh(data: int = 1, model: int = 1, *, device=None,
                   backend: str | None = None) -> DeviceMesh:
    """The (data, model) ``DeviceMesh`` over this job's ranks, rank
    ``d·model + m`` at (d, m).  Called in each rank after
    ``init_process_group``, whose backend must be ``backend`` (by default
    the device's: no rank switches backend unasked)."""
    dev = device_mod.resolve(device)
    want = backend or default_backend(dev)
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs torch.distributed's process "
                           "group; run_on_mesh starts one per rank")
    if dist.get_backend() != want:
        raise ValueError(f"the process group runs {dist.get_backend()!r}, "
                         f"the mesh asks for {want!r}")
    if data * model != dist.get_world_size():
        raise ValueError(f"a {data}x{model} mesh needs {data * model} "
                         f"ranks, the job has {dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(data * model).reshape(
        data, model), mesh_dim_names=AXES)


def _rank_main(job: str, rank: int, data: int, model: int,
               device_type: str, backend: str, store: str, results) -> None:
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        dev = torch.device("cpu")
        if device_type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                      // (data * model)))
        else:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, store=dist.FileStore(
            store, data * model), rank=rank, world_size=data * model)
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
