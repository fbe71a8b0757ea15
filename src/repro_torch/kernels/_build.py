"""Builds the CUDA sources under ``repro_torch/csrc`` and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, ``build/kernels/<name>-<hash>.so`` at the
root of the checkout (the hash is of the source, the shared ``*.cuh``
headers and the flags, so an edited source or header is rebuilt).  All
sources compile at once, one ``nvcc`` process each.  Nothing is built when
a module is imported: the first kernel launch, or an explicit
:func:`build_all`, builds.

Building and loading hold one lock, so the threads of a process (the
inference server's batcher beside the main thread) build and load each
library once; each build's temporary files are named uniquely per call.
The libraries are loaded with ``ctypes``.  Each wrapper passes tensor
pointers and PyTorch's current stream as ``c_void_p`` and raises if the C
function returns a non-zero ``cudaGetLastError()``.

``LAUNCHES`` counts kernel launches per wrapper; a wrapper adds one only
where it launches its kernel.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
import uuid
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

LAUNCHES: collections.Counter = collections.Counter()

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[str, object] = {}     # entry points with their types declared
_LOCK = threading.RLock()        # held by build_all and the loads
BUILD_LOG: dict[str, str] = {}

P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_long
F = ctypes.c_float
SIGNATURES = {
    "alias_build": ("alias_build", [P, I, I, P, P, P, P]),
    "alias_build_rows": ("alias_build", [P, I, I, P, P, P, P]),
    "alias_build_gather_fused": ("alias_build",
                                 [P, P, P, P, I, I, F, F, P, P, P, P, P]),
    "mhw_sweep_fused": ("mhw_fused", [P] * 19 + [I, I, L, I, F, F, P]),
    "pdp_sweep_fused": ("pdp_fused",
                        [P] * 23 + [I, I, L, I, I, F, F, F, F, P]),
    "doc_topic_lists": ("doc_topics", [P, I, I, P, P, P]),
    "alias_build_fused": ("alias_build", [P, P, I, I, F, F, F, P, P, P, P]),
    "alias_sample": ("alias_sample", [P] * 5 + [L, I, I, P, P]),
    "alias_sample_sorted": ("alias_sample", [P] * 5 + [L, I, I, P, P]),
    "mh_accept": ("mh_accept", [P] * 7 + [L, P, P]),
}
# C functions that launch nothing: no stream, never counted in LAUNCHES.
QUERIES = {
    "alias_build_staged_max_width": ("alias_build", [I]),
}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found; the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _target(src: Path) -> Path:
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{src.stem}-{digest[:16]}.so"


def _tmp_path(out: Path) -> Path:
    """A temporary name for ``out`` that no other build, in this process or
    another, uses."""
    return out.with_suffix(f".{os.getpid()}-{uuid.uuid4().hex}.tmp")


def build_all() -> float:
    """Compile every source that has no up-to-date library, all at once.
    Returns the seconds spent."""
    with _LOCK:
        return _build_all()


def _build_all() -> float:
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        out = _target(src)
        if out.exists():
            continue
        tmp = _tmp_path(out)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, tmp, proc))
    failed = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        BUILD_LOG[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def function(name: str):
    """The C entry point ``name`` with its argument types declared."""
    fn = _FNS.get(name)
    if fn is not None:
        return fn
    stem, argtypes = SIGNATURES[name] if name in SIGNATURES else QUERIES[name]
    with _LOCK:
        if stem not in _LIBS:
            out = _target(CSRC / f"{stem}.cu")
            if not out.exists():
                _build_all()
            _LIBS[stem] = ctypes.CDLL(str(out))
        fn = getattr(_LIBS[stem], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Call a C entry point on PyTorch's current stream; raise on error."""
    stream = torch.cuda.current_stream().cuda_stream
    err = function(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error "
                           f"{err}")
    LAUNCHES[name] += 1
