"""The kernel loader under threads (``repro_torch.kernels._build``).

The inference server's batcher thread launches kernels 1 and 4 and the
document-list build while the main thread may be building too: each
library must be built and loaded once, and two builds must never share a
temporary file.  ``nvcc`` and ``ctypes.CDLL`` are replaced by fakes that
record their calls, so this runs on the CPU.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

from repro_torch.kernels import _build


class _FakeProc:
    calls: list[list[str]] = []
    lock = threading.Lock()

    def __init__(self, argv, **kw):
        with self.lock:
            self.calls.append(list(argv))
        self.out = Path(argv[argv.index("-o") + 1])
        self.returncode = 0

    def communicate(self):
        time.sleep(0.05)            # widen the window two threads share
        self.out.write_bytes(b"fake library")
        return "ptxas info: 0 registers", None


class _FakeLib:
    loads: list[str] = []

    def __init__(self, path):
        self.path = path
        self.loads.append(path)

    def __getattr__(self, name):
        fn = type("_Fn", (), {})()
        setattr(self, name, fn)
        return fn


def test_two_threads_build_and_load_each_library_once(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "_FNS", {})
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "Popen", _FakeProc)
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLib)
    _FakeProc.calls, _FakeLib.loads = [], []

    names = ("mhw_sweep_fused", "doc_topic_lists", "pdp_sweep_fused",
             "alias_build")
    start = threading.Barrier(2)
    got: dict[int, list] = {}

    def worker(i):
        start.wait()
        got[i] = [_build.function(n) for n in names[i::2] + names]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    sources = sorted(_build.CSRC.glob("*.cu"))
    assert len(_FakeProc.calls) == len(sources)           # one build
    tmps = [argv[argv.index("-o") + 1] for argv in _FakeProc.calls]
    assert len(set(tmps)) == len(tmps)
    assert sorted(_FakeLib.loads) == sorted(
        str(_build._target(_build.CSRC / f"{s}.cu"))
        for s in ("mhw_fused", "doc_topics", "pdp_fused", "alias_build"))
    for n, fn in zip(names, got[0][-len(names):]):
        assert fn is _build.function(n) and fn.restype is _build.ctypes.c_int
        assert fn.argtypes == _build.SIGNATURES[n][1]
    assert got[0][-len(names):] == got[1][-len(names):]
    assert all(p.exists() for p in map(_build._target, sources))


def test_temporary_names_are_unique_per_call(tmp_path):
    out = tmp_path / "alias_build-0123.so"
    names = {_build._tmp_path(out) for _ in range(64)}
    assert len(names) == 64
    assert all(p.parent == tmp_path and p.name.endswith(".tmp")
               for p in names)
