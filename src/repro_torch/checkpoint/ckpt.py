"""Snapshots on disk (port of ``repro.checkpoint.ckpt``), in the same
format, so a snapshot written by either package is read by the other.

Layout: ``<dir>/<name>-<step>.npz`` written through a temporary file and
renamed, plus a ``<name>.MANIFEST`` (JSON: ``latest``, the newest file's
basename; ``step``; ``steps``, every step written).  Basenames only, so a
moved directory still restores; :func:`restore_latest` and
:func:`load_raw` fall back to an earlier step when the newest file is
truncated or corrupt (:class:`CorruptSnapshotError`).

A tree is flattened in plain Python, as the reference flattens a JAX
pytree: a dict child by its key (keys in sorted order), a tuple or list
child by its index, a NamedTuple child by its field name, no leaf for
``None``; the path is joined by ``/``.  Leaves are tensors (written as
CPU numpy arrays; bfloat16 widened to float32), numpy arrays and Python
or numpy scalars.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
import zlib
from typing import Any, Iterator

import numpy as np
import torch

SEP = "/"

# Errors that a truncated or bit-rotted npz raises anywhere between open
# and member decompression.
_NPZ_READ_ERRORS = (OSError, EOFError, ValueError, KeyError,
                    zipfile.BadZipFile, zlib.error)


class CorruptSnapshotError(RuntimeError):
    """The snapshot file exists but cannot be read back (truncated write,
    bit rot, missing npz member).  A template mismatch is a ``ValueError``
    instead: an earlier snapshot would mismatch the same way."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> list[tuple[str, Any]] | None:
    """(key, child) pairs of a container node; None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(tree)]
    return None


def _leaves(tree, prefix: tuple[str, ...] = ()
            ) -> Iterator[tuple[str, Any]]:
    """(flat key, leaf) pairs in flattening order; ``None`` has none."""
    if tree is None:
        return
    kids = _children(tree)
    if kids is None:
        yield SEP.join(prefix), tree
        return
    for key, child in kids:
        yield from _leaves(child, prefix + (key,))


def _rebuild(tree, fn, prefix: tuple[str, ...] = ()):
    """``tree`` with each leaf replaced by ``fn(flat key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, fn, prefix + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return fn(SEP.join(prefix), tree)


def map_leaves(tree, fn):
    """``tree`` with each leaf replaced by ``fn(leaf)``, containers kept."""
    return _rebuild(tree, lambda _, leaf: fn(leaf))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:     # npz has no bfloat16: widen;
            t = t.to(torch.float32)       # restore() narrows via template
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}


def _kind(dtype) -> str:
    """numpy's dtype kind of a numpy or torch dtype."""
    if isinstance(dtype, torch.dtype):
        if dtype.is_floating_point:
            return "f"
        if dtype == torch.bool:
            return "b"
        if dtype.is_complex:
            return "c"
        return "u" if dtype == torch.uint8 else "i"
    return np.dtype(dtype).kind


def _read_manifest(directory: str, name: str) -> dict | None:
    manifest = os.path.join(directory, f"{name}.MANIFEST")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        return json.load(f)


def save(directory: str, name: str, step: int, tree: Any) -> str:
    """Write ``tree`` as step ``step`` and point the manifest at it."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    fname = f"{name}-{step}.npz"
    path = os.path.join(directory, fname)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)
    prev = _read_manifest(directory, name) or {}
    steps = list(prev.get("steps", []))
    if not steps and "step" in prev:
        steps = [prev["step"]]
    if step not in steps:
        steps.append(step)
    manifest = os.path.join(directory, f"{name}.MANIFEST")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump({"latest": fname, "step": step,
                   "steps": sorted(set(steps))}, f)
    os.replace(tmp, manifest)
    return path


def latest_step(directory: str, name: str) -> int | None:
    m = _read_manifest(directory, name)
    return None if m is None else m["step"]


def _snapshot_path(directory: str, name: str, step: int,
                   manifest: dict | None) -> str:
    if manifest is not None and manifest.get("step") == step \
            and "latest" in manifest:
        # basename: a manifest that recorded a joined path still resolves
        # against its own directory.
        return os.path.join(directory, os.path.basename(manifest["latest"]))
    return os.path.join(directory, f"{name}-{step}.npz")


def restore(directory: str, name: str, template: Any,
            step: int | None = None) -> Any:
    """Restore into the structure of ``template``; saved leaves that the
    template lacks are ignored.  A tensor leaf of the template comes back
    as a CPU tensor of its dtype, any other leaf as a numpy array.

    Raises :class:`CorruptSnapshotError` when the file is unreadable and
    ``ValueError`` naming the leaf when the snapshot lacks a template leaf
    or differs from it in shape or dtype kind."""
    manifest = _read_manifest(directory, name)
    if step is None:
        if manifest is None:
            raise FileNotFoundError(f"no snapshot for {name} in {directory}")
        step = manifest["step"]
    path = _snapshot_path(directory, name, step, manifest)
    try:
        data = np.load(path)
        available = set(data.files)
    except _NPZ_READ_ERRORS as e:
        raise CorruptSnapshotError(
            f"snapshot {path} is unreadable ({type(e).__name__}: {e}); "
            "it was likely truncated by a preempted writer") from e

    def load(key: str, leaf):
        if key not in available:
            raise ValueError(
                f"snapshot {path} has no leaf {key!r} required by the "
                f"restore template (saved leaves: {sorted(available)[:8]}…)")
        try:
            arr = data[key]
        except _NPZ_READ_ERRORS as e:
            raise CorruptSnapshotError(
                f"snapshot {path} leaf {key!r} is unreadable "
                f"({type(e).__name__}: {e})") from e
        shape = getattr(leaf, "shape", None)
        if shape is not None and tuple(arr.shape) != tuple(shape):
            raise ValueError(
                f"snapshot {path} leaf {key!r} has shape {arr.shape} but "
                f"the restore template expects {tuple(shape)} (vocabulary, "
                "topics, clients or shards changed?)")
        dtype = getattr(leaf, "dtype", None)
        if dtype is not None and _kind(arr.dtype) != _kind(dtype):
            raise ValueError(
                f"snapshot {path} leaf {key!r} has dtype {arr.dtype} but "
                f"the restore template expects {dtype}")
        if isinstance(leaf, torch.Tensor):
            return torch.as_tensor(arr).to(leaf.dtype)
        if dtype is not None and arr.dtype != dtype:
            return arr.astype(dtype)
        return arr

    try:
        return _rebuild(template, load)
    finally:
        data.close()


def load_raw(directory: str, name: str,
             step: int | None = None) -> tuple[int, dict[str, np.ndarray]]:
    """The newest readable snapshot as a flat ``{key: array}`` dict and its
    step, with no template; walks the manifest's steps past corrupt files
    as :func:`restore_latest` does.  An explicit ``step`` disables the
    fallback."""
    manifest = _read_manifest(directory, name)
    if manifest is None:
        raise FileNotFoundError(f"no snapshot for {name} in {directory}")
    steps = [step] if step is not None else \
        sorted(set(manifest.get("steps", []) or [manifest["step"]]),
               reverse=True)
    errors: list[str] = []
    for s in steps:
        path = _snapshot_path(directory, name, s, manifest)
        try:
            with np.load(path, allow_pickle=False) as data:
                return s, {k: data[k] for k in data.files}
        except _NPZ_READ_ERRORS as e:
            if step is not None:
                raise CorruptSnapshotError(
                    f"snapshot {path} is unreadable "
                    f"({type(e).__name__}: {e})") from e
            errors.append(f"step {s}: {type(e).__name__}: {e}")
    raise CorruptSnapshotError(
        f"no readable snapshot for {name} in {directory}; tried steps "
        f"{steps}: {errors}")


def restore_latest(directory: str, name: str, template: Any,
                   step: int | None = None) -> Any:
    """Restore the newest readable snapshot, walking the manifest's steps
    from newest to oldest past any :class:`CorruptSnapshotError`.  An
    explicit ``step`` disables the fallback; a template mismatch
    (``ValueError``) is never skipped."""
    if step is not None:
        return restore(directory, name, template, step=step)
    manifest = _read_manifest(directory, name)
    if manifest is None:
        raise FileNotFoundError(f"no snapshot for {name} in {directory}")
    steps = sorted(set(manifest.get("steps", []) or [manifest["step"]]),
                   reverse=True)
    errors: list[str] = []
    for s in steps:
        try:
            return restore(directory, name, template, step=s)
        except CorruptSnapshotError as e:
            errors.append(str(e))
    raise CorruptSnapshotError(
        f"no readable snapshot for {name} in {directory}; tried steps "
        f"{steps}: {errors}")
