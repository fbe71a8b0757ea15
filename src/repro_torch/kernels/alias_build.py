"""Wrappers of the alias-build kernels in ``csrc/alias_build.cu``.

* :func:`alias_build` replaces ``repro/kernels/alias_build.py::alias_build``
  (kernel 2); the port sends full builds through it.
* :func:`alias_build_gather_fused` replaces
  ``repro/kernels/alias_build.py::alias_build_gather_fused`` (kernel 3),
  the incremental rebuild of the changed rows for the LM families.
* :func:`alias_build_rows` replaces
  ``repro/kernels/alias_build.py::alias_build_rows`` (kernel 5), the build
  of a compacted block of gathered changed rows (PDP's incremental
  rebuild).  It takes any number of rows, so it needs no padding to a
  row tile.
* :func:`alias_build_fused` replaces
  ``repro/kernels/alias_build.py::alias_build_fused`` (kernel 6), the full
  LDA build that forms the dense term α·(n_wk+β)/(n_k+β̄) itself
  (``LDAConfig(fused_alias_build=True)``).

Each stages its rows once in shared memory up to
:func:`staged_max_width` wide; wider rows run on the per-lane kernels,
from the same entry point and counted under the same name.

All take CUDA tensors only and never fall back to the plain versions
(``core/alias.py::build``, ``kernels/ref.py``); ``kernels/ops.py`` routes
CPU tensors there.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import function, launch


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# Per-topic arrays that each kernel's block keeps in shared memory beside
# its rows: kernel 6 its denominators, kernel 3 those and its prior.
_BLOCK_ARRAYS = {2: 0, 5: 0, 6: 1, 3: 2}


def staged_max_width(kernel: int = 2) -> int:
    """The widest K that kernel ``kernel`` (2, 3, 5 or 6) stages in shared
    memory on the current card; its entry point sends wider rows to the
    per-lane kernel.  Builds the kernels on first use."""
    return function("alias_build_staged_max_width")(_BLOCK_ARRAYS[kernel])


def _build_rows(name: str, p: torch.Tensor):
    if p.dim() != 2:
        raise ValueError(f"p must be (R, K), got {tuple(p.shape)}")
    _check("p", p, torch.float32)
    r, k = p.shape
    prob = torch.empty((r, k), dtype=torch.float32, device=p.device)
    alias = torch.empty((r, k), dtype=torch.int32, device=p.device)
    mass = torch.empty((r,), dtype=torch.float32, device=p.device)
    launch(name, p.data_ptr(), r, k, prob.data_ptr(), alias.data_ptr(),
           mass.data_ptr())
    return prob, alias, mass


def alias_build(p: torch.Tensor):
    """Alias tables of the rows of ``p`` (R, K) f32 → (prob, alias, mass)."""
    return _build_rows("alias_build", p)


def alias_build_rows(p_rows: torch.Tensor):
    """Alias tables of a compacted (R, K) f32 block of gathered rows →
    (prob, alias, mass); kernel 5, counted apart from full builds."""
    return _build_rows("alias_build_rows", p_rows)


def alias_build_gather_fused(n_wk: torch.Tensor, n_k: torch.Tensor,
                             prior: torch.Tensor, rows: torch.Tensor, *,
                             beta: float, beta_bar: float):
    """Gather rows of ``n_wk``, form prior·((n_wk+β)/(n_k+β̄)) and build
    their tables → (prob, alias, mass, dense), each over the R rows."""
    if n_wk.dim() != 2:
        raise ValueError(f"n_wk must be (V, K), got {tuple(n_wk.shape)}")
    v, k = n_wk.shape
    _check("n_wk", n_wk, torch.float32)
    _check("n_k", n_k, torch.float32, (k,))
    _check("prior", prior, torch.float32, (k,))
    if rows.dim() != 1:
        raise ValueError(f"rows must be (R,), got {tuple(rows.shape)}")
    _check("rows", rows, torch.int32)
    r = rows.shape[0]
    if r and (int(rows.min()) < 0 or int(rows.max()) >= v):
        raise IndexError(f"rows must lie in [0, {v})")
    dev = n_wk.device
    prob = torch.empty((r, k), dtype=torch.float32, device=dev)
    alias = torch.empty((r, k), dtype=torch.int32, device=dev)
    mass = torch.empty((r,), dtype=torch.float32, device=dev)
    dense = torch.empty((r, k), dtype=torch.float32, device=dev)
    launch("alias_build_gather_fused", n_wk.data_ptr(), n_k.data_ptr(),
           prior.data_ptr(), rows.data_ptr(), r, k, beta, beta_bar,
           prob.data_ptr(), alias.data_ptr(), mass.data_ptr(),
           dense.data_ptr())
    return prob, alias, mass, dense


def alias_build_fused(n_wk: torch.Tensor, n_k: torch.Tensor, *,
                      alpha: float, beta: float, beta_bar: float):
    """Tables of the rows of (α·(n_wk+β))/(n_k+β̄), formed in the kernel:
    n_wk (V, K) f32, n_k (K,) f32 → (prob, alias, mass)."""
    if n_wk.dim() != 2:
        raise ValueError(f"n_wk must be (V, K), got {tuple(n_wk.shape)}")
    v, k = n_wk.shape
    _check("n_wk", n_wk, torch.float32)
    _check("n_k", n_k, torch.float32, (k,))
    dev = n_wk.device
    prob = torch.empty((v, k), dtype=torch.float32, device=dev)
    alias = torch.empty((v, k), dtype=torch.int32, device=dev)
    mass = torch.empty((v,), dtype=torch.float32, device=dev)
    launch("alias_build_fused", n_wk.data_ptr(), n_k.data_ptr(), v, k,
           alpha, beta, beta_bar, prob.data_ptr(), alias.data_ptr(),
           mass.data_ptr())
    return prob, alias, mass
