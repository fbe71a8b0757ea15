"""Wrappers of the alias-draw kernels in ``csrc/alias_sample.cu``.

* :func:`alias_sample` replaces ``repro/kernels/alias_sample.py::
  alias_sample`` (kernel 8), draws for an unsorted stream.
* :func:`alias_sample_sorted` replaces ``repro/kernels/alias_sample.py::
  alias_sample_sorted`` (kernel 7), draws for the ascending sorted stream.

Both compute the same function, one draw per entry: ``slot`` if
``coin < prob[row, slot]``, else ``alias[row, slot]``, and 0 for rows
outside [0, V) (the sorted layout's padding sentinels).  The TPU kernel's
``vstart``/``vcount`` window only chose which table tiles to stage in
VMEM; a CUDA thread reads its own entries, so the sorted variant needs no
window.  Kernel 8 has a body of its own for a stream in any order: each
thread takes four draws and issues their gathers together.  Slots must lie
in [0, K).  No draw, no launch.  CUDA tensors only; ``kernels/ops.py``
routes CPU tensors to ``kernels/ref.py``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import launch
from repro_torch.kernels.alias_build import _check


def _draw(name: str, prob, alias, rows, slot, coin) -> torch.Tensor:
    if prob.dim() != 2:
        raise ValueError(f"prob must be (V, K), got {tuple(prob.shape)}")
    v, k = prob.shape
    if rows.dim() != 1:
        raise ValueError(f"rows must be (B,), got {tuple(rows.shape)}")
    b = rows.shape[0]
    for arg, t, dt, shape in (("prob", prob, torch.float32, (v, k)),
                              ("alias", alias, torch.int32, (v, k)),
                              ("rows", rows, torch.int32, (b,)),
                              ("slot", slot, torch.int32, (b,)),
                              ("coin", coin, torch.float32, (b,))):
        _check(arg, t, dt, shape)
    out = torch.empty((b,), dtype=torch.int32, device=prob.device)
    if b:
        launch(name, prob.data_ptr(), alias.data_ptr(), rows.data_ptr(),
               slot.data_ptr(), coin.data_ptr(), b, v, k, out.data_ptr())
    return out


def alias_sample(prob, alias, rows, slot, coin) -> torch.Tensor:
    """prob (V, K) f32, alias (V, K) i32, rows/slot (B,) i32, coin (B,)
    f32 → (B,) i32 draws."""
    return _draw("alias_sample", prob, alias, rows, slot, coin)


def alias_sample_sorted(prob, alias, rows, slot, coin) -> torch.Tensor:
    """The same draws over an ascending stream with sentinels ≥ V."""
    return _draw("alias_sample_sorted", prob, alias, rows, slot, coin)
