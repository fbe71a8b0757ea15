"""Wrapper of the fused sorted-layout sweep kernel in ``csrc/mhw_fused.cu``.

Replaces ``repro/kernels/mhw_fused.py::mhw_sweep_fused`` (kernel 1), the
LDA/HDP MH chain over one sorted chunk.  Unlike the TPU kernel it takes
the (D, K) ``n_dk`` matrix and the per-token ``docs`` vector and gathers
each token's document row itself; the function computed is the same.
CUDA tensors only; ``kernels/ops.py`` routes CPU tensors to the plain
version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import launch
from repro_torch.kernels.alias_build import _check


def mhw_sweep_fused(prob, alias, mass, stale, n_wk, n_k, prior, rows, docs,
                    z0, n_dk, slot, coin, u_mix, u_sparse, u_acc, *,
                    beta: float, beta_bar: float) -> torch.Tensor:
    """prob/stale/n_wk (V, K) f32, alias (V, K) i32, mass (V,), n_k/prior
    (K,), rows/docs/z0 (B,) i32, n_dk (D, K) f32, slot (S, B) i32,
    coin/u_mix/u_sparse/u_acc (S, B) f32 → (B,) i32."""
    if prob.dim() != 2:
        raise ValueError(f"prob must be (V, K), got {tuple(prob.shape)}")
    v, k = prob.shape
    b = rows.shape[0]
    s = slot.shape[0]
    for name, t, dt, shape in (
            ("prob", prob, torch.float32, (v, k)),
            ("alias", alias, torch.int32, (v, k)),
            ("mass", mass, torch.float32, (v,)),
            ("stale", stale, torch.float32, (v, k)),
            ("n_wk", n_wk, torch.float32, (v, k)),
            ("n_k", n_k, torch.float32, (k,)),
            ("prior", prior, torch.float32, (k,)),
            ("rows", rows, torch.int32, (b,)),
            ("docs", docs, torch.int32, (b,)),
            ("z0", z0, torch.int32, (b,)),
            ("n_dk", n_dk, torch.float32, None),
            ("slot", slot, torch.int32, (s, b)),
            ("coin", coin, torch.float32, (s, b)),
            ("u_mix", u_mix, torch.float32, (s, b)),
            ("u_sparse", u_sparse, torch.float32, (s, b)),
            ("u_acc", u_acc, torch.float32, (s, b))):
        _check(name, t, dt, shape)
    if n_dk.dim() != 2 or n_dk.shape[1] != k:
        raise ValueError(f"n_dk must be (D, {k}), got {tuple(n_dk.shape)}")
    out = torch.empty((b,), dtype=torch.int32, device=prob.device)
    launch("mhw_sweep_fused", *(t.data_ptr() for t in (
        prob, alias, mass, stale, n_wk, n_k, prior, rows, docs, z0, n_dk,
        slot, coin, u_mix, u_sparse, u_acc, out)), v, k, b, s, beta,
        beta_bar)
    return out
