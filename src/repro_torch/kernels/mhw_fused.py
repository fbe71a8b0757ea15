"""Wrappers of the fused sorted-layout sweep kernels.

* :func:`mhw_sweep_fused` (``csrc/mhw_fused.cu``) replaces
  ``repro/kernels/mhw_fused.py::mhw_sweep_fused`` (kernel 1), the LDA/HDP
  MH chain over one sorted chunk.
* :func:`pdp_sweep_fused` (``csrc/pdp_fused.cu``) replaces
  ``repro/kernels/mhw_fused.py::pdp_sweep_fused`` (kernel 4), the PDP
  chain over the 2K joint (topic, table) outcomes.

Unlike the TPU kernels they take the (D, K) ``n_dk`` matrix and the
per-token ``docs`` vector; the function computed is the same.  Each
wrapper first launches ``kernels/doc_topics.py::doc_topic_lists`` on
``n_dk`` (each document's non-zero topics and counts, which the sweep
reads in place of the dense rows), then the sweep, both on the current
stream and without a host sync.  CUDA tensors only; ``kernels/ops.py``
routes CPU tensors to the plain versions (``core.mhw.sorted_chain``,
``core.pdp.sorted_chain_pdp``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels._build import launch
from repro_torch.kernels.alias_build import _check
from repro_torch.kernels.doc_topics import doc_topic_lists


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
    words, counts = doc_topic_lists(n_dk)
    out = torch.empty((b,), dtype=torch.int32, device=prob.device)
    launch("mhw_sweep_fused", *(t.data_ptr() for t in (
        prob, alias, mass, stale, n_wk, n_k, prior, rows, docs, z0, n_dk,
        words, counts, slot, coin, u_mix, u_sparse, u_acc, out)), v, k, b,
        s, beta, beta_bar)
    return out


def pdp_sweep_fused(prob, alias, mass, stale, m_wk, s_wk, m_k, s_k, stirl,
                    prior, rows, docs, e0, n_dk, slot, coin, u_mix, u_sparse,
                    u_acc, *, b: float, a: float, gamma: float,
                    gamma_bar: float) -> torch.Tensor:
    """prob/stale (V, 2K) f32, alias (V, 2K) i32, mass (V,), m_wk/s_wk
    (V, K) f32, m_k/s_k (K,), stirl (N, N) f32 log-Stirling table, prior
    (2K,), rows/docs/e0 (B,) i32, n_dk (D, K) f32, slot (S, B) i32 in
    [0, 2K), coin/u_mix/u_sparse/u_acc (S, B) f32 → (B,) i32."""
    if m_wk.dim() != 2:
        raise ValueError(f"m_wk must be (V, K), got {tuple(m_wk.shape)}")
    v, k = m_wk.shape
    e = 2 * k
    b_total = rows.shape[0]
    s = slot.shape[0]
    n = stirl.shape[0]
    for name, t, dt, shape in (
            ("prob", prob, torch.float32, (v, e)),
            ("alias", alias, torch.int32, (v, e)),
            ("mass", mass, torch.float32, (v,)),
            ("stale", stale, torch.float32, (v, e)),
            ("m_wk", m_wk, torch.float32, (v, k)),
            ("s_wk", s_wk, torch.float32, (v, k)),
            ("m_k", m_k, torch.float32, (k,)),
            ("s_k", s_k, torch.float32, (k,)),
            ("stirl", stirl, torch.float32, (n, n)),
            ("prior", prior, torch.float32, (e,)),
            ("rows", rows, torch.int32, (b_total,)),
            ("docs", docs, torch.int32, (b_total,)),
            ("e0", e0, torch.int32, (b_total,)),
            ("n_dk", n_dk, torch.float32, None),
            ("slot", slot, torch.int32, (s, b_total)),
            ("coin", coin, torch.float32, (s, b_total)),
            ("u_mix", u_mix, torch.float32, (s, b_total)),
            ("u_sparse", u_sparse, torch.float32, (s, b_total)),
            ("u_acc", u_acc, torch.float32, (s, b_total))):
        _check(name, t, dt, shape)
    if n < 2:
        raise ValueError(f"stirl must be at least 2x2, got {n}x{n}")
    if n_dk.dim() != 2 or n_dk.shape[1] != k:
        raise ValueError(f"n_dk must be (D, {k}), got {tuple(n_dk.shape)}")
    words, counts = doc_topic_lists(n_dk)
    # The factors of an empty (word, topic) cell, one set per topic.
    topic_scratch = torch.empty((4 * k,), dtype=torch.float32,
                                device=m_wk.device)
    out = torch.empty((b_total,), dtype=torch.int32, device=m_wk.device)
    launch("pdp_sweep_fused", *(t.data_ptr() for t in (
        prob, alias, mass, stale, m_wk, s_wk, m_k, s_k, stirl, prior, rows,
        docs, e0, n_dk, words, counts, topic_scratch, slot, coin, u_mix,
        u_sparse, u_acc, out)), v, k, b_total, s, n, b, a, gamma, gamma_bar)
    return out
