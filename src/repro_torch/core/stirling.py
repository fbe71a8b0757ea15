"""Generalized Stirling numbers for the PDP sampler (port of
``repro.core.stirling``).

The PDP conditional (paper eqs. 5-6) uses ratios of generalized Stirling
numbers S^N_{M,a} with the recurrence

    S^{N+1}_{M,a} = S^N_{M-1,a} + (N - M a) S^N_{M,a},
    S^N_{M,a} = 0 for M > N,   S^0_{0,a} = 1.

They grow super-exponentially, so a log-space table is computed on the
host in float64 once per (n_max, a), cast to float32 once per device, and
ratios are looked up with gathers.  Counts are clamped to the table, as in
the reference: at counts above ``n_max`` the clamp binds.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NEG_INF = -1e30


@functools.lru_cache(maxsize=8)
def log_stirling_table(n_max: int, a: float) -> np.ndarray:
    """logS with shape (n_max+1, n_max+1): logS[N, M] = log S^N_{M,a}."""
    log_s = np.full((n_max + 1, n_max + 1), NEG_INF, dtype=np.float64)
    log_s[0, 0] = 0.0
    for n in range(0, n_max):
        m = np.arange(0, n + 2)
        # term1: S^n_{m-1}
        t1 = np.full(n + 2, NEG_INF)
        t1[1:] = log_s[n, 0:n + 1]
        # term2: (n - m a) S^n_m
        coef = n - m * a
        t2 = np.where(coef > 0,
                      np.log(np.maximum(coef, 1e-300)) + log_s[n, 0:n + 2],
                      NEG_INF)
        log_s[n + 1, 0:n + 2] = np.logaddexp(t1, t2)
    return log_s


@functools.lru_cache(maxsize=8)
def _table(n_max: int, a: float, device: str) -> torch.Tensor:
    return torch.from_numpy(
        log_stirling_table(n_max, a).astype(np.float32)).to(device)


def as_tensor(n_max: int, a: float, device) -> torch.Tensor:
    """The float32 table on ``device``, made once per (n_max, a, device)
    (the counterpart of the reference's ``as_jax``)."""
    return _table(n_max, a, str(torch.device(device)))


def _clip_int(x: torch.Tensor, hi: int) -> torch.Tensor:
    """clip to [0, hi] in float, then truncate to int (``jnp.clip(...)
    .astype(int32)``)."""
    return torch.clamp(x, 0, hi).to(torch.int64)


def log_ratio_same(table: torch.Tensor, n: torch.Tensor, m: torch.Tensor
                   ) -> torch.Tensor:
    """log S^{n+1}_{m} - log S^{n}_{m} (paper eq. 5 ratio), clamped to the
    table: n to [0, hi], m to [0, hi+1]."""
    hi = table.shape[0] - 2
    n_c = _clip_int(n, hi)
    m_c = _clip_int(m, hi + 1)
    return table[n_c + 1, m_c] - table[n_c, m_c]


def log_ratio_incr(table: torch.Tensor, n: torch.Tensor, m: torch.Tensor
                   ) -> torch.Tensor:
    """log S^{n+1}_{m+1} - log S^{n}_{m} (paper eq. 6 ratio), clamped: n and
    m both to [0, hi]."""
    hi = table.shape[0] - 2
    n_c = _clip_int(n, hi)
    m_c = _clip_int(m, hi)
    return table[n_c + 1, m_c + 1] - table[n_c, m_c]
