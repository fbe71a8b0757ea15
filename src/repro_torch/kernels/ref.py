"""Plain PyTorch version of the gather build, kernel 3 (port of part of
``repro.kernels.ref``).

The plain versions of kernels 1 and 2 are ``core.mhw.sorted_chain`` and
``core.alias.build``; this module holds only what computes something of
its own.  The CPU path of ``ops.build_tables_gather_fused`` runs it, and
``chip_smoke.py`` compares the kernel with it on the card.  Nothing on the
main path calls it when a card is present.
"""

from __future__ import annotations

import torch

from repro_torch.core import alias as alias_mod


def gather_dense_ref(n_wk, n_k, prior, rows, *, beta: float,
                     beta_bar: float) -> torch.Tensor:
    """prior·((n_wk[rows]+β)/(n_k+β̄)), the division grouped first as in
    ``lda.dense_probs``."""
    return prior[None, :] * ((n_wk[rows.long()] + beta)
                             / (n_k[None, :] + beta_bar))


def alias_build_gather_fused_ref(n_wk, n_k, prior, rows, *, beta: float,
                                 beta_bar: float):
    """(prob, alias, mass, dense) over the gathered rows: plain version of
    kernel 3."""
    dense = gather_dense_ref(n_wk, n_k, prior, rows, beta=beta,
                             beta_bar=beta_bar)
    t = alias_mod.build(dense)
    return t.prob, t.alias, t.mass, dense
