"""Communication filters, changed-row selection and the sparse delta form
(port of ``repro.core.ps``).

A filter runs on a client's accumulated (V, K) row delta before it is
pushed (paper §5.3).  ``"dense"`` pushes it whole; ``"threshold"`` zeroes
the rows whose L1 mass is below ``threshold``; ``"topk"`` keeps the
``k_rows`` rows of largest L1 mass plus ``random_rows`` rows drawn
uniformly from the vocabulary, so that rows with small updates are not
starved.  What a filter withholds is carried in the client's residual
(:func:`residual_update`), never dropped.

:class:`SparseDelta` is the row-sliced form a transport ships: one row-id
vector and the packed rows of every statistic; :func:`from_sparse_delta`
rebuilds the dense delta bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


@dataclass(frozen=True)
class FilterSpec:
    """Communication filter configuration.

    kind:
      "dense"     — no filtering; push the full delta matrix.
      "topk"      — keep the ``k_rows`` rows of largest L1 delta mass plus
                    ``random_rows`` uniformly drawn rows.
      "threshold" — zero the rows whose L1 delta mass is below
                    ``threshold``.
    """

    kind: str = "dense"
    k_rows: int = 0
    random_rows: int = 0
    threshold: float = 0.0


class CompressedDelta(NamedTuple):
    """Row ids and the rows kept of a (V, K) delta."""

    indices: torch.Tensor   # (k,) int32 row ids
    values: torch.Tensor    # (k, K) rows; repeated ids carry zero rows


def _top_rows(mass: torch.Tensor, k: int) -> torch.Tensor:
    """The ``k`` largest entries' indices, ties to the lower index first
    as ``jax.lax.top_k`` breaks them (``torch.topk`` promises no order on
    CUDA, so this is a stable sort by −mass)."""
    return torch.argsort(-mass, stable=True)[:k]


def compress_delta(delta: torch.Tensor, spec: FilterSpec,
                   generator: torch.Generator | None = None, *,
                   random_rows: torch.Tensor | None = None
                   ) -> CompressedDelta:
    """The top-k filter of a (V, K) row delta in compressed form.

    The random rows are drawn from ``generator`` on the delta's device, or
    taken from ``random_rows`` ((random_rows,) ids in [0, V)), which
    the parity tests fill with the reference's ``jax.random.randint``
    draw.  A row id that occurs twice keeps its values at its first
    occurrence only, so decompression adds each row once.
    """
    if spec.kind != "topk":
        raise ValueError("compress_delta only applies to the topk filter")
    v = delta.shape[0]
    k_rows = min(spec.k_rows, v)      # small leaves pass through whole
    idx = _top_rows(delta.abs().sum(-1), k_rows).to(torch.int32)
    if spec.random_rows > 0 and k_rows < v:
        if random_rows is None:
            random_rows = torch.randint(0, v, (spec.random_rows,),
                                        generator=generator,
                                        device=delta.device)
        idx = torch.cat([idx, random_rows.to(idx.device, torch.int32)])
    order = torch.argsort(idx, stable=True)
    sorted_idx = idx[order]
    dup_sorted = torch.zeros_like(idx, dtype=torch.bool)
    dup_sorted[1:] = sorted_idx[1:] == sorted_idx[:-1]
    dup = torch.empty_like(dup_sorted)
    dup[order] = dup_sorted
    rows = delta[idx.long()] * (~dup).to(delta.dtype)[:, None]
    return CompressedDelta(indices=idx, values=rows)


def decompress_delta(comp: CompressedDelta, vocab_size: int,
                     n_cols: int) -> torch.Tensor:
    """Scatter a compressed delta back to a dense (V, K) matrix."""
    dense = torch.zeros((vocab_size, n_cols), dtype=comp.values.dtype,
                        device=comp.values.device)
    return dense.index_add_(0, comp.indices.long(), comp.values)


def filter_delta(delta: torch.Tensor, spec: FilterSpec,
                 generator: torch.Generator | None = None, *,
                 random_rows: torch.Tensor | None = None) -> torch.Tensor:
    """Dense in, dense out: the rows the filter keeps, zeros elsewhere.
    ``generator`` and ``random_rows`` serve the top-k filter's random
    rows (:func:`compress_delta`)."""
    if spec.kind == "dense":
        return delta
    if spec.kind == "threshold":
        keep = delta.abs().sum(-1) >= spec.threshold
        return torch.where(keep[:, None], delta, 0.0)
    if spec.kind == "topk":
        comp = compress_delta(delta, spec, generator,
                              random_rows=random_rows)
        return decompress_delta(comp, delta.shape[0], delta.shape[1])
    raise ValueError(spec.kind)


def changed_rows(row_mass: torch.Tensor, k_rows: int, threshold: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k_rows`` rows with the largest accumulated L1 push mass, and
    a validity mask ``mass > threshold``; ties to the lower index."""
    k_rows = min(k_rows, row_mass.shape[0])
    idx = _top_rows(row_mass, k_rows)
    return idx.to(torch.int32), row_mass[idx] > threshold


class SparseDelta(NamedTuple):
    """Row-sliced delta: the ascending union of the rows that are non-zero
    in any statistic, and each statistic's rows there."""

    rows: torch.Tensor                  # (R,) int32, strictly increasing
    values: dict[str, torch.Tensor]     # name -> (R, K) packed rows


def to_sparse_delta(deltas: dict[str, torch.Tensor]) -> SparseDelta:
    """Dense delta dict → :class:`SparseDelta` of its non-zero rows.  The
    dropped rows are exactly 0.0 in every statistic, so
    :func:`from_sparse_delta` rebuilds the dense dict bit for bit."""
    nz = None
    for v in deltas.values():
        row_any = (v != 0).reshape(v.shape[0], -1).any(1)
        nz = row_any if nz is None else nz | row_any
    rows = torch.nonzero(nz).reshape(-1)
    return SparseDelta(rows=rows.to(torch.int32),
                       values={n: v[rows] for n, v in deltas.items()})


def from_sparse_delta(sp: SparseDelta, n_rows: int
                      ) -> dict[str, torch.Tensor]:
    """:class:`SparseDelta` → dense delta dict with ``n_rows`` rows."""
    out = {}
    for n, v in sp.values.items():
        dense = torch.zeros((n_rows,) + tuple(v.shape[1:]), dtype=v.dtype,
                            device=v.device)
        # Unique rows: each selected row receives 0 + x == x exactly.
        out[n] = dense.index_add_(0, sp.rows.to(v.device).long(), v)
    return out


def residual_update(residual: torch.Tensor, delta: torch.Tensor,
                    sent: torch.Tensor) -> torch.Tensor:
    """Error feedback: what a filter withholds is carried to the next
    round instead of dropped."""
    return residual + delta - sent
