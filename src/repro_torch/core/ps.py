"""Communication filters and changed-row selection (port of the parts of
``repro.core.ps`` the in-process BSP round uses).

Only the dense filter is ported; ``"topk"`` and ``"threshold"`` wait for
ROADMAP.md queue A.8 and raise.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class FilterSpec:
    """Communication filter configuration; ``kind="dense"`` pushes the
    full delta matrix."""

    kind: str = "dense"
    k_rows: int = 0
    random_rows: int = 0
    threshold: float = 0.0

    def __post_init__(self):
        if self.kind != "dense":
            raise NotImplementedError(
                f"filter kind {self.kind!r} is not ported yet "
                "(ROADMAP.md queue A.8); only 'dense' is")


def filter_delta(delta: torch.Tensor, spec: FilterSpec,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """Dense in, dense out; the dense filter passes the delta through."""
    if spec.kind == "dense":
        return delta
    raise NotImplementedError(spec.kind)


def changed_rows(row_mass: torch.Tensor, k_rows: int, threshold: float
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k_rows`` rows with the largest accumulated L1 push mass, and
    a validity mask ``mass > threshold``.

    Ties break as ``jax.lax.top_k`` breaks them, lower index first:
    ``torch.topk`` promises no order on CUDA, so this sorts by (−mass,
    index) with a stable sort instead.
    """
    k_rows = min(k_rows, row_mass.shape[0])
    idx = torch.argsort(-row_mass, stable=True)[:k_rows]
    return idx.to(torch.int32), row_mass[idx] > threshold


def residual_update(residual: torch.Tensor, delta: torch.Tensor,
                    sent: torch.Tensor) -> torch.Tensor:
    """Error feedback: what a filter withholds is carried to the next
    round instead of dropped."""
    return residual + delta - sent
