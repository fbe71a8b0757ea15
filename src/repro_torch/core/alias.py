"""Walker's alias method, Vose's two-stack variant (port of
``repro.core.alias``).

:func:`build` is the plain PyTorch version of the alias-build kernels
(``kernels/alias_build.py``): the reference's fixed K-step two-stack loop,
run in lockstep over the rows.  It keeps, exactly:

* the stable larges-first partition of each row into the two stacks;
* the K-step loop with its ``active`` guard (a row whose stacks ran dry
  stops changing);
* the ``prob=1``/``alias=self`` finish for slots never assigned;
* the uniform fallback for rows with zero mass.

Each step updates the per-row state with row-indexed scatters, O(R) per
step; it never rewrites the whole (R, K) state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class AliasTable(NamedTuple):
    """prob (R, K) f32 thresholds, alias (R, K) int32 alternatives, mass
    (R,) f32 total unnormalized mass per row."""

    prob: torch.Tensor
    alias: torch.Tensor
    mass: torch.Tensor


def row_sums(p: torch.Tensor) -> torch.Tensor:
    """Row sums of (R, K) ``p`` accumulated left to right in float32, the
    order the reference's row sum takes on the CPU at small K and the
    order the build kernels take, so the masses agree bit for bit."""
    acc = torch.zeros(p.shape[0], dtype=p.dtype, device=p.device)
    for c in range(p.shape[1]):
        acc = acc + p[:, c]
    return acc


def scaled_rows(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mass, p/mass·K) per row, with the uniform fallback for zero mass."""
    k = p.shape[-1]
    mass = row_sums(p)
    safe = mass > 0
    pn = torch.where(safe[:, None],
                     p / torch.where(safe, mass, 1.0)[:, None],
                     torch.full_like(p, 1.0 / k))
    return mass, pn * k


def build(p: torch.Tensor) -> AliasTable:
    """Alias tables for the rows of ``p`` (R, K), unnormalized f32."""
    p = p.to(torch.float32)
    r, k = p.shape
    dev = p.device
    mass, scaled = scaled_rows(p)
    scaled = scaled.clone()
    idx = torch.arange(k, dtype=torch.int32, device=dev)
    rows = torch.arange(r, device=dev)

    is_small = scaled < 1.0
    # Stable partition: larges first (in index order), then smalls.
    stack = torch.argsort(is_small.to(torch.int8), dim=-1,
                          stable=True).to(torch.int32)
    n_small = is_small.sum(-1).to(torch.int32)
    n_large = k - n_small
    large_top = n_large - 1
    small_top = k - n_small

    prob = torch.ones((r, k), dtype=torch.float32, device=dev)
    alias = idx.expand(r, k).clone()
    assigned = torch.zeros((r, k), dtype=torch.bool, device=dev)

    for _ in range(k):
        active = (n_small > 0) & (n_large > 0)
        i = stack[rows, small_top.clamp(0, k - 1).long()].long()
        j = stack[rows, large_top.clamp(0, k - 1).long()]
        jl = j.long()
        si = scaled[rows, i]
        prob[rows, i] = torch.where(active, si, prob[rows, i])
        alias[rows, i] = torch.where(active, j, alias[rows, i])
        assigned[rows, i] |= active
        sj_old = scaled[rows, jl]
        sj = sj_old - (1.0 - si)            # the donor absorbs the slack
        scaled[rows, jl] = torch.where(active, sj, sj_old)
        # Pop both; re-push j onto the stack it now belongs to (small: at
        # the freed small top; large: back where it was).
        j_small = sj < 1.0
        pos = torch.where(j_small, small_top, large_top).clamp(0, k - 1)
        stack[rows, pos.long()] = torch.where(active, j,
                                              stack[rows, pos.long()])
        step_small = active & ~j_small
        step_large = active & j_small
        small_top = small_top + step_small
        n_small = n_small - step_small.to(torch.int32)
        large_top = large_top - step_large.to(torch.int32)
        n_large = n_large - step_large.to(torch.int32)

    prob = torch.where(assigned, prob, 1.0)
    alias = torch.where(assigned, alias, idx)
    return AliasTable(prob=prob, alias=alias, mass=mass)


def sample_rows(tables: AliasTable, rows: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """One draw per entry of ``rows`` from its row's table."""
    k = tables.prob.shape[-1]
    dev = tables.prob.device
    slot = torch.randint(0, k, rows.shape, generator=generator, device=dev)
    coin = torch.rand(rows.shape, generator=generator, device=dev)
    r = rows.long()
    return torch.where(coin < tables.prob[r, slot], slot,
                       tables.alias[r, slot].long()).to(torch.int32)


def update_rows(tables: AliasTable, stale: torch.Tensor, rows: torch.Tensor,
                valid: torch.Tensor, sub: AliasTable, p_rows: torch.Tensor
                ) -> tuple[AliasTable, torch.Tensor]:
    """Scatter freshly built rows into copies of the resident table and
    stale snapshot; rows with ``valid=False`` keep their entries.  ``rows``
    must be duplicate-free where valid."""
    sel = rows[valid].long()

    def put(old, new):
        return old.index_put((sel,), new[valid])

    return AliasTable(prob=put(tables.prob, sub.prob),
                      alias=put(tables.alias, sub.alias),
                      mass=put(tables.mass, sub.mass)), put(stale, p_rows)


def logpdf_rows(p_rows: torch.Tensor, rows: torch.Tensor,
                outcome: torch.Tensor) -> torch.Tensor:
    """log of the exact unnormalized density ``p_rows[rows, outcome]``."""
    return torch.log(p_rows[rows.long(), outcome.long()] + 1e-30)
