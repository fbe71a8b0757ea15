"""Parameter projection for constraint-violation resolution (port of
``repro.core.projection``, paper §5.5).

A :class:`Rule` constrains a pair of statistics elementwise; an
:class:`Aggregate` re-derives a sum statistic from its source (the
paper's C2 tuples).  The paper's three schedules of one projection:

* Algorithm 1, :func:`project`: one pass over the whole statistics.
* Algorithm 2, :func:`project_distributed`: the rows are partitioned over
  the ranks of a mesh axis, each projects its slice, and the aggregates
  are re-derived with an ``all_reduce`` of the slices' partial sums.
* Algorithm 3, :func:`make_on_demand`: a pull-path filter that makes a
  read feasible and re-derives no aggregate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.core import collectives

Stats = dict[str, torch.Tensor]


@dataclass(frozen=True)
class Rule:
    """kind: "le" (A ≤ B), "ge" (A ≥ B), "nonneg" (A ≥ 0), "pos_link"
    (B > 0 ⇒ A ≥ 1, B = 0 ⇒ A = 0)."""

    kind: str
    a: str
    b: str | None = None


@dataclass(frozen=True)
class Aggregate:
    """C2 tuple: stats[out] must equal stats[src].sum(axis)."""

    src: str
    out: str
    axis: int | tuple[int, ...] = 0


def _apply_rule(stats: Stats, rule: Rule) -> Stats:
    a = stats[rule.a]
    out = dict(stats)
    if rule.kind == "nonneg":
        out[rule.a] = torch.clamp_min(a, 0.0)
        return out
    b = stats[rule.b]
    if rule.kind == "le":
        out[rule.a] = torch.minimum(a, b)
    elif rule.kind == "ge":
        out[rule.a] = torch.maximum(a, b)
    elif rule.kind == "pos_link":
        out[rule.a] = torch.where(b > 0, torch.clamp_min(a, 1.0), 0.0)
    else:
        raise ValueError(rule.kind)
    return out


def count_violations(stats: Stats, rules: Sequence[Rule]) -> torch.Tensor:
    """Total number of elementwise constraint violations."""
    dev = next(iter(stats.values())).device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for rule in rules:
        a = stats[rule.a]
        if rule.kind == "nonneg":
            total = total + (a < 0).sum()
            continue
        b = stats[rule.b]
        if rule.kind == "le":
            total = total + (a > b).sum()
        elif rule.kind == "ge":
            total = total + (a < b).sum()
        elif rule.kind == "pos_link":
            total = total + ((b > 0) & (a < 1)).sum()
            total = total + ((b <= 0) & (a != 0)).sum()
        else:
            raise ValueError(rule.kind)
    return total


def project(stats: Stats, rules: Sequence[Rule],
            aggregates: Sequence[Aggregate] = ()) -> Stats:
    """Algorithm 1: rules in order, then aggregate re-derivation."""
    for rule in rules:
        stats = _apply_rule(stats, rule)
    stats = dict(stats)
    for agg in aggregates:
        stats[agg.out] = stats[agg.src].sum(agg.axis)
    return stats


def project_distributed(stats: Stats, rules: Sequence[Rule],
                        aggregates: Sequence[Aggregate], mesh,
                        shard_axis: str = "model",
                        row_specs: dict[str, str | None] | None = None
                        ) -> Stats:
    """Algorithm 2 over the ranks of ``mesh``'s ``shard_axis`` (a
    ``torch.distributed`` ``DeviceMesh``), called on every rank of it.

    Rank j of the n in the axis takes the j-th of n equal contiguous row
    slices of each statistic that ``row_specs`` partitions (the axis name;
    the default for every statistic that is not an aggregate's output) and
    the whole of each it replicates (``None``), applies ``rules`` in
    order, and re-derives each aggregate as the ``all_reduce`` (SUM) of
    its source's partial ``sum(axis)`` over the axis.  The projected slices
    are gathered back in rank order, so every rank returns the same whole
    statistics.  The elementwise rules are row-parallel, so the slices
    equal Algorithm 1's rows bit for bit; an aggregate is a sum of partial
    sums, exact for float32 integer counts below 2^24 in any order.
    """
    group = mesh.get_group(shard_axis)
    n = dist.get_world_size(group)
    me = mesh.get_local_rank(shard_axis)
    specs = row_specs or {}
    outs = {a.out for a in aggregates}
    parted = {k for k in stats
              if k not in outs and specs.get(k, shard_axis) is not None}
    local = {}
    for k, v in stats.items():
        if k in outs:
            continue
        if k in parted:
            if v.shape[0] % n:
                raise ValueError(f"{k} has {v.shape[0]} rows, not a multiple "
                                 f"of the {n} ranks of {shard_axis!r}")
            rows = v.shape[0] // n
            v = v[me * rows:(me + 1) * rows]
        local[k] = v
    for rule in rules:
        local = _apply_rule(local, rule)
    out = {k: torch.cat(collectives.all_gather(v, group, f"alg2 {k}"))
           if k in parted else v for k, v in local.items()}
    for agg in aggregates:
        out[agg.out] = collectives.all_reduce_sum(
            local[agg.src].sum(agg.axis), group, f"alg2 {agg.out}")
    return out


def make_on_demand(rules: Sequence[Rule]) -> Callable[[Stats], Stats]:
    """Algorithm 3: a pull-path filter that applies ``rules`` to every read.
    Aggregates are not re-derived (that needs a global pass); the read is
    only made feasible, as the paper's server-side variant."""

    def on_pull(stats: Stats) -> Stats:
        for rule in rules:
            stats = _apply_rule(stats, rule)
        return stats

    return on_pull


PDP_RULES = (
    Rule("nonneg", "m_wk"),
    Rule("nonneg", "s_wk"),
    Rule("pos_link", "s_wk", "m_wk"),   # m>0 => s>=1 ; m=0 => s=0
    Rule("le", "s_wk", "m_wk"),         # s <= m
)
PDP_AGGREGATES = (
    Aggregate("m_wk", "m_k", 0),
    Aggregate("s_wk", "s_k", 0),
)

LDA_RULES = (Rule("nonneg", "n_wk"),)
LDA_AGGREGATES = (Aggregate("n_wk", "n_k", 0),)

HDP_RULES = (
    Rule("nonneg", "n_wk"),
    Rule("nonneg", "m_dk"),
    Rule("pos_link", "m_dk", "n_dk"),   # n_dk>0 => m_dk>=1 ; n_dk=0 => m_dk=0
    Rule("le", "m_dk", "n_dk"),         # tables <= customers
)
HDP_AGGREGATES = (Aggregate("n_wk", "n_k", 0),)
