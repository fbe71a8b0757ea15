"""Parameter projection for constraint-violation resolution (port of
``repro.core.projection``, Algorithm 1 of paper §5.5).

A :class:`Rule` constrains a pair of statistics elementwise; an
:class:`Aggregate` re-derives a sum statistic from its source (the
paper's C2 tuples).  The distributed variant (Algorithm 2) waits for the
mesh round (ROADMAP.md queue A.11).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

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
