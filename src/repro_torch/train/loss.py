"""Sequence-chunked cross-entropy (port of ``repro.train.loss``).

The (B, S, Vp) logits tensor never materializes at once: the hidden states
are unembedded in sequence chunks and only the (B, chunk) losses of a
chunk are kept.  Padding vocabulary ids (vocab_size..padded_vocab) are
masked to -1e30 so they contribute nothing to the partition function.

Over a mesh (the hooks of ``models/layers.py``) the mean is the global
one, Σ nll over Σ mask across the ranks that hold distinct tokens: under
zero_seq the masked last position lies on the last model rank only, so the
mean of the ranks' means would be another number.  The zero modes gather
the table at use like any weight.  Under megatron's tensor-parallel layout
the logits stay split by vocabulary over ``model``: a rank holds its
vocabulary range of the table (gathered over ``data`` only), and each
chunk's max, Σ exp and gold logit are reduced over ``model`` (the pad mask
in global vocabulary ids), so every model rank gets the same loss.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives
from repro_torch.models import layers
from repro_torch.models.layers import cast, einsum_f32


def chunked_ce_loss(cfg: ModelConfig, params, hidden: torch.Tensor,
                    targets: torch.Tensor, mask: torch.Tensor, *,
                    chunk: int = 512) -> torch.Tensor:
    """Mean next-token CE over ``mask``.  hidden: (B, S, D) at positions
    predicting targets (B, S).  On a mesh: this rank's Σ nll over the
    global Σ mask, the rank's share of the global mean (the shares of the
    ranks that hold distinct tokens sum to it)."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    table, lo = layers.vocab_table(cfg, params, name)
    if lo is not None:
        tot, cnt = _vocab_parallel_sums(cfg, table, lo, hidden, targets, mask,
                                        chunk)
        return _mean(tot, cnt)
    s = hidden.shape[1]
    chunk = min(chunk, s)
    vocab_ids = torch.arange(cfg.padded_vocab, device=hidden.device)
    pad_mask = vocab_ids >= cfg.vocab_size
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    # Whole chunks, then the remainder, as the reference's scan and tail.
    for c0 in range(0, s, chunk):
        h_c = hidden[:, c0:c0 + chunk]
        t_c = targets[:, c0:c0 + chunk]
        m_c = mask[:, c0:c0 + chunk].float()
        logits = einsum_f32("bsd,vd->bsv", h_c, cast(table))
        logits = torch.where(pad_mask, -1e30, logits)
        lse = torch.logsumexp(logits, dim=-1)
        # Gold logit as a masked reduction over the vocab dim, as the
        # reference takes it.
        gold = torch.where(vocab_ids == t_c[..., None], logits,
                           -torch.inf).amax(-1)
        tot = tot + ((lse - gold) * m_c).sum()
        cnt = cnt + m_c.sum()
    return _mean(tot, cnt)


def _mean(tot: torch.Tensor, cnt: torch.Tensor) -> torch.Tensor:
    if layers.token_ranks() > 1:
        cnt = collectives.all_reduce_sum(cnt, layers.token_group(),
                                         "loss mask count")
    return tot / torch.clamp(cnt, min=1.0)


def _vocab_parallel_sums(cfg: ModelConfig, table: torch.Tensor, lo: int,
                         hidden: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor, chunk: int):
    """(Σ nll, Σ mask) of the rank's tokens with the logits split by
    vocabulary over ``model``: ``table`` the rank's rows from id ``lo``."""
    group = layers.model_group()
    hidden = layers.replicated_in(hidden, "loss in")
    s = hidden.shape[1]
    chunk = min(chunk, s)
    vocab_ids = torch.arange(lo, lo + table.shape[0], device=hidden.device)
    pad_mask = vocab_ids >= cfg.vocab_size
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, chunk):
        h_c = hidden[:, c0:c0 + chunk]
        t_c = targets[:, c0:c0 + chunk]
        m_c = mask[:, c0:c0 + chunk].float()
        logits = einsum_f32("bsd,vd->bsv", h_c, cast(table))
        logits = torch.where(pad_mask, -1e30, logits)
        top = collectives.all_reduce_max(logits.detach().amax(-1), group,
                                         "loss max")
        sums = torch.stack([
            torch.exp(logits - top[..., None]).sum(-1),
            torch.where(vocab_ids == t_c[..., None], logits, 0.0).sum(-1)])
        sums = collectives.all_reduce_value(sums, group, "loss sums")
        lse = torch.log(sums[0]) + top
        tot = tot + ((lse - sums[1]) * m_c).sum()
        cnt = cnt + m_c.sum()
    return tot, cnt
