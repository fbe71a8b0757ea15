"""Sequence-chunked cross-entropy (port of ``repro.train.loss``).

The (B, S, Vp) logits tensor never materializes at once: the hidden states
are unembedded in sequence chunks and only the (B, chunk) losses of a
chunk are kept.  Padding vocabulary ids (vocab_size..padded_vocab) are
masked to -1e30 so they contribute nothing to the partition function.

Over a mesh (the hooks of ``models/layers.py``) the table is gathered at
use like any weight, and the mean is the global one, Σ nll over Σ mask
across the ranks that hold distinct tokens: under zero_seq the masked
last position lies on the last model rank only, so the mean of the ranks'
means would be another number.
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
    table = layers.gather_param(params[name], layers.param_spec(name))
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
    if layers.token_ranks() > 1:
        cnt = collectives.all_reduce_sum(cnt, layers.token_group(),
                                         "loss mask count")
    return tot / torch.clamp(cnt, min=1.0)
