"""Plain PyTorch versions of kernels 3, 6, 7, 8 and 9 (port of part of
``repro.kernels.ref``), and of the document-list build that the sweep
kernels 1 and 4 run first (``csrc/doc_topics.cu``).

The plain versions of kernels 1, 2, 4 and 5 are ``core.mhw.sorted_chain``,
``core.alias.build`` and ``core.pdp.sorted_chain_pdp``; this module holds
only what computes something of its own.  The CPU paths of the ``ops``
wrappers run it, and ``chip_smoke.py`` compares the kernels with it on the
card.  Nothing calls it when a card is present.
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


def fused_dense_ref(n_wk, n_k, *, alpha: float, beta: float,
                    vocab_size: int) -> torch.Tensor:
    """α·(n_wk+β)/(n_k+β̄) with the product taken first, the grouping of
    the fused build (kernel 6); not ``lda.dense_probs``'s
    α·((n_wk+β)/(n_k+β̄)), so the two differ in the last place."""
    return alpha * (n_wk + beta) / (n_k[None, :] + beta * vocab_size)


def alias_build_fused_ref(n_wk, n_k, *, alpha: float, beta: float,
                          vocab_size: int):
    """(prob, alias, mass) of the fused dense term: plain version of
    kernel 6."""
    t = alias_mod.build(fused_dense_ref(n_wk, n_k, alpha=alpha, beta=beta,
                                        vocab_size=vocab_size))
    return t.prob, t.alias, t.mass


def alias_sample_ref(prob, alias, rows, slot, coin) -> torch.Tensor:
    """Alias draws with given uniforms: ``slot`` if ``coin < prob[row,
    slot]``, else ``alias[row, slot]``; 0 for rows outside [0, V) (the
    padding sentinels).  Plain version of kernels 7 and 8."""
    v = prob.shape[0]
    inside = (rows >= 0) & (rows < v)
    r = torch.where(inside, rows, 0).long()
    s = slot.long()
    draw = torch.where(coin < prob[r, s], slot, alias[r, s])
    return torch.where(inside, draw, 0).to(torch.int32)


# The sorted stream's draws are the same function; its tile window only
# skipped work on the TPU.
alias_sample_sorted_ref = alias_sample_ref


def mh_accept_ref(z, cand, log_p_z, log_p_cand, log_q_z, log_q_cand,
                  u) -> torch.Tensor:
    """MH accept step (paper eq. 7) with given uniforms: plain version of
    kernel 9."""
    log_ratio = log_p_cand - log_p_z + log_q_z - log_q_cand
    accept = torch.log(u + 1e-30) < log_ratio
    return torch.where(accept, cand, z).to(torch.int32)


def doc_words(k: int) -> int:
    """Words of a document's topic bitmap: ceil(K/32) and a pad word."""
    return (k + 31) // 32 + 1


def doc_topic_lists_ref(n_dk: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-document lists of the non-zero topics of (D, K) ``n_dk``: plain
    version of ``csrc/doc_topics.cu``.

    Returns ``words`` (D, W, 2) int32 with W = :func:`doc_words`: word j's
    bit i is ``n_dk[d, 32j + i] != 0`` and its second entry the number of
    such topics below 32j (the last word has no bits and holds k_d); and
    ``counts`` (D, K) int16 holding u16 bits: the q-th non-zero count in
    topic order when it is an integer in [0, 65535), else 0xffff.  Entries
    from k_d on are 0 here; the kernel leaves them unwritten."""
    d, k = n_dk.shape
    n_words = doc_words(k)
    dev = n_dk.device
    nz = torch.zeros((d, n_words * 32), dtype=torch.bool, device=dev)
    nz[:, :k] = n_dk != 0
    bit = nz.view(d, n_words, 32).to(torch.int64)
    bits = (bit << torch.arange(32, device=dev)).sum(-1)
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    pop = bit.sum(-1)
    words = torch.stack([bits, torch.cumsum(pop, 1) - pop], -1)
    ok = (n_dk >= 0) & (n_dk < 65535) & (n_dk == torch.trunc(n_dk))
    enc = torch.where(ok, n_dk, 65535.0).to(torch.int64)
    enc = torch.where(enc >= 2**15, enc - 2**16, enc)
    nzk = nz[:, :k]
    counts = torch.zeros((d, k), dtype=torch.int16, device=dev)
    slot = torch.cumsum(nzk.to(torch.int64), 1) - 1
    doc = torch.arange(d, device=dev)[:, None].expand(d, k)
    counts[doc[nzk], slot[nzk]] = enc[nzk].to(torch.int16)
    return words.to(torch.int32), counts
