"""Metropolis-Hastings-Walker chain over the token-sorted stream (port of
the sorted half of ``repro.core.mhw``).

:func:`sorted_chain` is the plain PyTorch version of the sweep kernel
(``kernels/mhw_fused.py``).  Given the same uniforms it runs the same
chain: own-count removal, the language-model row, the sparse weights and
their cumulative sum, then ``mh_steps`` of alias draw, inverse-CDF sparse
draw, mixture pick and the eq. 7 accept.  Rows ≥ V are padding and keep
their initial state.

Unlike the reference oracle, :func:`sorted_chain` takes the (D, K) ``n_dk``
matrix and the per-token ``docs`` vector and gathers each token's document
row itself, as the kernel does; pass ``docs = arange(B)`` and a (B, K)
matrix to feed it pre-gathered rows.
"""

from __future__ import annotations

import torch

_EPS = 1e-30


def _gather_k(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mat (B, E), idx (B,) → (B,) mat[b, idx[b]]."""
    return torch.gather(mat, 1, idx.long()[:, None])[:, 0]


def sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Cumulative sum along the last axis of (B, E) ``x``, accumulated left
    to right in float32: the order of the reference's cumsum on the CPU
    at small E, and the order the sweep kernel keeps within each lane's
    block."""
    out = torch.empty_like(x)
    acc = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for e in range(x.shape[1]):
        acc = acc + x[:, e]
        out[:, e] = acc
    return out


def accept_log_ratio(log_p_cand, log_p_cur, log_q_cur, log_q_cand):
    """Paper eq. 7 in log space: log [p(j) q(i)] − log [p(i) q(j)]."""
    return log_p_cand - log_p_cur + log_q_cur - log_q_cand


def doc_sparse_logp(doc: torch.Tensor, prior: torch.Tensor,
                    outcome: torch.Tensor) -> torch.Tensor:
    """log(doc_e + prior_e) at ``outcome``: doc (B, E), prior (E,)."""
    return torch.log(_gather_k(doc, outcome) + prior[outcome.long()] + _EPS)


def mix_chain(z0, *, doc, prior, logf, sparse_w, stale_rows, prob_rows,
              alias_rows, dense_mass, slot, coin, u_mix, u_sparse, u_acc):
    """The whole-stream MH chain over E outcomes, given uniforms.

    Target p(e) ∝ (doc_e + prior_e)·f_e with log f given as ``logf``;
    proposal q(e) ∝ sparse_w_e + stale_e.  (B, E) per-token rows, (S, B)
    uniforms; returns (B,) int32.
    """
    e_outcomes = doc.shape[-1]
    cdf = sequential_cumsum(sparse_w)
    sparse_mass = cdf[:, -1]

    def log_p(t):
        return doc_sparse_logp(doc, prior, t) + _gather_k(logf, t)

    def log_q(t):
        return torch.log(_gather_k(sparse_w, t) + _gather_k(stale_rows, t)
                         + _EPS)

    z = z0.long()
    lp_z, lq_z = log_p(z), log_q(z)
    for s in range(slot.shape[0]):
        slot_s = slot[s].long()
        dense_draw = torch.where(coin[s] < _gather_k(prob_rows, slot_s),
                                 slot_s, _gather_k(alias_rows, slot_s).long())
        target = u_sparse[s] * sparse_mass
        sparse_draw = (cdf <= target[:, None]).sum(-1).clamp(
            0, e_outcomes - 1)
        pick_sparse = u_mix[s] * (sparse_mass + dense_mass) < sparse_mass
        cand = torch.where(pick_sparse, sparse_draw, dense_draw)
        lp_c, lq_c = log_p(cand), log_q(cand)
        accept = (torch.log(u_acc[s] + _EPS)
                  < accept_log_ratio(lp_c, lp_z, lq_z, lq_c))
        z = torch.where(accept, cand, z)
        lp_z = torch.where(accept, lp_c, lp_z)
        lq_z = torch.where(accept, lq_c, lq_z)
    return z.to(torch.int32)


def sorted_chain(prob, alias, mass, stale, n_wk, n_k, prior, rows, docs, z0,
                 n_dk, slot, coin, u_mix, u_sparse, u_acc, *, beta: float,
                 beta_bar: float) -> torch.Tensor:
    """Plain version of the sweep kernel for the LM families.

    prob/alias/stale/n_wk: (V, K); mass: (V,); n_k/prior: (K,);
    rows/docs/z0: (B,); n_dk: (D, K) raw document counts (the own-token
    removal happens here); slot/coin/u_mix/u_sparse/u_acc: (S, B).
    Returns (B,) int32.
    """
    v, k_topics = prob.shape
    real = rows < v
    r = rows.clamp(0, v - 1).long()
    own = ((torch.arange(k_topics, device=prob.device)[None, :]
            == z0.long()[:, None]) & real[:, None]).to(torch.float32)
    ndk = n_dk[docs.long()] - own
    lm = (n_wk[r] - own + beta) / (n_k[None, :] - own + beta_bar)
    z = mix_chain(z0, doc=ndk, prior=prior, logf=torch.log(lm + _EPS),
                  sparse_w=ndk * lm, stale_rows=stale[r], prob_rows=prob[r],
                  alias_rows=alias[r], dense_mass=mass[r], slot=slot,
                  coin=coin, u_mix=u_mix, u_sparse=u_sparse, u_acc=u_acc)
    return torch.where(real, z, z0).to(torch.int32)
