"""Metropolis-Hastings-Walker sampling (port of ``repro.core.mhw``).

The MHW sampler draws from a slowly changing categorical ``p`` by taking
a stale alias table ``q`` of it as a stationary MH proposal and
correcting with the accept of paper eq. 7.  For topic models the proposal
is the sparse+dense mixture of eq. 4: a document-sparse term drawn exactly
and a corpus-dense term drawn from the stale alias table.

Position-scan layout: :class:`MixtureProposal` and :func:`mh_chain` run
inside each family's scan sweep, one chain per document per position.  On
the card the dense draw is kernel 8 (``ops.sample_rows``) and the accept
kernel 9 (``ops.mh_accept``); on the CPU their plain versions.  The sparse
draw is a Gumbel argmax over the E lanes in PyTorch, as the reference
computes it outside any kernel.  Each MH step consumes one
:class:`StepDraws`, injected or drawn from a generator in the order of its
fields, which is the reference's order of ``split``s within ``mh_chain``.

Token-sorted layout: :func:`sorted_chain` is the plain PyTorch version of
the sweep kernel
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

from typing import Callable, NamedTuple, Sequence

import torch

from repro_torch.core import alias as alias_mod

_EPS = 1e-30
_TINY = torch.finfo(torch.float32).tiny


def _gather_k(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """mat (B, E), idx (B,) → (B,) mat[b, idx[b]]."""
    return torch.gather(mat, 1, idx.long()[:, None])[:, 0]


def row_mass(w: torch.Tensor) -> torch.Tensor:
    """Row sums of (B, E) ``w``: left to right on the CPU (the reference's
    order there at E ≤ 16, so the masses agree bit for bit), PyTorch's
    reduction on the card (E launches of a column loop would cost more
    than the sweep; the sum then differs in the last place)."""
    if w.device.type == "cpu":
        return alias_mod.row_sums(w)
    return w.sum(-1)


def gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise −log(−log u), u uniform on [tiny, 1), the form
    of ``jax.random.gumbel``."""
    u = torch.rand(shape, generator=generator, device=device)
    return u.clamp_min_(_TINY).log_().neg_().log_().neg_()


class StepDraws(NamedTuple):
    """The random numbers of one MH step of a scan position, in the
    reference's order: ``split(step key) → (k_prop, k_acc)``, ``k_prop →
    (k_coin, k_sparse, k_dense)``, ``k_dense → (k_slot, k_coin)``."""

    u_mix: torch.Tensor    # (B,) uniform(k_coin): sparse or dense term
    gumbel: torch.Tensor   # (B, E) gumbel(k_sparse): the sparse draw
    slot: torch.Tensor     # (B,) int32 in [0, E): the alias slot
    coin: torch.Tensor     # (B,) the alias coin
    u_acc: torch.Tensor    # (B,) uniform(k_acc): the accept


def draw_step(generator: torch.Generator, b: int, e: int,
              device) -> StepDraws:
    """One step's draws from ``generator``, in the order of the fields."""
    u_mix = torch.rand(b, generator=generator, device=device)
    g = gumbel(generator, (b, e), device)
    slot = torch.randint(0, e, (b,), generator=generator, device=device,
                         dtype=torch.int32)
    coin = torch.rand(b, generator=generator, device=device)
    u_acc = torch.rand(b, generator=generator, device=device)
    return StepDraws(u_mix, g, slot, coin, u_acc)


class MixtureProposal:
    """The paper's sparse+dense proposal for one batch of tokens.

    sparse_weights: (B, E) unnormalised sparse-term weights (zero rows are
    fine: the mixture then always picks the dense term); dense_tables: the
    per-row alias tables (R, E); dense_rows: (B,) row of each token (kept
    as contiguous int32, as kernel 8 reads it).
    The weights' mass and logs are formed once and reused by every step
    (the reference forms them again at each step, to the same values).
    """

    def __init__(self, sparse_weights: torch.Tensor,
                 dense_tables: alias_mod.AliasTable,
                 dense_rows: torch.Tensor):
        self.sparse_weights = sparse_weights
        self.dense_tables = dense_tables
        self.dense_rows = dense_rows.to(torch.int32).contiguous()
        self._mass = self._log_w = None

    def sample(self, draws: StepDraws) -> torch.Tensor:
        """One proposal per token, (B,) int32: the sparse term's Gumbel
        argmax or the dense term's alias draw (kernel 8 on the card), as
        the mixture coin picks."""
        from repro_torch.kernels import ops
        w = self.sparse_weights
        if self._mass is None:
            self._mass = row_mass(w)
            self._log_w = torch.log(w + _EPS)
        dense_mass = self.dense_tables.mass[self.dense_rows.long()]
        pick_sparse = draws.u_mix * (self._mass + dense_mass) < self._mass
        sparse_draw = torch.argmax(self._log_w + draws.gumbel, dim=-1)
        dense_draw = ops.sample_rows(self.dense_tables, self.dense_rows,
                                     uniforms=(draws.slot, draws.coin),
                                     device=w.device)
        return torch.where(pick_sparse, sparse_draw.to(torch.int32),
                           dense_draw)

    def log_q(self, outcome: torch.Tensor,
              dense_probs: torch.Tensor) -> torch.Tensor:
        """Unnormalised log proposal density at ``outcome`` (B,), given the
        stale (R, E) dense term the tables were built from."""
        o = outcome.long()
        sparse_val = _gather_k(self.sparse_weights, o)
        dense_val = dense_probs[self.dense_rows.long(), o]
        return torch.log(sparse_val + dense_val + _EPS)


def _chain(draws, init, proposal: MixtureProposal, dense_probs, log_p,
           n_steps: int, stats: bool):
    from repro_torch.kernels import ops
    b, e = proposal.sparse_weights.shape
    dev = proposal.sparse_weights.device
    z = init.to(torch.int32).contiguous()
    rates = []
    for s in range(n_steps):
        d = (draw_step(draws, b, e, dev)
             if isinstance(draws, torch.Generator) else draws[s])
        cand = proposal.sample(d)
        lp_c, lp_z = log_p(cand), log_p(z)
        lq_z = proposal.log_q(z, dense_probs)
        lq_c = proposal.log_q(cand, dense_probs)
        if stats:
            accept = (torch.log(d.u_acc + _EPS)
                      < accept_log_ratio(lp_c, lp_z, lq_z, lq_c))
            rates.append(_mean(accept.to(torch.float32)))
        z = ops.mh_accept(z, cand, lp_z, lp_c, lq_z, lq_c, u=d.u_acc,
                          device=dev)
    return z, (_mean(torch.stack(rates)) if stats else None)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of a 1-d float32 tensor as the reference's ``jnp.mean`` takes
    it on the CPU: the sum times the float32 reciprocal of the count."""
    return x.sum() * torch.tensor(1.0 / x.numel(), dtype=torch.float32,
                                  device=x.device)


def mh_chain(draws: torch.Generator | Sequence[StepDraws],
             init: torch.Tensor, proposal: MixtureProposal,
             dense_probs: torch.Tensor,
             log_p: Callable[[torch.Tensor], torch.Tensor],
             n_steps: int) -> torch.Tensor:
    """``n_steps`` of stationary-proposal MH for a batch of tokens.

    ``draws``: a generator, from which each step draws its
    :class:`StepDraws`, or one injected ``StepDraws`` per step.  init: (B,)
    current states; log_p maps (B,) outcomes to the (B,) unnormalised log
    target.  Each step recomputes log p and log q of the current state, as
    the reference does, and accepts through kernel 9 on the card.  Returns
    the (B,) int32 final states."""
    return _chain(draws, init, proposal, dense_probs, log_p, n_steps,
                  stats=False)[0]


def mh_chain_with_stats(draws, init, proposal, dense_probs, log_p,
                        n_steps: int):
    """:func:`mh_chain` and the mean acceptance rate over its steps (a 0-d
    float32 tensor); the rate's accept mask is formed in PyTorch beside
    the kernel's."""
    return _chain(draws, init, proposal, dense_probs, log_p, n_steps,
                  stats=True)


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
