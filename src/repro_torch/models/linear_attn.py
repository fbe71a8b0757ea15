"""Chunked linear attention with (data-dependent) decay (port of
``repro.models.linear_attn``).

Shared engine for RWKV-6 (vector decay per key channel, exclusive recurrence
with a current-token bonus ``u``) and Mamba-2 / SSD (scalar decay per head,
inclusive recurrence):

    S_t = diag(w_t) · S_{t-1} + k_t v_tᵀ              (state: K×P per head)
    RWKV-6:  out_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
    Mamba-2: out_t = r_t · S_t

The chunked form processes ``chunk`` tokens a step with dense contractions
(intra-chunk masked attention with decay ratios, inter-chunk state carry),
in f32 throughout.

Numerical stability, as the reference: the intra-chunk term uses the
direct pairwise ratio exp(L_t − L_s), whose exponent is ≤ 0 for every
causal (t, s) pair because the cumulative log decay L is non-increasing,
so it cannot overflow; the pairwise tensor is blocked over the key
dimension (``K_BLOCK``) to bound the transient to (B, C, C, H, K_BLOCK).
A per-step log decay is floored at ``MIN_LOG_W``.

Under zero_seq the sequence is split over the model ranks in contiguous
ranges (``group=``): each rank runs its chunks from a zero state, the
ranks' final states and total decays are scanned over the ranks in
⌈log₂ m⌉ exchanges of one state a rank (``"seq state"``), and each rank
adds the state entering its range to its output (:func:`_carry_in`).  No
rank computes another's positions, and no activation is gathered.

``linear_attention_ref`` is the step-by-step oracle used by tests.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core import collectives

MIN_LOG_W = -60.0   # per-step floor: e^-60 is already an exact-zero carry in f32
K_BLOCK = 32        # key-dim blocking for the pairwise intra-chunk tensor


def _state0(b, h, kd, p, initial_state, device) -> torch.Tensor:
    if initial_state is None:
        return torch.zeros((b, h, kd, p), dtype=torch.float32, device=device)
    return initial_state.float()


def linear_attention_ref(r, k, v, log_w, *, inclusive: bool,
                         u: torch.Tensor | None = None, initial_state=None):
    """Oracle: sequential scan.  r/k: (B,S,H,K), v: (B,S,H,P),
    log_w: (B,S,H,K) or (B,S,H,1).  Returns (out (B,S,H,P), state (B,H,K,P))."""
    b, s, h, kd = k.shape
    p = v.shape[-1]
    log_w = log_w.clamp(MIN_LOG_W, 0.0).expand(b, s, h, kd).float()
    state = _state0(b, h, kd, p, initial_state, k.device)
    outs = []
    for t in range(s):
        r_t, k_t, v_t = r[:, t].float(), k[:, t].float(), v[:, t].float()
        outer = k_t[..., :, None] * v_t[..., None, :]          # (B,H,K,P)
        new_state = torch.exp(log_w[:, t])[..., None] * state + outer
        if inclusive:
            outs.append(torch.einsum("bhk,bhkp->bhp", r_t, new_state))
        else:
            base = state + (u[None, :, :, None] * outer if u is not None
                            else 0.0)
            outs.append(torch.einsum("bhk,bhkp->bhp", r_t, base))
        state = new_state
    return torch.stack(outs, dim=1), state


def linear_attention(r, k, v, log_w, *, chunk: int = 64, inclusive: bool,
                     u: torch.Tensor | None = None, initial_state=None,
                     group=None):
    """Chunked evaluation; same contract as ``linear_attention_ref``.  A
    sequence that ``chunk`` does not divide ends on a shorter chunk (the
    result does not depend on the chunk).

    With ``group`` (zero_seq's model group) the sequence is split over the
    group's ranks in contiguous ranges, in rank order: each rank passes its
    positions (``initial_state`` counts on the first rank alone, as the
    state before the sequence) and gets their output and the state after
    its last position, on the last rank the sequence's final state
    (:func:`_carry_in`)."""
    b, s, h, kd = k.shape
    p = v.shape[-1]
    log_w = log_w.clamp(MIN_LOG_W, 0.0).expand(b, s, h, kd).float()
    split = group is not None and collectives.group_size(group) > 1
    if split and dist.get_rank(group) > 0:
        initial_state = None
    state = _state0(b, h, kd, p, initial_state, k.device)
    out, state = _chunks(r, k, v, log_w, chunk, inclusive, u, state)
    if split:
        return _carry_in(r, log_w, out, state, inclusive, group)
    return out, state


def _chunks(r, k, v, log_w, chunk: int, inclusive: bool, u, state):
    """The chunked recurrence from ``state`` over the clamped, expanded
    ``log_w``: (out (B,S,H,P), the state after the last position)."""
    b, s, h, kd = k.shape
    chunk = max(1, min(chunk, s))
    t_idx = torch.arange(chunk, device=k.device)
    if inclusive:
        full_mask = t_idx[:, None] >= t_idx[None, :]   # s ≤ t
    else:
        full_mask = t_idx[:, None] > t_idx[None, :]    # s < t

    n_kb = max(1, kd // K_BLOCK)
    while kd % n_kb:
        n_kb -= 1
    kb = kd // n_kb

    outs = []
    for c0 in range(0, s, chunk):
        c = min(chunk, s - c0)
        pair_mask = full_mask[:c, :c]
        r_i = r[:, c0:c0 + c].float()                  # (B,C,H,K)
        k_i = k[:, c0:c0 + c].float()
        v_i = v[:, c0:c0 + c].float()                  # (B,C,H,P)
        lw_i = log_w[:, c0:c0 + c]
        lw_cum = torch.cumsum(lw_i, dim=1)             # inclusive cumsum L_t
        lw_tot = lw_cum[:, -1]                         # (B,H,K)

        # Inter-chunk: the carried-in state's contribution.
        l_q = lw_cum if inclusive else lw_cum - lw_i   # ≤ 0 everywhere
        q_tilde = r_i * torch.exp(l_q)
        out = torch.einsum("bchk,bhkp->bchp", q_tilde, state)

        # Intra-chunk, direct pairwise, blocked over the key dim.
        att = torch.zeros((b, h, c, c), dtype=torch.float32, device=k.device)
        for i in range(n_kb):
            sl = slice(i * kb, (i + 1) * kb)
            d = l_q[..., sl][:, :, None] - lw_cum[..., sl][:, None]
            att = att + torch.einsum("bchk,bdhk,bcdhk->bhcd", r_i[..., sl],
                                     k_i[..., sl],
                                     torch.exp(torch.clamp(d, max=0.0)))
        att = torch.where(pair_mask, att, 0.0)
        out = out + torch.einsum("bhcd,bdhp->bchp", att, v_i)

        if not inclusive and u is not None:
            # current-token bonus (RWKV-6 ``u``)
            bonus = torch.einsum("bchk,bchk->bch", r_i * u[None, None], k_i)
            out = out + bonus[..., None] * v_i

        # State carry: S' = diag(exp(L_C)) S + Σ_s exp(L_C - L_s) k_s v_sᵀ
        k_carry = k_i * torch.exp(lw_tot[:, None] - lw_cum)
        state = (torch.exp(lw_tot)[..., None] * state
                 + torch.einsum("bchk,bchp->bhkp", k_carry, v_i))
        outs.append(out)
    return torch.cat(outs, dim=1), state


def _combine(a: tuple, b: tuple) -> tuple:
    """The (log decay, state) of a range ``a`` followed by a range ``b``:
    (T_a + T_b, exp(T_b) ⊙ S_a + S_b); associative, every exponent ≤ 0."""
    return a[0] + b[0], torch.exp(b[0])[..., None] * a[1] + b[1]


def _from_rank_before(pair: tuple, d: int, group) -> tuple:
    """Rank r − d's (log decay, state) on rank r (``"seq state"``: one
    all-to-all, each rank sending to rank r + d alone); the identity (0, 0)
    on the first d ranks, kept in the graph so that every rank calls the
    exchange's backward."""
    m = collectives.group_size(group)
    msg = torch.cat([pair[1], pair[0][..., None]], dim=-1)[None]
    src = (0, collectives.one_each([(q, q + 1) for q in range(m)]))
    dst = (0, [((q - d, q - d + 1),) if q >= d else ((0, 0),)
               for q in range(m)])
    got = collectives.relayout(msg, group, src, dst, "seq state")
    if got.shape[0] == 0:
        got = msg.new_zeros(msg.shape) + got.sum()
    return got[0, ..., -1], got[0, ..., :-1]


def _carry_in(r, log_w, out, state, inclusive: bool, group):
    """The sequence-parallel form's exchange and second pass.  Each rank
    has run its range from a zero state (``out``, its final ``state`` S_r;
    its total log decay T_r).  The state entering rank r is
    S_in_r = Σ_{q<r} exp(Σ_{q<j<r} T_j) ⊙ S_q: an exclusive scan of the
    ranks' (T, S) pairs under :func:`_combine`, run in ⌈log₂ m⌉ steps, step
    d taking rank r − d's inclusive pair (Hillis-Steele), so a rank sends
    one state a step.  Its positions then add r_t ⊙ exp(L_t) · S_in_r, L_t
    the log decay from the rank's first position to t (inclusive for
    Mamba-2, exclusive for RWKV-6).  Returns (out, the state after the
    rank's last position, exp(T_r) ⊙ S_in_r + S_r)."""
    m = collectives.group_size(group)
    l_cum = torch.cumsum(log_w, dim=1)                 # (B,S,H,K)
    mine = (l_cum[:, -1], state)
    incl = mine                                        # ranks (r - d, r]
    excl = (torch.zeros_like(mine[0]), torch.zeros_like(state))  # (r - d, r)
    d = 1
    while d < m:
        got = _from_rank_before(incl, d, group)
        excl, incl = _combine(got, excl), _combine(got, incl)
        d *= 2
    l_q = l_cum if inclusive else l_cum - log_w
    out = out + torch.einsum("bshk,bhkp->bshp", r.float() * torch.exp(l_q),
                             excl[1])
    return out, incl[1]


def linear_attention_step(r_t, k_t, v_t, log_w_t, state, *, inclusive: bool,
                          u: torch.Tensor | None = None):
    """Single decode step.  r_t/k_t: (B,H,K), v_t: (B,H,P), state (B,H,K,P).
    Returns (out (B,H,P), new_state)."""
    lw = log_w_t.clamp(MIN_LOG_W, 0.0).expand(k_t.shape).float()
    outer = k_t[..., :, None] * v_t[..., None, :]
    new_state = torch.exp(lw)[..., None] * state.float() + outer
    if inclusive:
        out = torch.einsum("bhk,bhkp->bhp", r_t, new_state)
    else:
        base = state.float()
        if u is not None:
            base = base + u[None, :, :, None] * outer
        out = torch.einsum("bhk,bhkp->bhp", r_t, base)
    return out, new_state
