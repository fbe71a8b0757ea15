"""The sweep kernels' sparse decomposition held to the plain chains.

Kernels 1 (``csrc/mhw_fused.cu``) and 4 (``csrc/pdp_fused.cu``) compute the
plain versions' functions (``core.mhw.sorted_chain``,
``core.pdp.sorted_chain_pdp``) another way:

* the factors of a word (LDA/HDP: the LM row; PDP: f0, f1 and their exps,
  from a per-topic table where m_wk = 0) are formed once per word with no
  own topic, and each token recomputes only its own topic;
* the document's non-zero topics come from the per-document lists
  (``kernels/ref.py::doc_topic_lists_ref``), and a token weighs only
  those, the topics whose factor is not finite (a zero count times inf is
  the plain version's NaN) and its own;
* the cdf sums those weights only, and a draw is #(cdf <= target) over
  all E outcomes, counted from the visited outcomes and the runs of
  zero-weight outcomes behind them.

:func:`sparse_chain` recomputes the chain that way on the CPU (summing
left to right, as the plain version does; the kernels keep their 32 lane
blocks) and must give the plain chain's draws bit for bit on adversarial
layouts, for LDA's and HDP's priors and for PDP with a Stirling table
small enough that factors become inf and weights NaN.  Tolerance: none.

The list build (``csrc/doc_topics.cu``) has a traversal of its own:
:func:`replay_doc_lists` runs it in numpy (a warp's 32 lanes, four topics
a lane a pass, eight passes a batch; four ballots a pass; count slots in
the batch's stage from the popcounts under the lane mask, the stage
copied out after the batch at the running total; words interleaved from
the ballots' bytes; the pad word in the last batch's free lane) and must
equal the plain build bit for bit, counts up to each k_d, and write
nothing past it.

On the card (``cuda`` marker): the kernels on the same layouts against
the plain chains, at most 1% of chains apart (the block-parallel cdf
rounds otherwise than the left-to-right sum near a step), and the list
kernel against its plain version, exactly, on both of its load routes.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import alias, mhw, pdp, stirling
from repro_torch.kernels import _build, ref

BETA = 0.01
HYPER = dict(b=10.0, a=0.1, gamma=0.5)
LAYOUTS = ["mixed", "single_topic_doc", "own_count_one", "padding_inside",
           "one_word", "singletons"]


# ------------------------------------------------------------------ cases
def _layout(kind: str, rng, k: int, n_docs: int = 12):
    """(v, per-token words, docs, topics) of a chunk, in sorted order, with
    rows ≥ v as padding; past one kernel tile (128 positions for kernel 1,
    256 for kernel 4), ``padding_inside`` also pads the two positions
    around every multiple of 128."""
    per_doc = 8
    v = 256 if kind == "singletons" else 40
    b = n_docs * per_doc
    docs = np.repeat(np.arange(n_docs), per_doc)
    if kind == "singletons":
        words = rng.permutation(v)[:b]
    elif kind == "one_word":
        words = np.full(b, 7)
    else:
        words = np.minimum(rng.zipf(1.6, size=b) - 1, v - 1)
    z = rng.integers(0, k, size=b)
    if kind == "single_topic_doc":
        z[docs == 0] = 5
    if kind == "own_count_one":
        for d in range(n_docs):
            z[docs == d] = rng.permutation(k)[:per_doc]
    order = np.argsort(words, kind="stable")
    words, docs, z = words[order], docs[order], z[order]
    if kind == "padding_inside":
        pad = rng.random(b) < 0.15
        pad[127::128] = pad[128::128] = True
        words = np.where(pad, v, words)
    return v, words.astype(np.int32), docs.astype(np.int32), z


def _doc_counts(docs, z, real, n_docs, k, rng, extra: bool, dense: bool):
    n_dk = np.zeros((n_docs, k), np.float32)
    np.add.at(n_dk, (docs[real], z[real]), 1.0)
    if dense:                          # every topic in every document
        n_dk += 1.0
    elif extra:                          # the document's other chunks
        more = rng.integers(0, 3, size=(n_docs, k)) * (
            rng.random((n_docs, k)) < 0.15)
        more[0] = 0
        n_dk += more.astype(np.float32)
    return n_dk


def _uniforms(rng, e_out, steps, b):
    return (torch.as_tensor(rng.integers(0, e_out, size=(steps, b)),
                            dtype=torch.int32),
            *(torch.as_tensor(rng.random((steps, b)), dtype=torch.float32)
              for _ in range(4)))


def lm_case(kind: str, prior_kind: str, seed: int = 0, k: int = 16,
            dense: bool = False, n_docs: int = 12):
    """Arguments of ``mhw.sorted_chain`` for one layout of ``n_docs``
    documents of 8 tokens, and its keywords; ``dense`` gives every document
    every topic."""
    rng = np.random.default_rng(seed + 17 * LAYOUTS.index(kind))
    steps = 3
    v, rows, docs, z = _layout(kind, rng, k, n_docs)
    real = rows < v
    n_dk = _doc_counts(docs, z, real, n_docs, k, rng,
                       extra=kind != "single_topic_doc", dense=dense)
    n_wk = rng.poisson(0.7, size=(v, k)).astype(np.float32)
    np.add.at(n_wk, (rows[real], z[real]), 1.0)
    n_k = n_wk.sum(0)
    beta_bar = BETA * v
    if prior_kind == "lda":
        prior = np.full(k, 0.1, np.float32)
    else:
        prior = (2.0 * rng.dirichlet(np.full(k, 0.3))).astype(np.float32)
    stale = torch.as_tensor(prior)[None, :] * (
        (torch.as_tensor(n_wk) + BETA) / (torch.as_tensor(n_k)[None, :]
                                         + beta_bar))
    tabs = alias.build(stale)
    args = (tabs.prob, tabs.alias, tabs.mass, stale, torch.as_tensor(n_wk),
            torch.as_tensor(n_k), torch.as_tensor(prior),
            torch.as_tensor(rows), torch.as_tensor(docs),
            torch.as_tensor(z, dtype=torch.int32), torch.as_tensor(n_dk),
            *_uniforms(rng, k, steps, rows.shape[0]))
    return args, dict(beta=BETA, beta_bar=beta_bar)


def pdp_case(kind: str, n_max: int, seed: int = 0, k: int = 16,
             dense: bool = False, n_docs: int = 12):
    """Arguments of ``pdp.sorted_chain_pdp`` for one layout (consistent
    m/s counts with the CRP repair), and its keywords."""
    rng = np.random.default_rng(seed + 31 * LAYOUTS.index(kind))
    steps = 3
    v, rows, docs, z = _layout(kind, rng, k, n_docs)
    real = rows < v
    r = (rng.random(rows.shape[0]) < 0.5).astype(np.int64)
    n_dk = _doc_counts(docs, z, real, n_docs, k, rng,
                       extra=kind != "single_topic_doc", dense=dense)
    m = np.floor(rng.gamma(0.3, size=(v, k)) * 12).astype(np.float32)
    s = np.floor(m * rng.uniform(0.1, 0.9, size=(v, k)))
    np.add.at(m, (rows[real], z[real]), 1.0)
    np.add.at(s, (rows[real], z[real]), r[real].astype(np.float32))
    s = np.minimum(np.where(m > 0, np.maximum(s, 1.0), 0.0), m)
    m_t, s_t = torch.as_tensor(m), torch.as_tensor(s, dtype=torch.float32)
    cfg = pdp.PDPConfig(n_topics=k, vocab_size=v, stirling_n_max=n_max,
                        concentration=HYPER["b"], discount=HYPER["a"],
                        gamma=HYPER["gamma"])
    shared = pdp.SharedStats(m_wk=m_t, s_wk=s_t, m_k=m_t.sum(0),
                             s_k=s_t.sum(0))
    dp = pdp.dense_probs(cfg, shared)
    tabs = alias.build(torch.nan_to_num(dp, nan=0.0, posinf=1e30))
    stirl = stirling.as_tensor(n_max, cfg.discount, "cpu")
    prior = torch.full((2 * k,), cfg.alpha)
    e0 = torch.as_tensor(z + k * r, dtype=torch.int32)
    args = (tabs.prob, tabs.alias, tabs.mass, dp, *shared, stirl, prior,
            torch.as_tensor(rows), torch.as_tensor(docs), e0,
            torch.as_tensor(n_dk), *_uniforms(rng, 2 * k, steps,
                                              rows.shape[0]))
    return args, dict(HYPER, gamma_bar=cfg.gamma * v)


# ------------------------------------------- the kernels' decomposition
def _doc_lists(n_dk: torch.Tensor):
    """Per document: its non-zero topics in order and their counts, read
    back from the plain list build as the kernels read it."""
    words, counts = ref.doc_topic_lists_ref(n_dk)
    k = n_dk.shape[1]
    lists = []
    for d in range(n_dk.shape[0]):
        topics, vals = [], []
        for t in range(k):
            bits = int(words[d, t // 32, 0]) & 0xffffffff
            if (bits >> (t % 32)) & 1:
                below = bin(bits & ((1 << (t % 32)) - 1)).count("1")
                c = int(counts[d, int(words[d, t // 32, 1]) + below]) & 0xffff
                vals.append(np.float32(n_dk[d, t]) if c == 0xffff
                            else np.float32(c))
                topics.append(t)
        lists.append(dict(zip(topics, vals)))
    return lists


def _draw(visited: list[int], cdf: list[np.float32], e_out: int,
          target: np.float32) -> int:
    """#(cdf <= target) over all E outcomes from the visited ones: the
    outcomes before the first visited one have cdf 0, those after a
    visited one its cdf.  Also held equal to the first outcome whose cdf
    is not <= target (else E), the search the weights' signs allow."""
    ends = visited[1:] + [e_out]
    cnt = (visited[0] if visited else e_out) if np.float32(0) <= target else 0
    for e, nxt, c in zip(visited, ends, cdf):
        if c <= target:
            cnt += nxt - e
    first = next((e for e, c in zip(visited, cdf) if not c <= target), e_out)
    if not np.float32(0) <= target:
        first = 0
    assert min(cnt, e_out - 1) == min(first, e_out - 1)
    return min(max(cnt, 0), e_out - 1)


def sparse_chain(family: str, args, kw) -> torch.Tensor:
    """The sorted chain recomputed the kernels' way (see the module note)."""
    if family == "lm":
        (prob, alias_t, mass, stale, n_wk, n_k, prior, rows, docs, z0, n_dk,
         slot, coin, u_mix, u_sparse, u_acc) = args
        v, k = n_wk.shape
        e_out = k
    else:
        (prob, alias_t, mass, stale, m_wk, s_wk, m_k, s_k, stirl, prior,
         rows, docs, z0, n_dk, slot, coin, u_mix, u_sparse, u_acc) = args
        v, k = m_wk.shape
        e_out = 2 * k
        zeros = torch.zeros(k)
        tz = torch.cat(pdp.log_factors(stirl, *pdp.corrected_rows(
            zeros, zeros, zeros, zeros), m_k, s_k, **kw))
    real = rows < v
    lists = _doc_lists(n_dk)

    def word_factors(w):
        """(log factors, factors) of word w with no own topic, E wide."""
        if family == "lm":
            lm = (n_wk[w] - 0.0 + kw["beta"]) / (n_k - 0.0 + kw["beta_bar"])
            return torch.log(lm + 1e-30), lm
        m_row, s_row = pdp.corrected_rows(m_wk[w], s_wk[w], zeros, zeros)
        f = torch.cat(pdp.log_factors(stirl, m_row, s_row, m_k, s_k, **kw))
        f = torch.where(torch.cat([m_wk[w], m_wk[w]]) == 0, tz, f)
        return f, torch.exp(f)

    def own_factors(w, e):
        """The token's own topic's (log factor, factor) per outcome, by the
        plain function on a row with the token removed."""
        if family == "lm":
            own = torch.zeros(k)
            own[e] = 1.0
            lm = (n_wk[w] - own + kw["beta"]) / (n_k - own + kw["beta_bar"])
            return {e: (torch.log(lm + 1e-30)[e], lm[e])}
        own_t, own_r = pdp.own_contrib(k, torch.tensor([e]),
                                       torch.tensor([True]))
        m_row, s_row = pdp.corrected_rows(m_wk[w][None], s_wk[w][None],
                                          own_t, own_r)
        f = torch.cat(pdp.log_factors(stirl, m_row, s_row, m_k - own_t[0],
                                      s_k - own_r[0], **kw), -1)[0]
        t = e % k
        return {t: (f[t], torch.exp(f)[t]), t + k: (f[t + k],
                                                   torch.exp(f)[t + k])}

    b_total = rows.shape[0]
    logf = torch.zeros((b_total, e_out))
    fac = torch.zeros((b_total, e_out))
    sparse_w = torch.zeros((b_total, e_out))
    mass_s = torch.zeros(b_total)
    draws = torch.zeros(slot.shape, dtype=torch.int64)
    cache = {}
    for b in range(b_total):
        if not real[b]:
            continue
        w, e_init = int(rows[b]), int(z0[b])
        if w not in cache:
            cache[w] = word_factors(w)
        f_row, x_row = (c.clone() for c in cache[w])
        for e, (f, x) in own_factors(w, e_init).items():
            f_row[e], x_row[e] = f, x
        logf[b], fac[b] = f_row, x_row
        own_topic = e_init % k
        doc = lists[int(docs[b])]
        visited, cdf, acc = [], [], np.float32(0)
        bad = ~torch.isfinite(cache[w][1])
        for e in range(e_out):
            t = e % k
            if not (t in doc or bool(bad[e]) or t == own_topic):
                continue
            with np.errstate(invalid="ignore"):     # 0 * inf is NaN
                w_e = (np.float32(doc.get(t, 0.0))
                       - np.float32(t == own_topic)) * np.float32(x_row[e])
            sparse_w[b, e] = float(w_e)
            acc = np.float32(acc + w_e)
            visited.append(e)
            cdf.append(acc)
        mass_s[b] = float(acc)
        for s in range(slot.shape[0]):
            draws[s, b] = _draw(visited, cdf, e_out,
                                np.float32(u_sparse[s, b]) * acc)

    # The chain's point values and accept, as the kernels read them.
    rr = rows.clamp(0, v - 1).long()
    kr = torch.arange(b_total)
    own_t = (torch.arange(k)[None, :] == (z0.long() % k)[:, None]) \
        & real[:, None]
    ndk = n_dk[docs.long()] - own_t.float()

    def point(e):
        d = ndk[kr, e % k]
        lp = torch.log(d + prior[e] + 1e-30) + logf[kr, e]
        lq = torch.log(d * fac[kr, e] + stale[rr, e] + 1e-30)
        return lp, lq

    z = z0.long()
    lp_z, lq_z = point(z)
    for s in range(slot.shape[0]):
        sl = slot[s].long()
        dense = torch.where(coin[s] < prob[rr, sl], sl, alias_t[rr, sl].long())
        pick = u_mix[s] * (mass_s + mass[rr]) < mass_s
        cand = torch.where(pick, draws[s], dense)
        lp_c, lq_c = point(cand)
        acc = (torch.log(u_acc[s] + 1e-30)
               < mhw.accept_log_ratio(lp_c, lp_z, lq_z, lq_c))
        z = torch.where(acc, cand, z)
        lp_z = torch.where(acc, lp_c, lp_z)
        lq_z = torch.where(acc, lq_c, lq_z)
    return torch.where(real, z.to(torch.int32), z0)


# ------------------------------------------------------------- CPU tests
@pytest.mark.parametrize("prior_kind", ["lda", "hdp"])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_lm_sparse_decomposition_matches_plain_chain(kind, prior_kind):
    args, kw = lm_case(kind, prior_kind)
    want = mhw.sorted_chain(*args, **kw)
    got = sparse_chain("lm", args, kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert bool((want != args[9]).any())          # the chains moved


@pytest.mark.parametrize("n_max", [64, 3])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_pdp_sparse_decomposition_matches_plain_chain(kind, n_max):
    args, kw = pdp_case(kind, n_max)
    want = pdp.sorted_chain_pdp(*args, **kw)
    got = sparse_chain("pdp", args, kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_small_stirling_table_makes_plain_weights_nan():
    """The case the kernels' flags exist for: with n_max = 3 the clamps
    reach the table's −1e30 entries, f0 = +1e30, and a zero document
    count times exp(f0) = inf is NaN in the plain weights."""
    args, kw = pdp_case("mixed", 3)
    m_wk, s_wk, m_k, s_k, stirl = args[4:9]
    v, k = m_wk.shape
    rows = args[10]
    w = rows[rows < v].long()
    zeros = torch.zeros_like(m_wk[w])
    f0, f1 = pdp.log_factors(stirl, *pdp.corrected_rows(
        m_wk[w], s_wk[w], zeros, zeros), m_k[None], s_k[None], **kw)
    x = torch.exp(torch.cat([f0, f1], -1))
    assert bool(torch.isinf(x).any())
    ndk = args[13][args[11].long()][rows < v]
    w_plain = torch.cat([ndk, ndk], -1) * x
    assert bool(torch.isnan(w_plain).any())


def test_plain_doc_lists_hold_n_dk():
    """Bits, prefix counts and u16 counts of the plain list build against
    n_dk, with values the u16 cannot hold (fractions, negatives, NaN, inf,
    65535 and above) sent to n_dk by 0xffff, and K not a multiple of 32."""
    rng = np.random.default_rng(3)
    d, k = 9, 70
    n_dk = (rng.integers(0, 4, size=(d, k))
            * (rng.random((d, k)) < 0.3)).astype(np.float32)
    n_dk[0] = 0.0
    n_dk[1, :] = 1.0
    n_dk[2, [0, 31, 32, 63, 64, 69]] = [0.5, -2.0, np.nan, np.inf,
                                       65535.0, 65534.0]
    n_dk[3, 5] = -0.0
    words, counts = ref.doc_topic_lists_ref(torch.as_tensor(n_dk))
    assert words.shape == (d, ref.doc_words(k), 2) and counts.shape == (d, k)
    assert words.dtype == torch.int32 and counts.dtype == torch.int16
    for i in range(d):
        nz = np.flatnonzero(n_dk[i] != 0)
        bits = 0
        for j in range(ref.doc_words(k)):
            bits |= (int(words[i, j, 0]) & 0xffffffff) << (32 * j)
            assert int(words[i, j, 1]) == int((nz < 32 * j).sum())
        assert bits == sum(1 << int(t) for t in nz)
        for q, t in enumerate(nz):
            x = n_dk[i, t]
            want = (int(x) if x >= 0 and x < 65535 and x == np.trunc(x)
                    else 0xffff)
            assert int(counts[i, q]) & 0xffff == want
        assert not counts[i, nz.size:].any()
    assert int(words[0, -1, 1]) == 0 and int(words[1, -1, 1]) == k
    assert int(words[3, -1, 1]) == int((n_dk[3] != 0).sum())


def adversarial_n_dk(d: int, k: int, seed: int) -> np.ndarray:
    """(d, k) float32 counts: by row, all zeros; all non-zero; the values
    the u16 cannot hold (fractions, negatives, NaN, inf, 65535 and above)
    beside 65534 and −0.0, at topics on and off the 32-word edges; then
    sparse random counts, some large."""
    rng = np.random.default_rng(seed)
    n_dk = (rng.integers(0, 4, size=(d, k))
            * (rng.random((d, k)) < 0.2)).astype(np.float32)
    if d > 0:
        n_dk[0] = 0.0
    if d > 1:
        n_dk[1] = 1.0
    if d > 2:
        odd = [0.5, -2.0, np.nan, np.inf, 65535.0, 65534.0, 70000.0, -0.0,
               -np.inf, 1e9]
        at = [0, 31, 32, 63, 64, 69, 127, 128, 1023, 1024]
        for t, x in zip(at, odd):
            n_dk[2, t % k] = x
    if d > 3:
        big = rng.random((d - 3, k)) < 0.05
        n_dk[3:][big] = rng.integers(65530, 65540, size=int(big.sum()))
    return n_dk


def _spread4(x: int) -> int:
    """Bits 0..7 of x to bits 0, 4, ..., 28 (the kernel's spread4)."""
    x &= 0xff
    x = (x | (x << 12)) & 0x000f000f
    x = (x | (x << 6)) & 0x03030303
    return (x | (x << 3)) & 0x11111111


def _encode(x: np.float32) -> int:
    ok = x >= 0 and x < 65535 and x == np.trunc(x)
    return int(x) if ok else 0xffff


GARBAGE = 0x5a5a


def replay_doc_lists(n_dk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """doc_topics_kernel's traversal, warp by warp, in numpy: words (D, W,
    2) int64 of u32 bits and prefixes, counts (D, K) with GARBAGE where the
    kernel writes nothing."""
    d_total, k = n_dk.shape
    n_words = ref.doc_words(k)
    words = np.full((d_total, n_words, 2), -1, np.int64)
    counts = np.full((d_total, k), GARBAGE, np.int64)
    lanes = np.arange(32)
    below = (1 << lanes) - 1
    g8 = 8 * (lanes & 3)
    for d in range(d_total):
        pre = 0
        for base in range(0, k, 1024):
            pre0 = pre
            stage = np.full(1024, -1, np.int64)   # the warp's shared stage
            wbits = np.zeros(32, np.int64)
            wpre = np.zeros(32, np.int64)
            for c in range(8):
                t = base + 128 * c + 4 * lanes[:, None] + np.arange(4)
                x = np.where(t < k, n_dk[d, np.minimum(t, k - 1)],
                             np.float32(0))
                nz = x != 0                               # (lane, element)
                ballots = [int((nz[:, e] << lanes).sum()) for e in range(4)]
                slot = pre - pre0 + sum(
                    np.vectorize(lambda m: bin(m).count("1"))(bal & below)
                    for bal in ballots)
                for lane in range(32):
                    s = int(slot[lane])
                    for e in range(4):
                        if nz[lane, e]:
                            stage[s] = _encode(x[lane, e])
                            s += 1
                    if lane >> 2 == c:
                        sh = int(g8[lane])
                        wbits[lane] = sum(_spread4(bal >> sh) << e
                                          for e, bal in enumerate(ballots))
                        wpre[lane] = pre + sum(
                            bin(bal & ((1 << sh) - 1)).count("1")
                            for bal in ballots)
                pre += sum(bin(bal).count("1") for bal in ballots)
            assert (stage[:pre - pre0] >= 0).all()   # every staged slot set
            counts[d, pre0:pre] = stage[:pre - pre0]
            batch_words = min(32, (k - base + 31) // 32)
            for lane in range(32):
                if lane < batch_words:
                    words[d, base // 32 + lane] = wbits[lane], wpre[lane]
                elif lane == batch_words:
                    words[d, n_words - 1] = 0, pre
        if (n_words - 1) % 32 == 0:
            words[d, n_words - 1] = 0, pre
    return words, counts


@pytest.mark.parametrize("k", [1, 31, 32, 33, 70, 127, 128, 1023, 1024,
                               1025])
def test_doc_list_traversal_matches_plain(k):
    """The kernel's traversal gives the plain build's words bit for bit and
    its counts up to each document's k_d, and writes no count past k_d,
    on all-zero, all-non-zero and adversarial rows."""
    n_dk = adversarial_n_dk(5, k, seed=k)
    words, counts = replay_doc_lists(n_dk)
    want_w, want_c = ref.doc_topic_lists_ref(torch.as_tensor(n_dk))
    want_w = want_w.numpy().astype(np.int64)
    want_w[..., 0] &= 0xffffffff
    np.testing.assert_array_equal(words, want_w)
    k_d = want_w[:, -1, 1]
    valid = np.arange(k)[None, :] < k_d[:, None]
    want_c = want_c.numpy().astype(np.int64) & 0xffff
    np.testing.assert_array_equal(counts[valid], want_c[valid])
    assert (counts[~valid] == GARBAGE).all()
    assert k_d[0] == 0 and k_d[1] == k


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _on(args, dev):
    return tuple(a.to(dev) for a in args)


@pytest.mark.cuda
@pytest.mark.parametrize("prior_kind", ["lda", "hdp"])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_lm_kernel_on_adversarial_layouts(kind, prior_kind, cuda_device):
    from repro_torch.kernels import mhw_fused
    args, kw = lm_case(kind, prior_kind)
    want = mhw.sorted_chain(*args, **kw)
    _build.reset_launches()
    got = mhw_fused.mhw_sweep_fused(*_on(args, cuda_device), **kw).cpu()
    assert _build.LAUNCHES["mhw_sweep_fused"] == 1
    assert _build.LAUNCHES["doc_topic_lists"] == 1
    assert float((got != want).float().mean()) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("n_max", [64, 3])
@pytest.mark.parametrize("kind", LAYOUTS)
def test_pdp_kernel_on_adversarial_layouts(kind, n_max, cuda_device):
    from repro_torch.kernels import mhw_fused
    args, kw = pdp_case(kind, n_max)
    want = pdp.sorted_chain_pdp(*args, **kw)
    _build.reset_launches()
    got = mhw_fused.pdp_sweep_fused(*_on(args, cuda_device), **kw).cpu()
    assert _build.LAUNCHES["pdp_sweep_fused"] == 1
    assert _build.LAUNCHES["doc_topic_lists"] == 1
    assert float((got != want).float().mean()) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["lda", "hdp", "pdp"])
def test_kernels_with_more_visited_topics_than_the_warp_keeps(family,
                                                               cuda_device):
    """Documents holding every topic at K = 1024 (E = 1024 for PDP at
    K = 512): each token visits more outcomes than the warp keeps
    (``kCap`` = 512 in csrc/sweep_common.cuh), so the kernels walk them
    again at each draw; the chains still agree with plain as above."""
    from repro_torch.kernels import mhw_fused
    if family == "pdp":
        args, kw = pdp_case("mixed", 64, k=512, dense=True)
        want = pdp.sorted_chain_pdp(*args, **kw)
        fn = mhw_fused.pdp_sweep_fused
    else:
        args, kw = lm_case("mixed", family, k=1024, dense=True)
        want = mhw.sorted_chain(*args, **kw)
        fn = mhw_fused.mhw_sweep_fused
    got = fn(*_on(args, cuda_device), **kw).cpu()
    assert float((got != want).float().mean()) <= 0.01
    assert bool((got != args[9 if family != "pdp" else 12]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["one_word", "padding_inside", "mixed"])
@pytest.mark.parametrize("family", ["lda", "hdp", "pdp"])
def test_kernels_on_runs_across_tiles(family, kind, cuda_device):
    """640 positions (80 documents): a word's run crosses the kernels'
    tiles (five of 128 positions for kernel 1, three blocks of 256 for
    kernel 4), so a tile starts inside a run and rebuilds its factors,
    and with ``padding_inside`` a padding segment sits at every tile
    boundary; the chains agree with plain as above."""
    from repro_torch.kernels import mhw_fused
    if family == "pdp":
        args, kw = pdp_case(kind, 64, n_docs=80)
        want = pdp.sorted_chain_pdp(*args, **kw)
        fn, rows, e0 = mhw_fused.pdp_sweep_fused, args[10], args[12]
    else:
        args, kw = lm_case(kind, family, n_docs=80)
        want = mhw.sorted_chain(*args, **kw)
        fn, rows, e0 = mhw_fused.mhw_sweep_fused, args[7], args[9]
    real = (rows < args[4].shape[0]).numpy()
    assert rows.shape[0] == 640
    if kind == "padding_inside":
        assert not real[[127, 128, 255, 256, 383, 384]].any()
    else:                   # the first word's run crosses 128 and 256
        assert real.all() and bool((rows[:257] == rows[0]).all())
    got = fn(*_on(args, cuda_device), **kw).cpu()
    assert float((got != want).float().mean()) <= 0.01
    assert bool((got != e0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("d,k", [(9, 70), (300, 1024), (0, 1024), (1, 1),
                                 (33, 1023), (64, 1025), (16, 4096)])
def test_doc_list_kernel_matches_plain(d, k, offset, cuda_device):
    """Both load routes: 16-byte loads where K % 4 == 0 and n_dk starts on
    a 16-byte boundary; scalar loads where K % 4 != 0 or n_dk is a view
    one float in (``offset``).  No document, no launch."""
    from repro_torch.kernels import doc_topics
    n_dk = torch.as_tensor(adversarial_n_dk(d, k, seed=k))
    want_w, want_c = ref.doc_topic_lists_ref(n_dk)
    on_card = torch.empty(d * k + offset, device=cuda_device)
    on_card = on_card[offset:].view(d, k)
    on_card.copy_(n_dk)
    _build.reset_launches()
    words, counts = doc_topics.doc_topic_lists(on_card)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["doc_topic_lists"] == (1 if d else 0)
    assert words.shape == want_w.shape and counts.shape == want_c.shape
    assert torch.equal(words.cpu(), want_w)
    k_d = want_w[:, -1, 1].long()
    valid = torch.arange(k)[None, :] < k_d[:, None]
    assert torch.equal(counts.cpu()[valid], want_c[valid])
