"""Synthetic power-law topic corpora and LM token streams (port of
``repro.data.synthetic``).

numpy only.  For equal :class:`CorpusConfig` values the corpus equals the
reference's array for array, and :func:`lm_batches` yields the reference's
batches: the generator draws the same numbers from the same
``default_rng`` in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CorpusConfig:
    n_topics: int = 16
    vocab_size: int = 2048
    n_docs: int = 1024
    doc_len: int = 128          # padded length; actual lengths vary
    theta_conc: float = 0.2     # document Dirichlet
    zipf_a: float = 1.2         # within-topic word-frequency power law
    min_len_frac: float = 0.5
    seed: int = 0


def _np_alias_build(p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vose's two-stack build, giving exactly the reference's tables (its
    pairing order decides every sampled word).

    The reference pops both Python lists from the end: the original smalls
    come off in descending index order, the original larges likewise, a
    large that stays large is popped again next, and a large that turns
    small is the next small.  So two pointers replace the lists; the float
    operations are the reference's.
    """
    k = p.shape[0]
    p = p / p.sum()
    scaled = (p * k).tolist()
    prob = [1.0] * k
    alias = list(range(k))
    smalls = [i for i in range(k) if scaled[i] < 1.0]
    larges = [i for i in range(k) if scaled[i] >= 1.0]
    a, b = len(smalls) - 1, len(larges) - 1
    if a >= 0 and b >= 0:
        i, j = smalls[a], larges[b]
        a, b = a - 1, b - 1
        si, sj = scaled[i], scaled[j]
        while True:
            prob[i] = si
            alias[i] = j
            sj -= 1.0 - si
            if sj < 1.0:            # j is appended to small, popped next
                i, si = j, sj
                if b < 0:
                    break
                j = larges[b]
                b -= 1
                sj = scaled[j]
            else:                   # j is appended to large, popped next
                if a < 0:
                    break
                i = smalls[a]
                a -= 1
                si = scaled[i]
    return np.asarray(prob), np.asarray(alias)


def _np_alias_sample(prob, alias, n, rng):
    slot = rng.integers(0, prob.shape[0], size=n)
    coin = rng.random(n)
    return np.where(coin < prob[slot], slot, alias[slot])


def make_topic_corpus(cfg: CorpusConfig):
    """Returns (tokens (D, L) int32, mask (D, L) bool, true_phi (K, V))."""
    rng = np.random.default_rng(cfg.seed)
    k, v = cfg.n_topics, cfg.vocab_size

    ranks = np.arange(1, v + 1, dtype=np.float64)
    zipf = ranks ** (-cfg.zipf_a)
    phi = np.zeros((k, v))
    for t in range(k):
        perm = rng.permutation(v)
        phi[t, perm] = zipf / zipf.sum()

    tables = [_np_alias_build(phi[t]) for t in range(k)]
    probs = np.stack([tb[0] for tb in tables])
    aliases = np.stack([tb[1] for tb in tables])
    # With V a power of two no bounded-integer draw is ever rejected, so a
    # document's word draws can be taken from one block of raw generator
    # output (see _doc_words); otherwise draw topic by topic as the
    # reference does.
    raw_words = v & (v - 1) == 0 and v <= 1 << 32
    tokens = np.zeros((cfg.n_docs, cfg.doc_len), np.int32)
    mask = np.zeros((cfg.n_docs, cfg.doc_len), bool)
    min_len = max(1, int(cfg.doc_len * cfg.min_len_frac))
    conc = np.full(k, cfg.theta_conc)
    for d in range(cfg.n_docs):
        length = rng.integers(min_len, cfg.doc_len + 1)
        theta = rng.dirichlet(conc)
        # rng.choice(k, size=length, p=theta) without its argument checks:
        # the same uniforms through the same normalised CDF.
        cdf = theta.cumsum()
        cdf /= cdf[-1]
        zs = cdf.searchsorted(rng.random(length), side="right")
        # Topics in ascending order, each with its positions in ascending
        # order, as np.unique + np.nonzero give them.
        order = np.argsort(zs, kind="stable")
        counts = np.bincount(zs, minlength=k)
        ends = np.cumsum(counts)
        if raw_words:
            tokens[d, order] = _doc_words(rng, zs[order], counts, ends,
                                          probs, aliases, v)
        else:
            for t in np.flatnonzero(counts):
                idx = order[ends[t] - counts[t]:ends[t]]
                tokens[d, idx] = _np_alias_sample(probs[t], aliases[t],
                                                  idx.size, rng)
        mask[d, :length] = True
    return tokens, mask, phi


def _doc_words(rng, ts, counts, ends, probs, aliases, v):
    """The words ``_np_alias_sample`` draws for one document, topic by
    topic in ascending order, from one block of raw 64-bit outputs.

    Per topic with n tokens, ``rng.integers(0, v, n)`` takes n 32-bit
    values x and gives (x·v) >> 32 (Lemire's method, never rejected when v
    is a power of two); then ``rng.random(n)`` takes n raw words w and
    gives (w >> 11)·2⁻⁵³.  The 32-bit values come from the bit generator's
    one-value cache first, then from the low and high halves of fresh raw
    words, and that cache carries across calls: the integer draws of the
    whole document form one 32-bit stream whose raw words interleave with
    the coin words.  ``ts`` is the topic of each token in (topic, position)
    order; the cache is left as the reference leaves it.
    """
    bitgen = rng.bit_generator
    st = bitgen.state
    h0 = int(st["has_uint32"])
    n = ts.size
    present = np.flatnonzero(counts)
    before = (ends - counts)[present]          # tokens of earlier topics
    # Raw int words opened by the end of each present topic.
    opened = np.maximum(0, before + counts[present] - h0 + 1) // 2
    raw = bitgen.random_raw(int(opened[-1]) + n)

    g = np.arange(n)
    j = g - (ends - counts)[ts]
    q = np.maximum(g - h0, 0)
    w = q // 2
    # (clipped: a value taken from the cache opens no word)
    owner = np.minimum(np.searchsorted(opened, w, side="right"),
                       present.size - 1)
    x = raw[w + before[owner]]
    x32 = np.where(q % 2 == 0, x & np.uint64(0xFFFFFFFF), x >> np.uint64(32))
    if h0:
        x32[0] = np.uint64(st["uinteger"])
    slot = ((x32 * np.uint64(v)) >> np.uint64(32)).astype(np.int64)
    at = np.searchsorted(present, ts)
    coin = ((raw[opened[at] + before[at] + j] >> np.uint64(11))
            * (1.0 / 9007199254740992.0))

    if (n - h0) % 2:                  # the last int word's high half waits
        last = int(opened[-1]) - 1
        st = bitgen.state
        st["has_uint32"] = 1
        st["uinteger"] = int(raw[last + before[np.searchsorted(
            opened, last, side="right")]]) >> 32
        bitgen.state = st
    elif h0:
        st = bitgen.state
        st["has_uint32"] = 0
        bitgen.state = st
    return np.where(coin < probs[ts, slot], slot, aliases[ts, slot])


def shard_corpus(tokens, mask, n_shards: int):
    """Split documents into per-client shards (paper §5.2 data layout)."""
    d = tokens.shape[0]
    per = d // n_shards
    return [(tokens[i * per:(i + 1) * per], mask[i * per:(i + 1) * per])
            for i in range(n_shards)]


# ---------------------------------------------------------------------------
# LM token stream (for the assigned-architecture trainer; the
# reference's generator, draw for draw)
# ---------------------------------------------------------------------------

def lm_batches(vocab_size: int, batch: int, seq_len: int, n_batches: int,
               seed: int = 0, kind: str = "markov", noise: float = 0.1):
    """Synthetic language streams without external data.

    kind="affine": next = (3·cur + 1) mod V with ``noise`` random tokens —
      near-deterministic, learnable to ~1-2 nats within tens of steps (used
      by convergence tests / examples).
    kind="markov": sparse random 2nd-order Markov chain — harder, used for
      longer training runs.
    """
    rng = np.random.default_rng(seed)
    if kind == "affine":
        for _ in range(n_batches):
            out = np.zeros((batch, seq_len), np.int64)
            out[:, 0] = rng.integers(0, vocab_size, size=batch)
            flip = rng.random((batch, seq_len)) < noise
            rnd = rng.integers(0, vocab_size, size=(batch, seq_len))
            for t in range(1, seq_len):
                nxt = (out[:, t - 1] * 3 + 1) % vocab_size
                out[:, t] = np.where(flip[:, t], rnd[:, t], nxt)
            yield {"tokens": out.astype(np.int32)}
        return
    branch = 8
    # successor table: each (context hash) -> `branch` candidate tokens.
    # Context count scales with vocab so small test vocabularies stay
    # learnable within tens of steps.
    n_ctx = min(1 << 16, 4 * vocab_size)
    succ = rng.integers(0, vocab_size, size=(n_ctx, branch), dtype=np.int64)

    def hash_ctx(a, b):
        return ((a * 1000003) ^ b) % n_ctx

    for i in range(n_batches):
        out = np.zeros((batch, seq_len), np.int64)
        out[:, 0] = rng.integers(0, vocab_size, size=batch)
        out[:, 1] = rng.integers(0, vocab_size, size=batch)
        choice = rng.integers(0, branch, size=(batch, seq_len))
        for t in range(2, seq_len):
            ctx = hash_ctx(out[:, t - 2], out[:, t - 1])
            out[:, t] = succ[ctx, choice[:, t]]
        yield {"tokens": out.astype(np.int32)}
