"""The staged full builds of kernels 2 and 6 held to the plain version.

Kernels 2 and 6 (``csrc/alias_build.cu``, the staged route) run Vose's
pairing on a row staged in shared memory, with a traversal of their own:

* the mass is summed left to right in one lane; scaled = p/mass·K is
  formed in place, with a bit an entry for scaled < 1 (NaN counts as
  large) in mask words with a sentinel word on each side;
* the original smalls are consumed in ascending order, so each row's
  lane scans them from the mask four entries at a time; a small consumed
  by a large that stays large keeps its scaled value as prob;
* a large that turns small has the next large below it as its alias, so
  the alias array starts with that link at every large slot (self at the
  smalls); a group in which the large does not turn small is taken at
  once, a group with a turn entry by entry, each turned large storing its
  residual as prob and handing on to its link;
* the larges at and below the one current at the end were never consumed,
  and a small slot whose alias is still itself was never assigned: both
  get prob = 1 and alias = self.

:func:`staged_build` replays that traversal in numpy float32 and must
equal ``repro_torch.core.alias.build`` bit for bit on adversarial rows
(``chip_smoke.adversarial_rows``: zeros, one-hot, all equal, inf, inf and
NaN, residuals at exactly 1.0, denormals, sparse random rows) at K = 1,
17, 32, 33 and 64; and through it the reference, ``repro.core.alias.build``,
on every row but the denormal ones: XLA's CPU flushes float32 denormals to
zero (their rows become zero-mass uniform rows there), while the port, on
the CPU and on the card, keeps IEEE denormals.  At K > 16 XLA's CPU row sum
may also take another order than left to right; the corner rows sum
exactly in any order, and a random row is held to the reference only where
the two masses agree.  Tolerance: none.

On the card (``cuda`` marker): kernels 2 and 6 on the same rows, on both
width routes (staged, and per lane above ``staged_max_width``), against
the plain versions, bit for bit, with R not a multiple of the rows a block
holds and K not a multiple of 32 or 4.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import adversarial_rows  # noqa: E402
from repro_torch.core import alias  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402

KS = [1, 17, 32, 33, 64]
FULL = 0xFFFFFFFF
NO_LARGE = 0xFFFF      # the link of the lowest large
CORNER_ROWS = 16       # adversarial_rows' fixed rows, before the random ones


def _chain(s, a, mk, k, n_small, j):
    """One row's chain, as chain_row runs it → (last large, residual
    hits)."""
    one = np.float32(1.0)
    n_large = k - n_small
    tail = (1 << (k & 31)) - 1 if k & 31 else FULL
    hits = 0
    r = s[j]
    for c in range(0, k, 4):
        if c % 32 == 0:
            bits = mk[c // 32] & (tail if c + 32 >= k else FULL)
        g = (bits >> (c % 32)) & 15
        x = s[c:c + 4]
        # The group at once while the large stays large.
        t, turns, at_one = r, False, 0
        for e in range(4):
            if g >> e & 1:
                t = np.float32(t - np.float32(one - x[e]))
                turns |= bool(t < one)
                at_one += bool(t == one)
        if not turns:
            hits += at_one
            r = t
            for e in range(4):
                if g >> e & 1:
                    a[c + e] = j
            continue
        # A large turns small: entry by entry, each turned large taken by
        # its link while they turn.
        for e in range(4):
            if not g >> e & 1:
                continue
            a[c + e] = j
            r = np.float32(r - np.float32(one - x[e]))
            hits += bool(r == one)
            while r < one:
                if n_large == 1:
                    return j, hits
                n_large -= 1
                s[j] = r
                si = r
                j = a[j]
                r = np.float32(s[j] - np.float32(one - si))
                hits += bool(r == one)
    return j, hits


def staged_build(p: np.ndarray):
    """The staged kernels' traversal in numpy float32 → (prob, alias,
    mass, residual_hits), the last the number of steps whose residual was
    exactly 1.0."""
    p = np.asarray(p, np.float32)
    n_rows, k = p.shape
    words = (k + 31) // 32
    prob = np.empty((n_rows, k), np.float32)
    alias_ = np.empty((n_rows, k), np.int32)
    mass = np.empty(n_rows, np.float32)
    one, kf = np.float32(1.0), np.float32(k)
    hits = 0
    with np.errstate(all="ignore"):
        for row in range(n_rows):
            m = np.float32(0.0)
            for x in p[row]:
                m = np.float32(m + x)
            mass[row] = m
            pn = (p[row] / m if m > 0
                  else np.full(k, np.float32(1.0 / k), np.float32))
            # The row in shared memory: K rounded up to 4, plus 4.
            s = np.zeros(((k + 3) // 4) * 4 + 4, np.float32)
            s[:k] = pn * kf
            small = np.ones(words * 32, bool)        # the tail: never large
            small[:k] = s[:k] < one
            mk = [int(x) for x in np.packbits(
                small.reshape(words, 32)[:, ::-1], axis=1,
                bitorder="big").view(">u4")[:, 0]]
            # alias: self at smalls, the next large below at larges.
            a = np.arange(k)
            below = NO_LARGE
            for c in range(k):
                if not small[c]:
                    a[c], below = below, c
            n_small = int(small[:k].sum())
            j_end = k
            if n_small and n_small < k:
                j_end, h = _chain(s, a, mk, k, n_small, below)
                hits += h
            idx = np.arange(k)
            assigned = np.where(small[:k], a != idx, idx > j_end)
            prob[row] = np.where(assigned, s[:k], one)
            alias_[row] = np.where(assigned, a, idx)
    return prob, alias_, mass, hits


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _assert_same(got, want, rows=slice(None)):
    for name, g, w in zip(("prob", "alias", "mass"), got, want):
        g, w = np.asarray(g)[rows], np.asarray(w)[rows]
        if name == "alias":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


def _denormal_rows(p: np.ndarray) -> np.ndarray:
    tiny = np.finfo(np.float32).tiny
    return ((p != 0) & (np.abs(p) < tiny)).any(1)


@pytest.mark.parametrize("k", KS)
def test_staged_traversal_equals_plain_build(k):
    p = adversarial_rows(k, 41, seed=k)
    prob, al, mass, hits = staged_build(p)
    want = alias.build(torch.as_tensor(p))
    _assert_same((prob, al, mass), [t.numpy() for t in want])
    if k >= 17:
        # The rows of halves and one-and-a-halves reach the edge of the
        # small test, a residual of exactly 1.0 (large).
        assert hits > 0


@pytest.mark.parametrize("k", KS)
def test_staged_traversal_equals_reference_build(k):
    import jax.numpy as jnp

    from repro.core import alias as ref_alias

    p = adversarial_rows(k, 41, seed=100 + k)
    got = staged_build(p)[:3]
    want = ref_alias.build(jnp.asarray(p))
    keep = ~_denormal_rows(p)
    same_mass = _bits(got[2]) == _bits(np.asarray(want.mass))
    corner = np.arange(len(p)) < CORNER_ROWS
    # The corner rows sum exactly in any order.
    assert same_mass[corner & keep].all()
    _assert_same(got, want, keep & same_mass)
    assert (keep & same_mass).sum() >= CORNER_ROWS - 3


def test_denormal_rows_keep_ieee_denormals():
    """The port keeps denormal inputs as the card does: a row of the
    smallest denormal has a non-zero mass and the uniform table of its
    own, not the zero-mass fallback."""
    p = adversarial_rows(17, 16, seed=0)
    denormal = np.flatnonzero(_denormal_rows(p))
    assert denormal.size == 3
    prob, al, mass, _ = staged_build(p[denormal])
    assert (mass > 0).all()
    _assert_same((prob, al, mass),
                 [t.numpy() for t in alias.build(torch.as_tensor(
                     p[denormal]))])


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


WIDTHS = KS + [1023, 1026, 1024, 2048, "above"]


def _equal_bits(got, want) -> bool:
    return all(torch.equal(g.view(torch.int32), w.view(torch.int32))
               for g, w in zip(got, want))


def _width(k, fused: bool) -> int:
    from repro_torch.kernels import alias_build as kab

    return kab.staged_max_width(6 if fused else 2) + 1 if k == "above" else k


@pytest.mark.cuda
@pytest.mark.parametrize("k", WIDTHS, ids=str)
def test_kernel2_on_adversarial_rows(k, cuda_device):
    from repro_torch.kernels import alias_build as kab

    k = _width(k, False)
    n = 37 if k > 4096 else 301
    p = torch.as_tensor(adversarial_rows(k, n, seed=k), device=cuda_device)
    _build.reset_launches()
    got = kab.alias_build(p)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["alias_build"] == 1
    assert _equal_bits(got, alias.build(p))


@pytest.mark.cuda
@pytest.mark.parametrize("k", WIDTHS, ids=str)
@pytest.mark.parametrize("formula", ["identity", "lda"])
def test_kernel6_on_adversarial_rows(k, formula, cuda_device):
    """Kernel 6 on n_wk rows that its formula passes through unchanged
    (α = 1, β = 0, n_k = 1: the adversarial rows themselves), and with
    LDA's α and β on the same rows made into counts."""
    from repro_torch.kernels import alias_build as kab

    k = _width(k, True)
    n = 37 if k > 4096 else 301
    rows = adversarial_rows(k, n, seed=k + 7)
    if formula == "identity":
        n_wk = torch.as_tensor(rows, device=cuda_device)
        n_k = torch.ones(k, device=cuda_device)
        alpha, beta, vocab = 1.0, 0.0, n
    else:
        counts = np.floor(np.nan_to_num(rows, posinf=50.0) * 3)
        n_wk = torch.as_tensor(counts.astype(np.float32), device=cuda_device)
        n_k = n_wk.sum(0)
        alpha, beta, vocab = 0.1, 0.01, n
    _build.reset_launches()
    got = kab.alias_build_fused(n_wk, n_k, alpha=alpha, beta=beta,
                                beta_bar=beta * vocab)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["alias_build_fused"] == 1
    assert _equal_bits(got, ref.alias_build_fused_ref(
        n_wk, n_k, alpha=alpha, beta=beta, vocab_size=vocab))
