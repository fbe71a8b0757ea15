"""The incremental alias builds, kernel 3 (``alias_build_gather_fused``)
and kernel 5 (``alias_build_rows``), held to the reference and to their
plain versions.

Both run on the staged route of the full builds (``csrc/alias_build.cu``):
kernel 5 is kernel 2 on a compacted block of gathered rows; kernel 3
stages the n_wk rows that its row indices name (in any order), forms
prior·((n_wk+β)/(n_k+β̄)) in place, the division first, stores that dense
row to its ``dense`` output, and then builds the row as kernel 2 does.
Rows that fill less than one wave are spread over every SM.

On the CPU: ``staged_build`` (``tests/test_torch_alias_staged.py``), the
numpy float32 replay of the staged traversal, fed kernel 3's gathered term
formed in numpy float32 with the same grouping, equals the reference's
``repro.kernels.alias_build.alias_build_gather_fused`` in interpret mode
(tables, masses and dense rows) at K = 16, where XLA's CPU sums a row left
to right, for R = 1, 5 and 37 unordered rows, with LDA's prior α·1 and
with a prior like HDP's b1·θ0 that holds exact zeros; and the replay on a
compacted block of width 2K equals the reference's ``alias_build_rows``
with R not a multiple of its ``tile_r`` (8).  The port's own CPU route
(``ops.build_tables_gather_fused``, ``ops.build_tables_rows``) is held to
the same outputs.  Tolerance: none, bit for bit.

On the card (``cuda`` marker): kernels 3 and 5 against their plain
versions (``kernels.ref.alias_build_gather_fused_ref``,
``core.alias.build``), bit for bit, on ``chip_smoke.adversarial_rows`` at
K = 1024, 1023 and 2048 for R = 1, 37, 301 and 4096 unordered rows, and
above the staged width (the per-lane kernel) for R = 1 and 37.  Kernel 3
takes the rows once as n_wk with prior 1, β = 0 and n_k = 1, where its
formula passes them through, and once made into counts, with LDA's prior
and with a prior that holds zeros.  Kernel 3's rows also equal kernel 2's
rows of the full dense term.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from chip_smoke import adversarial_rows  # noqa: E402
from repro_torch.core import alias  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from test_torch_alias_staged import (  # noqa: E402
    _assert_same, _bits, _denormal_rows, _equal_bits, staged_build)

TILE_R = 8          # the reference's default row tile


def _counts(rng, v: int, k: int) -> np.ndarray:
    n_wk = np.floor(rng.gamma(0.5, size=(v, k)) * 3).astype(np.float32)
    n_wk[v // 2] = 0.0                    # an empty word
    return n_wk


def _prior(kind: str, k: int, rng) -> np.ndarray:
    """LDA's α·1, or b1·θ0 with θ0 a Dirichlet draw and two topics at an
    exact zero (b1 = 1)."""
    if kind == "lda":
        return np.full(k, 0.1, np.float32)
    theta = rng.dirichlet(np.ones(k)).astype(np.float32)
    theta[[1, k // 2]] = 0.0
    return theta


@pytest.mark.parametrize("prior_kind", ["lda", "hdp_zeros"])
@pytest.mark.parametrize("r", [1, 5, 37])
def test_staged_replay_of_gather_equals_reference(r, prior_kind):
    import jax.numpy as jnp

    from repro.kernels import alias_build as ref_kernels

    v, k = 96, 16
    rng = np.random.default_rng(10 * r + len(prior_kind))
    n_wk = _counts(rng, v, k)
    n_k = n_wk.sum(0, dtype=np.float32)
    prior = _prior(prior_kind, k, rng)
    rows = rng.permutation(v)[:r].astype(np.int32)
    rows[-1] = v // 2                     # the empty word, last
    beta = np.float32(0.01)
    beta_bar = np.float32(0.01 * v)
    dense = prior * ((n_wk[rows] + beta) / (n_k + beta_bar))
    assert dense.dtype == np.float32
    if prior_kind == "hdp_zeros":
        assert (dense == 0).any()

    want = ref_kernels.alias_build_gather_fused(
        jnp.asarray(n_wk), jnp.asarray(n_k), jnp.asarray(prior),
        jnp.asarray(rows), beta=float(beta), beta_bar=float(beta_bar))
    np.testing.assert_array_equal(_bits(dense), _bits(want[3]))
    _assert_same(staged_build(dense)[:3], want[:3])

    sub, got_dense = ops.build_tables_gather_fused(
        *(torch.as_tensor(x) for x in (n_wk, n_k, prior, rows)),
        beta=float(beta), beta_bar=float(beta_bar), device="cpu")
    np.testing.assert_array_equal(_bits(got_dense.numpy()), _bits(want[3]))
    _assert_same([t.numpy() for t in sub], want[:3])


@pytest.mark.parametrize("r", [5, 13, 37])
def test_staged_replay_of_rows_equals_reference(r):
    """A compacted block of width 2K = 16 (PDP's joint outcomes at K = 8):
    adversarial rows but the denormal ones (XLA's CPU flushes them), in a
    gathered order."""
    import jax.numpy as jnp

    from repro.kernels import alias_build as ref_kernels

    assert r % TILE_R
    pool = adversarial_rows(16, 64, seed=r)
    pool = pool[~_denormal_rows(pool)]
    rng = np.random.default_rng(r)
    block = pool[rng.permutation(len(pool))[:r]]
    want = ref_kernels.alias_build_rows(jnp.asarray(block), tile_r=TILE_R)
    _assert_same(staged_build(block)[:3], want)
    got = ops.build_tables_rows(torch.as_tensor(block), device="cpu")
    _assert_same([t.numpy() for t in got], want)


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


ROWS = [1, 37, 301, 4096]
CASES = ([(k, r) for k in (1024, 1023, 2048) for r in ROWS]
         + [("above", 1), ("above", 37)])


def _width(k, kernel: int) -> int:
    from repro_torch.kernels import alias_build as kab

    return kab.staged_max_width(kernel) + 1 if k == "above" else k


@pytest.mark.cuda
@pytest.mark.parametrize("k,r", CASES, ids=str)
def test_kernel5_on_adversarial_rows(k, r, cuda_device):
    from repro_torch.kernels import alias_build as kab

    k = _width(k, 5)
    pool = adversarial_rows(k, r + 3, seed=k + r)
    perm = np.random.default_rng(r).permutation(r + 3)[:r]
    block = torch.as_tensor(pool[perm], device=cuda_device)
    _build.reset_launches()
    got = kab.alias_build_rows(block)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["alias_build_rows"] == 1
    assert _equal_bits(got, alias.build(block))


def _gather_inputs(kind: str, k: int, r: int, device):
    """(n_wk, n_k, prior, rows, beta, beta_bar) on V = r + 3 adversarial
    rows, R = r of them gathered in a seeded order."""
    v = r + 3
    pool = adversarial_rows(k, v, seed=k + 2 * r)
    rng = np.random.default_rng(k + r)
    rows = rng.permutation(v)[:r].astype(np.int32)
    if kind == "identity":
        n_wk, n_k = pool, np.ones(k, np.float32)
        prior, beta, beta_bar = np.ones(k, np.float32), 0.0, 0.0
    else:
        n_wk = np.floor(np.nan_to_num(pool, posinf=50.0) * 3).astype(
            np.float32)
        n_k = n_wk.sum(0, dtype=np.float32)
        prior = _prior("lda" if kind == "lda" else "hdp_zeros", k, rng)
        beta, beta_bar = 0.01, 0.01 * v
    t = [torch.as_tensor(x, device=device) for x in (n_wk, n_k, prior, rows)]
    return (*t, beta, beta_bar)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["identity", "lda", "prior_zeros"])
@pytest.mark.parametrize("k,r", CASES, ids=str)
def test_kernel3_on_adversarial_rows(k, r, kind, cuda_device):
    from repro_torch.kernels import alias_build as kab

    k = _width(k, 3)
    n_wk, n_k, prior, rows, beta, beta_bar = _gather_inputs(kind, k, r,
                                                            cuda_device)
    _build.reset_launches()
    got = kab.alias_build_gather_fused(n_wk, n_k, prior, rows, beta=beta,
                                       beta_bar=beta_bar)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["alias_build_gather_fused"] == 1
    want = ref.alias_build_gather_fused_ref(n_wk, n_k, prior, rows,
                                            beta=beta, beta_bar=beta_bar)
    assert _equal_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lda", "prior_zeros"])
@pytest.mark.parametrize("k", [1024, 1023, 2048])
def test_kernel3_rows_equal_full_build(k, kind, cuda_device):
    """Kernel 3's tables, masses and dense rows equal kernel 2's on the
    same rows of the full dense term prior·((n_wk+β)/(n_k+β̄))."""
    from repro_torch.kernels import alias_build as kab

    n_wk, n_k, prior, rows, beta, beta_bar = _gather_inputs(kind, k, 301,
                                                            cuda_device)
    every = torch.arange(n_wk.shape[0], dtype=torch.int32,
                         device=cuda_device)
    full_dense = ref.gather_dense_ref(n_wk, n_k, prior, every, beta=beta,
                                      beta_bar=beta_bar)
    full = kab.alias_build(full_dense)
    got = kab.alias_build_gather_fused(n_wk, n_k, prior, rows, beta=beta,
                                       beta_bar=beta_bar)
    idx = rows.long()
    assert _equal_bits(got, [t[idx] for t in (*full, full_dense)])
