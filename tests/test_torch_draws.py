"""The alias draws of kernels 7 and 8 (``csrc/alias_sample.cu``) held to
their plain version, ``kernels/ref.py::alias_sample_ref``.

Kernel 8 (``alias_sample_batch_kernel``) has a traversal of its own: a
thread takes ``DRAWS`` adjacent draws, loads their rows, slots and coins
(as vectors when the group is whole and the streams are 16-byte aligned,
else one by one up to the end of the stream), gathers prob for the real
draws (rows in [0, V)), then alias for those whose coin rejected the slot,
and writes 0 for the sentinels.  :func:`replay_batches` runs that in numpy
and must equal the plain version bit for bit for B = 0, 1, 3 and 4097
(ragged tails), with sentinels at V, above it and below 0, on both load
routes; it also counts the gathers, which must be one prob a real draw
and one alias a rejected one, none for a sentinel.  Tolerance: none.

On the card (``cuda`` marker): kernels 7 and 8 on the same cases against
the plain version, bit for bit, also on streams one element off a 16-byte
boundary; no draw, no launch.  Kernel 7 also on sorted streams whose runs
are long (Zipf lengths, up to thousands of draws of one row, −1 sentinels
first and V sentinels last) at K = 24, 1021, 1024, 2048 and 8192, with
streams and tables aligned and one element off, and on an unsorted stream
of long runs with sentinels at −1 and 2V among them.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core import alias
from repro_torch.kernels import _build, ref

DRAWS = 4                   # the kernel's kDraws
V, K = 37, 24


def draw_case(b: int, seed: int):
    """Tables of V random rows and B draws: rows in [0, V) with sentinels
    at V, 2V and −1 scattered among them, seeded slots and coins."""
    rng = np.random.default_rng(seed)
    p = rng.gamma(0.3, size=(V, K)) * (rng.random((V, K)) < 0.6)
    tables = alias.build(torch.as_tensor(p, dtype=torch.float32))
    rows = rng.integers(0, V, size=b)
    sentinel = rng.random(b) < 0.2
    rows[sentinel] = rng.choice([V, 2 * V, -1], size=int(sentinel.sum()))
    slot = rng.integers(0, K, size=b)
    coin = rng.random(b).astype(np.float32)
    return (tables, torch.as_tensor(rows, dtype=torch.int32),
            torch.as_tensor(slot, dtype=torch.int32), torch.as_tensor(coin))


def replay_batches(prob, alias_t, rows, slot, coin, vec: bool):
    """alias_sample_batch_kernel thread by thread → (draws, prob gathers,
    alias gathers)."""
    prob, alias_t = prob.numpy(), alias_t.numpy()
    rows, slot, coin = rows.numpy(), slot.numpy(), coin.numpy()
    b, v = rows.shape[0], prob.shape[0]
    out = np.full(b, -7, np.int32)
    n_prob = n_alias = 0
    for i0 in range(0, b, DRAWS):
        whole = vec and i0 + DRAWS <= b
        idx = [i0 + e for e in range(DRAWS)]
        r = [int(rows[i]) if whole or i < b else -1 for i in idx]
        s = [int(slot[i]) if whole or i < b else 0 for i in idx]
        u = [coin[i] if whole or i < b else np.float32(0) for i in idx]
        real = [0 <= x < v for x in r]
        p = []
        for e in range(DRAWS):
            p.append(prob[r[e], s[e]] if real[e] else np.float32(0))
            n_prob += real[e]
        al = []
        for e in range(DRAWS):
            need = real[e] and not u[e] < p[e]
            al.append(int(alias_t[r[e], s[e]]) if need else 0)
            n_alias += need
        for e, i in enumerate(idx):
            if whole or i < b:
                out[i] = 0 if not real[e] else s[e] if u[e] < p[e] else al[e]
    return out, n_prob, n_alias


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("b", [0, 1, 3, 4097])
def test_batched_draws_match_plain(b, vec):
    tables, rows, slot, coin = draw_case(b, seed=b)
    got, n_prob, n_alias = replay_batches(tables.prob, tables.alias, rows,
                                          slot, coin, vec)
    want = ref.alias_sample_ref(tables.prob, tables.alias, rows, slot, coin)
    np.testing.assert_array_equal(got, want.numpy())
    real = (rows >= 0) & (rows < V)
    r = rows.clamp(0, V - 1).long()
    took_alias = real & ~(coin < tables.prob[r, slot.long()])
    assert n_prob == int(real.sum()) and n_alias == int(took_alias.sum())
    assert bool((want[~real] == 0).all())


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _off(t: torch.Tensor, offset: int, dev) -> torch.Tensor:
    """``t`` on ``dev`` as a contiguous view ``offset`` elements into its
    storage (off a 16-byte boundary when ``offset`` is 1)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
    view = buf[offset:]
    view.copy_(t.reshape(-1))
    return view.view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("b", [0, 1, 3, 4097, 65539])
@pytest.mark.parametrize("name", ["alias_sample", "alias_sample_sorted"])
def test_draw_kernels_match_plain(name, b, offset, cuda_device):
    """Kernel 8 on the stream as drawn, kernel 7 on it sorted with its
    sentinels last (its layout's order); bit for bit."""
    from repro_torch.kernels import alias_sample as kas

    tables, rows, slot, coin = draw_case(b, seed=b + 1)
    if name == "alias_sample_sorted":
        key = torch.where(rows < 0, 3 * V, rows)
        order = torch.argsort(key, stable=True)
        rows, slot, coin = rows[order], slot[order], coin[order]
    want = ref.alias_sample_ref(tables.prob, tables.alias, rows, slot, coin)
    args = [t.to(cuda_device) for t in (tables.prob, tables.alias)] + [
        _off(t, offset, cuda_device) for t in (rows, slot, coin)]
    _build.reset_launches()
    got = getattr(kas, name)(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == (1 if b else 0)
    assert torch.equal(got.cpu(), want)


def tables_of(k: int, seed: int):
    rng = np.random.default_rng(seed)
    p = rng.gamma(0.3, size=(V, k)) * (rng.random((V, k)) < 0.6)
    return alias.build(torch.as_tensor(p, dtype=torch.float32))


def long_runs(k: int, b: int, seed: int):
    """A sorted stream of B draws with Zipf run lengths, −1 sentinels first
    and V sentinels last; seeded slots and coins."""
    rng = np.random.default_rng(seed)
    counts = rng.zipf(1.3, size=V).astype(np.float64)
    counts = np.floor(counts / counts.sum() * b * 0.8).astype(np.int64)
    rows = np.concatenate([np.full(7, -1), np.repeat(np.arange(V), counts)])
    rows = np.concatenate([rows, np.full(max(0, b - rows.shape[0]), V)])[:b]
    return (torch.as_tensor(rows, dtype=torch.int32),
            torch.as_tensor(rng.integers(0, k, size=b), dtype=torch.int32),
            torch.as_tensor(rng.random(b).astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize("tables_off", [0, 1])
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("b", [1, 4097, 65539])
@pytest.mark.parametrize("k", [24, 1021, 1024, 2048, 8192])
def test_sorted_kernel_on_long_runs(k, b, offset, tables_off, cuda_device):
    """Kernel 7 bit for bit on sorted streams with long runs; streams and
    tables aligned and one element off a 16-byte boundary."""
    from repro_torch.kernels import alias_sample as kas

    tables = tables_of(k, k)
    rows, slot, coin = long_runs(k, b, seed=b + k)
    want = ref.alias_sample_sorted_ref(tables.prob, tables.alias, rows,
                                       slot, coin)
    args = [_off(t, tables_off, cuda_device)
            for t in (tables.prob, tables.alias)] + [
        _off(t, offset, cuda_device) for t in (rows, slot, coin)]
    _build.reset_launches()
    got = kas.alias_sample_sorted(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["alias_sample_sorted"] == 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_sorted_kernel_on_an_unsorted_stream(cuda_device):
    """Kernel 7 on a stream in no order, with long runs and sentinels at −1
    and 2V among its rows: the same draws."""
    from repro_torch.kernels import alias_sample as kas

    tables = tables_of(1024, 9)
    rng = np.random.default_rng(9)
    runs = rng.choice([-1, 2 * V, *range(V)], size=3000)
    lengths = rng.integers(1, 300, size=3000)
    rows = torch.as_tensor(np.repeat(runs, lengths), dtype=torch.int32)
    b = rows.shape[0]
    slot = torch.as_tensor(rng.integers(0, 1024, size=b), dtype=torch.int32)
    coin = torch.as_tensor(rng.random(b).astype(np.float32))
    want = ref.alias_sample_sorted_ref(tables.prob, tables.alias, rows,
                                       slot, coin)
    got = kas.alias_sample_sorted(
        *(t.to(cuda_device) for t in (tables.prob, tables.alias, rows, slot,
                                      coin)))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
