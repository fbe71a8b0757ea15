"""Shared test fixtures.

NOTE: XLA_FLAGS device-count forcing is deliberately NOT set here — smoke
tests and benchmarks must see the single real CPU device.  Multi-device
tests spawn subprocesses (tests/test_distributed.py) or use the dry-run
entry point, which sets the flag before importing jax.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest


def make_synthetic_corpus(n_topics, vocab, n_docs, doc_len, seed=0,
                          theta_conc=0.2, phi_conc=0.4):
    """Block-structured synthetic corpus with known topics: each true topic
    owns a contiguous vocabulary block (easy to verify recovery)."""
    rng = np.random.default_rng(seed)
    true_phi = np.zeros((n_topics, vocab))
    block = vocab // n_topics
    for k in range(n_topics):
        true_phi[k, k * block:(k + 1) * block] = rng.dirichlet(
            np.ones(block) * phi_conc)
    docs = []
    for _ in range(n_docs):
        theta = rng.dirichlet(np.ones(n_topics) * theta_conc)
        zs = rng.choice(n_topics, size=doc_len, p=theta)
        docs.append(np.array([rng.choice(vocab, p=true_phi[z]) for z in zs]))
    tokens = jnp.asarray(np.stack(docs), dtype=jnp.int32)
    mask = jnp.ones((n_docs, doc_len), dtype=bool)
    return tokens, mask, true_phi


@pytest.fixture(scope="session")
def small_corpus():
    return make_synthetic_corpus(n_topics=6, vocab=120, n_docs=64, doc_len=40,
                                 seed=1)


def make_family_cfg(name, *, n_topics, vocab_size, mh_steps=2):
    """Test-sized model config for a registered ModelFamily — one factory
    so per-family hyperparameter defaults cannot drift between test files.
    Sizes (K, V) stay per-call-site; family-specific knobs live here."""
    from repro.core import hdp, lda, pdp
    if name == "lda":
        return lda.LDAConfig(n_topics=n_topics, vocab_size=vocab_size,
                             mh_steps=mh_steps)
    if name == "pdp":
        return pdp.PDPConfig(n_topics=n_topics, vocab_size=vocab_size,
                             mh_steps=mh_steps, stirling_n_max=128,
                             concentration=5.0)
    if name == "hdp":
        return hdp.HDPConfig(n_topics=n_topics, vocab_size=vocab_size,
                             b1=2.0, mh_steps=mh_steps)
    raise ValueError(name)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc; skips without one")
