"""The LM side against the reference, the first three of the ten architectures in
sorted order (the others in ``test_torch_lm_model_b.py`` and ``_c.py``;
split so that each file stays short under ``--dist loadfile``), the
reference's weights carried across through ``bridge.lm_params_from``.

* float32 (both packages' ``COMPUTE_DTYPE`` patched inside the test):
  forward, logits, ``chunked_ce_loss`` and the gradients of ``loss_fn``
  (``test_torch_lm_common.check_float32`` states the tolerances, ~1e-4); at
  the default bf16, forward, logits, the loss and its gradients leaf by
  leaf against the reference's own bf16-vs-float32 gap
  (``test_torch_lm_common.check_bf16`` states the measured bounds).
* Prefill and one decode step against the reference's ``prefill`` and
  ``decode_step``, float32 compute in both packages (the caches stay bf16
  in both, as the reference casts them): the prefill's last logits within
  1e-4 relative (max error over max); every cache leaf within 1e-2 in
  Frobenius norm (a key the two packages compute a few f32 ulp apart may
  round to bf16 one ulp apart: measured ≤ 2e-3), ``pos`` and the ring's
  ``key_pos`` equal; one decode step from the reference's own cache
  within 1e-4 of the reference's logits, and from the port's cache within
  1e-3 (measured ≤ 1e-4).  MoE capacity is lifted, as in the reference's
  round-trip test.
* At the default bf16, the port's prefill of S tokens and one decode step
  against its own forward over S + 1 (the reference's round-trip test):
  argmax equal wherever the forward's top-2 margin exceeds 1e-2 (so a
  near tie, the reference's own intermittent failure, decides nothing),
  correlation > 0.99.
"""

from __future__ import annotations

import pytest

from tests.test_torch_lm_common import (ALL_ARCHS, check_bf16,
                                   check_decode_against_reference,
                                   check_float32, check_roundtrip, configs,
                                   ref_params)
from tests.test_torch_lm_common import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ALL_ARCHS[:3]


@pytest.fixture(scope="module")
def weights():
    """The reference's weights and the port's copy, per architecture."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = ref_params(configs(arch)[0], ALL_ARCHS.index(arch))
        return cache[arch]

    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_grads_float32(arch, weights):
    check_float32(arch, *weights(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_loss_bf16(arch, weights):
    check_bf16(arch, *weights(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_against_the_reference(arch, weights):
    check_decode_against_reference(arch, *weights(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_roundtrip(arch):
    """prefill(S tokens) then decode_step agrees with forward on S + 1."""
    check_roundtrip(arch)
