"""The LM side against the reference, the fourth to seventh of the ten architectures in
sorted order (the others in ``test_torch_lm_model_a.py`` and ``_c.py``;
split so that each file stays short under ``--dist loadfile``), the
reference's weights carried across through ``bridge.lm_params_from``.  The checks and their tolerances
are ``test_torch_lm_model_a.py``'s.
"""

from __future__ import annotations

import pytest

from tests.test_torch_lm_common import (ALL_ARCHS, check_bf16,
                                   check_decode_against_reference,
                                   check_float32, check_roundtrip, configs,
                                   ref_params)
from tests.test_torch_lm_common import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ALL_ARCHS[3:7]


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
