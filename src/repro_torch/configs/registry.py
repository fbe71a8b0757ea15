"""Architecture registry: ``--arch <id>`` resolution (port of
``repro.configs.registry``)."""
from __future__ import annotations

from repro_torch.configs import (internvl2_76b, mixtral_8x7b, phi35_moe,
                                 qwen2_1_5b, qwen3_14b, rwkv6_3b,
                                 smollm_360m, stablelm_1_6b,
                                 whisper_large_v3, zamba2_2_7b)
from repro_torch.configs.base import ModelConfig

ARCHITECTURES: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (mixtral_8x7b, phi35_moe, smollm_360m, stablelm_1_6b,
              whisper_large_v3, qwen3_14b, rwkv6_3b, zamba2_2_7b,
              internvl2_76b, qwen2_1_5b)
}


def get(arch: str) -> ModelConfig:
    if arch not in ARCHITECTURES:
        raise KeyError(
            f"unknown arch {arch!r}; available: {sorted(ARCHITECTURES)}")
    return ARCHITECTURES[arch]
