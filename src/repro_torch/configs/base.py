"""Model / workload configuration system (port of ``repro.configs.base``).

Every assigned architecture is a ``ModelConfig`` (exact hyper-parameters
from its source paper / model card, cited in the per-arch module).  Configs
are plain frozen dataclasses, hashable and equal field for field to the
reference's, and carry everything the models and the trainer need.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # attention options
    rope_theta: float = 1e4
    qk_norm: bool = False            # qwen3
    attn_bias: bool = False          # qwen2 QKV bias
    sliding_window: int = 0          # 0 = full attention; mixtral: 4096

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight
    moe_groups: int = 0              # grouped-local dispatch (0/1 = global
                                     # sort; zero modes set = mesh size)

    # SSM / linear attention
    ssm_kind: str = ""               # "rwkv6" | "mamba2"
    ssm_state: int = 64              # state dim per head (mamba2 d_state)
    ssm_heads: int = 0               # 0 -> derived
    ssm_conv: int = 4                # mamba short conv width

    # hybrid (zamba2): one SHARED attention block applied every N ssm layers
    attn_every: int = 0

    # encoder-decoder (whisper): n_layers is the decoder depth
    encoder_layers: int = 0
    n_frames: int = 0                # audio stub frames (post-conv)

    # VLM: stub patch embeddings at the vision encoder's output width
    n_patches: int = 0
    vision_dim: int = 0

    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    citation: str = ""

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over any mesh axis
        we use (logits for padding ids are masked to -inf in the loss)."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True iff decode at 500k tokens is sub-quadratic / bounded-state:
        SSM (constant state), hybrid (windowed attention at that shape), or
        native sliding-window attention."""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window > 0)

    @property
    def has_decode(self) -> bool:
        """Encoder-only models have no decode step; all assigned archs here
        are decoders or enc-dec, so this is True throughout — kept for the
        config contract."""
        return True

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (embedding included once; used for MODEL_FLOPS).
    def param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top_k experts count)."""
        from repro_torch.models.model import count_params_analytic
        return count_params_analytic(self, active_only=True)


@dataclass(frozen=True)
class InputShape:
    """One of the assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family for CPU smoke tests:
    2 layers, d_model ≤ 512, ≤ 4 experts — per the assignment contract."""
    d_model = min(cfg.d_model, 256)
    n_heads = min(cfg.n_heads, 4)
    if n_heads:
        n_kv = max(1, min(cfg.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
    else:
        n_kv = 0
    kw = dict(
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads if n_heads else 0,
        d_ff=min(cfg.d_ff, 512),
        vocab_size=min(cfg.vocab_size, 1024),
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
    )
    if cfg.n_experts:
        kw["n_experts"] = min(cfg.n_experts, 4)
        kw["top_k"] = min(cfg.top_k, 2)
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
        kw["n_frames"] = 16
    if cfg.n_patches:
        kw["n_patches"] = 8
        kw["vision_dim"] = min(cfg.vision_dim, 64)
    if cfg.ssm_kind:
        kw["ssm_state"] = min(cfg.ssm_state, 16)
        kw["ssm_heads"] = min(cfg.ssm_heads or 4, 4)
    if cfg.attn_every:
        kw["attn_every"] = 1
    return cfg.replace(**kw)
