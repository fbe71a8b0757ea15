"""Phi-3.5-MoE 42B (6.6B active) — 16-expert top-2 MoE
[hf:microsoft/Phi-3.5-MoE-instruct]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2,
    rope_theta=1e4,
    citation="[hf:microsoft/Phi-3.5-MoE-instruct]",
)
