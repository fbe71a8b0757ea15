"""Zamba2 2.7B — Mamba2 backbone + SHARED attention block applied
periodically [arXiv:2411.15242].

54 Mamba2 layers; one shared (weight-tied) attention+MLP block is applied
every 6 SSM layers.  At the long_500k shape the shared attention uses a
4096 sliding window (DESIGN.md §4)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, head_dim=80,
    d_ff=10240, vocab_size=32000,
    ssm_kind="mamba2", ssm_state=64, ssm_heads=40, ssm_conv=4,
    attn_every=6,
    citation="[arXiv:2411.15242]",
)
