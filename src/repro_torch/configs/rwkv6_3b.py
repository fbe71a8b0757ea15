"""RWKV-6 (Finch) 3B — attention-free, data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=8960, vocab_size=65536,
    ssm_kind="rwkv6", ssm_heads=40, ssm_state=64,  # 40 heads x 64 head_dim
    citation="[arXiv:2404.05892]",
)
