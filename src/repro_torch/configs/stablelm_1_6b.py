"""StableLM 2 1.6B — dense, MHA (kv=heads) [hf:stabilityai/stablelm-2-1_6b]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b", family="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352,
    rope_theta=1e4,
    citation="[hf:stabilityai/stablelm-2-1_6b]",
)
