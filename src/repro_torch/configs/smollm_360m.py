"""SmolLM 360M — llama-architecture small dense LM
[hf:HuggingFaceTB/SmolLM-135M]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49152,
    rope_theta=1e4, tie_embeddings=True,
    citation="[hf:HuggingFaceTB/SmolLM-135M]",
)
