"""InternVL2 76B — InternViT (STUB) + InternLM2-76B language backbone
[arXiv:2404.16821].

The vision encoder is a stub per the assignment carve-out: input_specs()
provides 256 patch embeddings at the ViT output width (3200); the MLP
projector into the LM and the 80-layer language model are real."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    n_patches=256, vision_dim=3200,
    rope_theta=1e6,
    citation="[arXiv:2404.16821]",
)
