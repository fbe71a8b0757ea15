"""Whisper large-v3 — encoder-decoder ASR backbone [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a STUB (assignment
carve-out): input_specs() provides post-conv frame embeddings (1500, 1280);
the encoder and decoder transformers are real.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab_size=51866,
    encoder_layers=32, n_frames=1500,
    citation="[arXiv:2212.04356]",
)
