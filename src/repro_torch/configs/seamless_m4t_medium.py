"""SeamlessM4T-medium [audio] — 12L d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=256206.

Encoder-decoder: 12 encoder + 12 decoder layers (text-to-unit stack of the
medium card). The speech frontend (mel-spectrogram + conv feature extractor)
is a STUB: input_specs() supplies (B, frames, 1024) frame embeddings.
[arXiv:2308.11596]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, head_dim=64,
    enc_layers=12,
    frontend="audio", n_frontend_tokens=0, frontend_dim=1024,
    source="arXiv:2308.11596",
)
