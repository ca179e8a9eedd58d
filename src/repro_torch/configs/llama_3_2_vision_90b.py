"""Llama-3.2-Vision-90B [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.

100 layers = 80 self-attn + 20 gated cross-attn (every 5th attends to image
patch embeddings). Vision tower (ViT) is a STUB per the assignment carve-out:
input_specs() supplies projected patch embeddings. [hf:meta-llama/Llama-3.2-11B-Vision]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    n_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5,
    frontend="vision", n_frontend_tokens=1601, frontend_dim=1280,
    source="hf:meta-llama/Llama-3.2-11B-Vision",
)
