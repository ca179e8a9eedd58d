"""Qwen1.5-110B [dense] — 80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064.

QKV bias (Qwen1.5 signature). [hf:Qwen/Qwen1.5-0.5B card family, 110B dims as assigned]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=49152, vocab=152064, head_dim=128,
    qkv_bias=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
)
