"""Granite-34B-Code [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.

Llama-style arch, code model, multi-query attention. [arXiv:2405.04324]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
    rope_theta=10_000.0,
    source="arXiv:2405.04324",
)
