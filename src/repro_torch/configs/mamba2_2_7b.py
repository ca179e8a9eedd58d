"""Mamba2-2.7B [ssm] — 64L d_model=2560, attn-free, vocab=50280, ssm_state=128.

SSD (state-space duality), expand=2 -> d_inner=5120, headdim=64 -> 80 heads,
conv4, ngroups=1. [arXiv:2405.21060]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_groups=1,
    source="arXiv:2405.21060",
)
