"""Zamba2-7B [hybrid] — 81L d_model=3584 32H (MHA kv=32) d_ff=14336 vocab=32000,
ssm_state=64.

Mamba2 backbone + one weight-SHARED attention+MLP block applied every 6th
layer (simplified from Zamba2's dual shared blocks + concat residual; dims
preserved). [arXiv:2411.15242]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=112,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4,
    hybrid_attn_every=6, sliding_window=4096,
    source="arXiv:2411.15242",
)
