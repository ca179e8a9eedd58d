"""Mixtral-8x7B replica [moe] — the paper's own headline model.
32L d_model=4096 32H (GQA kv=8) 8 experts top-2, expert d_ff=14336,
vocab=32000. [arXiv:2401.04088]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, head_dim=128,
    n_experts=8, n_shared_experts=0, top_k=2, d_expert=14336,
    rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)
