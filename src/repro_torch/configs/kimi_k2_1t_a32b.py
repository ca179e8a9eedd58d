"""Kimi-K2-1T-A32B [moe] — 61L d_model=7168 64H (GQA kv=8) d_ff(expert)=2048
vocab=163840, 384 routed experts top-8 + 1 shared, layer 0 dense (d_ff 18432).

Trillion-param MoE, paper-table scale; extreme sparsity regime for DuoServe.
Assigned GQA kv=8 used as given (real K2 uses MLA; noted in DESIGN.md).
[arXiv:2501.kimi2]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab=163840, head_dim=128,
    n_experts=384, n_shared_experts=1, top_k=8, d_expert=2048,
    n_dense_layers=1, dense_d_ff=18432,
    rope_theta=50_000.0,
    source="arXiv:2501.kimi2",
)
