"""The paper's own evaluation models (Table I), copy of
``repro.configs.paper_models``.

Published widths and depths. On the card the port serves them at those
widths through its normal entry points (``launch/serve.py``,
``chip_smoke.py``'s ``paper`` phase), depth cut where host RAM needs it;
``trace_scale`` is the CPU-sized variant with the same routing structure.

Quantization per paper §VI-A: 4-bit AWQ for both Mixtrals, FP8 for
Qwen3-30B-A3B, full weights for DeepSeekMoE-16B. The engines serve bf16;
``QUANT_BYTES`` enters only the simulator's cost model (``ModelCosts``).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.mixtral_8x7b import CONFIG as MIXTRAL_8X7B

MIXTRAL_8X22B = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, head_dim=128,
    n_experts=8, n_shared_experts=0, top_k=2, d_expert=16384,
    rope_theta=1_000_000.0, source="arXiv:2401.04088 (8x22B card)",
)

QWEN3_30B_A3B = ArchConfig(
    name="qwen3-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=768, vocab=151936, head_dim=128, qk_norm=True,
    n_experts=128, n_shared_experts=0, top_k=8, d_expert=768,
    rope_theta=1_000_000.0, source="hf:Qwen/Qwen3-30B-A3B",
)

DEEPSEEKMOE_16B = ArchConfig(
    name="deepseekmoe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, d_expert=1408,
    rope_theta=10_000.0, source="arXiv:2401.06066",
)

PAPER_MODELS = {
    "mixtral-8x7b": MIXTRAL_8X7B,
    "mixtral-8x22b": MIXTRAL_8X22B,
    "qwen3-30b-a3b": QWEN3_30B_A3B,
    "deepseekmoe-16b": DEEPSEEKMOE_16B,
}

# bytes per weight under the paper's deployment quantization
QUANT_BYTES = {
    "mixtral-8x7b": 0.5,      # AWQ 4-bit
    "mixtral-8x22b": 0.5,     # AWQ 4-bit
    "qwen3-30b-a3b": 1.0,     # FP8
    "deepseekmoe-16b": 2.0,   # full bf16
}


def trace_scale(cfg: ArchConfig) -> ArchConfig:
    """Trace-collection variant: SAME n_layers / n_experts / top_k (routing
    structure is what matters), tiny width so the live engine runs on CPU."""
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-trace",
        d_model=128, head_dim=32, n_heads=4,
        n_kv_heads=2 if cfg.n_kv_heads % 2 == 0 else 1,
        d_ff=min(cfg.d_ff, 128) if cfg.d_ff else 0,
        d_expert=64,
        vocab=2048,
        n_shared_experts=min(cfg.n_shared_experts, 1),
    )
