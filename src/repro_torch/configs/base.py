"""Architecture configs (copy of ``repro.configs.base``).

Each config module ``repro_torch/configs/<id>.py`` exports ``CONFIG:
ArchConfig`` with the published dimensions. ``get_config(name)`` resolves by
id; ``reduced(cfg)`` gives the small test variant of the same family (2
layers, d_model <= 256, <= 4 experts), field for field as the reference
computes it, so the tests hold both packages on the same shapes.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads

    # attention options
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None       # window for local layers
    local_global_pattern: Optional[int] = None  # e.g. 5 -> 5 local : 1 global
    rms_eps: float = 1e-6

    # MoE options
    n_experts: int = 0           # routed experts (0 => dense FFN)
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0            # per-expert FFN hidden dim
    n_dense_layers: int = 0      # leading dense layers (kimi first_k_dense)
    dense_d_ff: int = 0          # d_ff for those leading dense layers
    router_aux_loss: float = 0.01
    capacity_factor: float = 1.25

    # SSM options (mamba2 / hybrid)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    hybrid_attn_every: int = 0

    # enc-dec options
    enc_layers: int = 0
    cross_attn_every: int = 0

    # modality frontend stubs
    frontend: Optional[str] = None
    n_frontend_tokens: int = 0
    frontend_dim: int = 0

    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def window_for_layer(self, layer: int) -> int:
        """-1 means full attention; otherwise the sliding window size."""
        if self.sliding_window is None:
            return -1
        if self.local_global_pattern is None:
            return self.sliding_window
        return -1 if (layer % (self.local_global_pattern + 1)
                      == self.local_global_pattern) else self.sliding_window


# the configs the port serves: the paper's headline model, qwen2-moe (shared
# experts, padded router) for the routing tests, and mamba2 (the ssm family)
ARCH_IDS = ("mixtral_8x7b", "qwen2_moe_a2_7b", "mamba2_2_7b")

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES["qwen2-moe-a2.7b"] = "qwen2_moe_a2_7b"
_ALIASES["mamba2-2.7b"] = "mamba2_2_7b"


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Smoke-test variant: same family/features, tiny dims (CPU-runnable)."""
    hd = 32
    n_heads = max(2, min(4, cfg.n_heads))
    n_kv = 1 if cfg.n_kv_heads == 1 else min(cfg.n_kv_heads, n_heads)
    d_model = min(256, cfg.d_model)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-reduced",
        n_layers=2,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=hd,
        d_ff=min(512, cfg.d_ff) if cfg.d_ff else 0,
        vocab=512,
        n_experts=min(4, cfg.n_experts) if cfg.n_experts else 0,
        n_shared_experts=min(1, cfg.n_shared_experts),
        top_k=min(2, cfg.top_k) if cfg.top_k else 0,
        d_expert=min(128, cfg.d_expert) if cfg.d_expert else 0,
        n_dense_layers=min(1, cfg.n_dense_layers),
        dense_d_ff=min(256, cfg.dense_d_ff) if cfg.dense_d_ff else 0,
        ssm_state=min(16, cfg.ssm_state) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else cfg.ssm_head_dim,
        hybrid_attn_every=2 if cfg.hybrid_attn_every else 0,
        enc_layers=min(2, cfg.enc_layers),
        cross_attn_every=2 if cfg.cross_attn_every else 0,
        sliding_window=min(64, cfg.sliding_window) if cfg.sliding_window else None,
        local_global_pattern=cfg.local_global_pattern,
        n_frontend_tokens=min(16, cfg.n_frontend_tokens),
        frontend_dim=min(64, cfg.frontend_dim) if cfg.frontend_dim else 0,
    )
