"""Architecture configs and input shapes (copy of ``repro.configs.base``).

Each config module ``repro_torch/configs/<id>.py`` exports ``CONFIG:
ArchConfig`` with the published dimensions. ``get_config(name)`` resolves by
id; ``reduced(cfg)`` gives the small test variant of the same family (2
layers, d_model <= 256, <= 4 experts), field for field as the reference
computes it, so the tests hold both packages on the same shapes.
``INPUT_SHAPES`` are the four workloads every config must run and
``pairs()`` the (config, shape) matrix ``launch/dryrun.py`` drives.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import List, Optional, Tuple


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

    @property
    def supports_long_decode(self) -> bool:
        """Sub-quadratic decode memory: SSM / hybrid / sliding-window archs."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def window_for_layer(self, layer: int) -> int:
        """-1 means full attention; otherwise the sliding window size."""
        if self.sliding_window is None:
            return -1
        if self.local_global_pattern is None:
            return self.sliding_window
        return -1 if (layer % (self.local_global_pattern + 1)
                      == self.local_global_pattern) else self.sliding_window


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = (
    "qwen3_1_7b",
    "granite_34b",
    "llama_3_2_vision_90b",
    "seamless_m4t_medium",
    "mamba2_2_7b",
    "qwen1_5_110b",
    "qwen2_moe_a2_7b",
    "zamba2_7b",
    "gemma3_1b",
    "kimi_k2_1t_a32b",
    "mixtral_8x7b",
)

_ALIASES = {a.replace("_", "-"): a for a in ARCH_IDS}
_ALIASES.update({
    "qwen3-1.7b": "qwen3_1_7b",
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "qwen1.5-110b": "qwen1_5_110b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mamba2-2.7b": "mamba2_2_7b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
})


def get_config(name: str) -> ArchConfig:
    mod_name = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if mod_name not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG


def all_configs() -> Tuple[ArchConfig, ...]:
    return tuple(get_config(a) for a in ARCH_IDS)


def pairs() -> List[Tuple[ArchConfig, InputShape]]:
    """All (arch, shape) pairs, honouring decode-shape applicability: the
    ten assigned configs (not the paper's Mixtral replica) by each of the
    four shapes, ``long_500k`` only where ``supports_long_decode``."""
    out = []
    for a in ARCH_IDS:
        if a == "mixtral_8x7b":
            continue
        cfg = get_config(a)
        for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            shape = INPUT_SHAPES[s]
            if shape.name == "long_500k" and not cfg.supports_long_decode:
                continue
            out.append((cfg, shape))
    return out


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
