"""Gemma3-1B [dense] — 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.

5 local : 1 global attention pattern, sliding window 512, 128k-class context.
Runs long_500k via the sliding-window local layers. [hf:google/gemma-3-1b-pt]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1,
    d_ff=6912, vocab=262144, head_dim=256,
    qk_norm=True, rope_theta=1_000_000.0,
    sliding_window=512, local_global_pattern=5,
    source="hf:google/gemma-3-1b-pt",
)
