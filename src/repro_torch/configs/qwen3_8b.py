"""qwen3-8b [dense] — 36L, d_model=4096, 32 heads (GQA kv=8), d_ff=12288,
vocab=151936, qk_norm [hf:Qwen/Qwen3-8B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)
