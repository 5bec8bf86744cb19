"""zamba2-1.2b [hybrid] — 38 Mamba2 layers, d_model=2048, shared attention
block (32 heads, kv=32, d_ff=8192) applied every 6 layers, vocab=32000,
ssm_state=64 [arXiv:2411.15242]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, head_dim=64,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_every=6,
    source="arXiv:2411.15242",
)
