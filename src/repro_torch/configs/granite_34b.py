"""granite-34b [dense] — 88L, d_model=6144, 48 heads (MQA kv=1), d_ff=24576,
vocab=49152, llama-arch code model [arXiv:2405.04324]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
    d_ff=24576, vocab=49152, head_dim=128,
    source="arXiv:2405.04324",
)
