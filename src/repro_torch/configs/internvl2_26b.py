"""internvl2-26b [vlm] — InternViT-6B vision encoder (STUB) + InternLM2-20B
language backbone [arXiv:2404.16821].  Backbone: 48L, d_model=6144, 48 heads
(GQA kv=8), d_ff=16384, vocab=92553.  The vision tower + MLP projector are a
stub per the assignment: ``input_specs()`` provides precomputed patch
embeddings of shape (batch, n_patches, d_model)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553, head_dim=128,
    n_frontend_tokens=256,  # one 448px tile -> 256 visual tokens (pixel-shuffle)
    source="arXiv:2404.16821",
)
