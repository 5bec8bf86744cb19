"""xlstm-350m [ssm] — 24L (alternating sLSTM / mLSTM blocks), d_model=1024,
4 heads, d_ff=0 (block-internal up/down projections), vocab=50304
[arXiv:2405.04517].

The model's head size is ``2 * d_model / n_heads`` = 512 (the cells run at
the inner width ``2 * d_model``: ``models/xlstm.py:_dims``), not
``head_dim``, which the xLSTM never reads."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, head_dim=256,
    source="arXiv:2405.04517",
)
