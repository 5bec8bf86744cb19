"""whisper-tiny [audio] — enc-dec, 4L enc + 4L dec, d_model=384, 6 heads
(kv=6), d_ff=1536, vocab=51865 [arXiv:2212.04356].  The mel-spectrogram +
conv feature extractor is a STUB per the assignment: ``input_specs()``
provides frame embeddings (batch, n_frames, d_model).  Decoder context is
448 tokens by design."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, head_dim=64,
    enc_layers=4, dec_ctx=448, n_frontend_tokens=1500,  # 30 s audio -> 1500 frames
    source="arXiv:2212.04356",
)
