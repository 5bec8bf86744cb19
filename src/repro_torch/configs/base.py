"""Architecture config schema shared by the model zoo.

Every assigned architecture gets one ``<arch>.py`` module defining ``CONFIG``
with the exact dimensions from the assignment (source cited in the module
docstring).  ``reduced()`` produces the family-preserving smoke-test variant
(<= 2 layers, d_model <= 512, <= 4 experts) exercised on CPU; the full configs
are exercised only through the dry-run (ShapeDtypeStruct, no allocation).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # attention details
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 4096  # used only by long-context serving variants
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    attn_every: int = 0         # hybrid: shared attention block every k SSM layers
    # encoder-decoder (audio)
    enc_layers: int = 0
    dec_ctx: int = 0            # decoder context limit (whisper: 448)
    # modality frontend stubs (audio frames / vision patches)
    n_frontend_tokens: int = 0
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    # citation
    source: str = ""

    # ------------------------------------------------------------- derived
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def __post_init__(self):
        if self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: n_heads must be divisible by n_kv_heads")
        if self.family == "moe" and (self.n_experts < 1 or self.top_k < 1):
            raise ValueError(f"{self.name}: moe needs n_experts/top_k")

    def reduced(self) -> "ModelConfig":
        """Family-preserving smoke-test variant (2 layers, d_model <= 512,
        <= 4 experts) that runs a real fwd/train step on CPU."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        while n_heads % n_kv:
            n_kv -= 1
        kw = dict(
            n_layers=2,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            head_dim=d_model // n_heads,
            sliding_window=64,
            ssm_head_dim=min(self.ssm_head_dim, 32) if self.ssm_state else self.ssm_head_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=16,
            name=self.name + "-reduced",
        )
        if self.n_experts:
            kw["n_experts"] = min(self.n_experts, 4)
            kw["top_k"] = min(self.top_k, 2)
        if self.attn_every:
            kw["attn_every"] = 1
        if self.enc_layers:
            kw["enc_layers"] = 2
            kw["dec_ctx"] = min(self.dec_ctx or 64, 64)
        if self.n_frontend_tokens:
            kw["n_frontend_tokens"] = 8
        return dataclasses.replace(self, **kw)
