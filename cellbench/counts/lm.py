"""Operations of the sparse-expert LM, counted from its sizes (the keys of
a configuration's file) as the algorithm needs them: a product of an
``(a, b)`` by a ``(b, c)`` matrix is ``2 a b c``; a token takes the
projections of its attention, the router, the ``top_k`` experts it picks
(three products each) and, where its logits are wanted, the unembedding;
causal attention over a sequence of ``S`` takes two products of ``2 S S hd``
a head, halved for the mask, so ``2 hd H S`` a token.  Nothing recomputed
and no capacity padding is counted; every subset pass of a coded step is
(the code computes each subset ``d`` times by design).
"""
from __future__ import annotations


def per_token_layer(m: dict, seq: int) -> int:
    """One layer's forward operations for one token of a sequence of
    ``seq`` tokens."""
    D, H, Hkv, hd = (m["hidden_size"], m["num_attention_heads"],
                     m["num_key_value_heads"], m["head_dim"])
    F, E, K = m["intermediate_size"], m["num_experts"], m["num_experts_per_tok"]
    proj = 2 * D * (H * hd) * 2 + 2 * D * (Hkv * hd) * 2
    attn = 2 * hd * H * seq
    return proj + attn + 2 * D * E + K * 3 * 2 * D * F


def unembed(m: dict) -> int:
    """The unembedding of one position."""
    return 2 * m["hidden_size"] * m["vocab_size"]


def forward_per_token(m: dict, seq: int) -> int:
    """A training forward's operations a token (logits at every position)."""
    return m["num_hidden_layers"] * per_token_layer(m, seq) + unembed(m)


def train_step(m: dict, seq: int, sequences: int) -> int:
    """A coded training step's model operations: forward and backward
    (three forwards' worth) of ``sequences`` sequences of ``seq`` tokens,
    where ``sequences`` counts every subset pass (``n d`` times the
    sequences a subset)."""
    return 3 * forward_per_token(m, seq) * seq * sequences


def flash(m: dict, seq: int, sequences: int, backward: bool) -> int:
    """Causal attention's operations over ``sequences`` sequences of
    ``seq`` tokens in every layer: 2 products forward, and with
    ``backward`` 4 more, each ``2 S S hd`` a head and halved for the mask."""
    per = m["head_dim"] * m["num_attention_heads"] * seq * seq
    products = 6 if backward else 2
    return products * per * m["num_hidden_layers"] * sequences
