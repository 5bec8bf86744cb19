"""Inputs made from ``--seed``: the weights, the data and the straggler
sets.  The program and the plain reference are handed the same
ones; each side makes them anew from the seed, so neither reads what the
other made.

Weights and data are drawn on the run's device by a ``torch.Generator``
there, in a few large calls; straggler sets are small and are drawn by
numpy on the host.  This module imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

ALIGN = 64          # elements: every leaf of the weight buffer starts 256-B aligned


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for one use (``tag``) of the run's ``seed``; any whole
    number, negative or past 64 bits too, gives a valid one."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(tag)])
    return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


def generator(seed: int, tag: int, device) -> torch.Generator:
    """A generator on ``device`` for one use of the run's seed."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


# ------------------------------------------------------------- LM weights
def lm_leaves(m: dict) -> list[tuple[str, tuple, int]]:
    """``(key, shape, fan_in)`` of every leaf of a MoE LM of the sizes in
    the configuration ``m``, keyed and stacked as the program keeps them
    (``layers/...`` leaves carry the layer axis first).  ``fan_in`` 0 marks
    a norm gain, which starts at one; the others are normal draws over
    ``sqrt(fan_in)``."""
    L, D = m["num_hidden_layers"], m["hidden_size"]
    H, Hkv, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                  m["head_dim"])
    F, E, V = m["intermediate_size"], m["num_experts"], m["vocab_size"]
    leaves = [("embed", (V, D), D),
              ("layers/ln1", (L, D), 0),
              ("layers/attn/wq", (L, D, H, hd), D),
              ("layers/attn/wk", (L, D, Hkv, hd), D),
              ("layers/attn/wv", (L, D, Hkv, hd), D),
              ("layers/attn/wo", (L, H, hd, D), H * hd)]
    if m.get("qk_norm"):
        leaves += [("layers/attn/q_norm", (L, hd), 0),
                   ("layers/attn/k_norm", (L, hd), 0)]
    leaves += [("layers/ln2", (L, D), 0),
               ("layers/router", (L, D, E), D),
               ("layers/moe/w_gate", (L, E, D, F), D),
               ("layers/moe/w_up", (L, E, D, F), D),
               ("layers/moe/w_down", (L, E, F, D), F),
               ("ln_f", (D,), 0),
               ("unembed", (D, V), D)]
    return leaves


def lm_weights(m: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """The LM's f32 weights: one normal draw for all the weight matrices,
    each leaf a view of it scaled in place, and the gains at one."""
    leaves = lm_leaves(m)
    sizes = [math.prod(s) for _, s, fan in leaves if fan]
    total = sum(-(-n // ALIGN) * ALIGN for n in sizes)
    buf = torch.randn((total,), generator=generator(seed, 1, device),
                      device=device, dtype=torch.float32)
    out, off = {}, 0
    for key, shape, fan in leaves:
        if not fan:
            out[key] = torch.ones(shape, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        out[key] = buf[off:off + n].view(shape).mul_(1.0 / math.sqrt(fan))
        off += -(-n // ALIGN) * ALIGN
    return out


# ----------------------------------------------------------------- data
def logistic_rows(rows: int, features: int, seed: int, device):
    """The logistic workload's rows: Gaussian features ``x (rows, features)``
    and Bernoulli(0.5) labels ``y (rows,)`` int32."""
    g = generator(seed, 2, device)
    x = torch.randn((rows, features), generator=g, device=device,
                    dtype=torch.float32)
    y = (torch.rand((rows,), generator=g, device=device) < 0.5).to(
        torch.int32)
    return {"x": x, "y": y}


def token_batches(count: int, rows: int, seq: int, vocab: int, seed: int,
                  device) -> dict[str, torch.Tensor]:
    """``count`` training batches of ``rows`` sequences of ``seq`` uniform
    token ids: ``tokens`` and ``labels`` (the next token, the last wrapped
    around), each ``(count, rows, seq)`` int32."""
    g = generator(seed, 3, device)
    toks = torch.randint(0, vocab, (count, rows, seq), generator=g,
                         device=device, dtype=torch.int64).to(torch.int32)
    return {"tokens": toks, "labels": torch.roll(toks, -1, dims=-1)}


# ----------------------------------------------------------- stragglers
@dataclasses.dataclass(frozen=True)
class Draw:
    """One step's straggler set, in the shape the program's straggler
    sources return (no timings)."""
    stragglers: tuple[int, ...] = ()
    times: None = None
    wait_s: float = 0.0

    def restrict(self, n: int) -> "Draw":
        """The set without indices outside ``0..n-1``."""
        return Draw(tuple(i for i in self.stragglers if 0 <= i < n))


class SeededStragglers:
    """Step ``t``'s straggler set: a size drawn uniformly from ``0..most``,
    then that many distinct workers, from the run's seed and ``t`` alone,
    so a step's set does not depend on what ran before it."""
    provides_times = False

    def __init__(self, seed: int, most: int):
        self.seed, self.most = int(seed) % (1 << 64), int(most)

    def draw(self, step: int, code) -> Draw:
        rng = np.random.default_rng([self.seed, 5, int(step)])
        size = int(rng.integers(0, min(self.most, code.s) + 1))
        idx = rng.choice(code.n, size=size, replace=False)
        return Draw(tuple(sorted(int(i) for i in idx)))
