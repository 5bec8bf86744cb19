"""Data pipeline: synthetic token / feature streams + the cyclic redundant
placement the paper's coding scheme requires.

The paper partitions the data into k = n subsets; worker i holds subsets
{i, ..., i+d-1} (mod n) (Section III).  ``CodedBatcher`` turns a global batch
of (global_batch, ...) samples into the redundant per-worker layout
(n, d, b_subset, ...): row i stacks the d subsets assigned to worker i.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from ..core import GradCode


@dataclasses.dataclass(frozen=True)
class CodedBatcher:
    """Redundant placement of a global batch according to a gradient code.

    Serves both the uniform ``GradCode`` (k = n subsets, cyclic window) and
    the heterogeneous ``HeteroCode`` (k subsets decoupled from n, ragged
    per-worker loads padded to d = max load; padded slots repeat a held
    subset and carry zero encode/rho weight).
    """
    code: GradCode

    def subset_size(self, global_batch: int) -> int:
        """Samples per data subset (= global batch / number of subsets)."""
        k = self.code.num_subsets
        if global_batch % k:
            raise ValueError(
                f"global_batch {global_batch} not divisible by k={k} subsets")
        return global_batch // k

    def place(self, batch: dict) -> dict:
        """{name: (global_batch, ...)} -> {name: (n, d, b_subset, ...)}.

        Values may be numpy arrays or torch tensors; each comes back as
        what it was, a tensor on the device it was on — placing a batch
        that already lies on the card moves the d-fold redundant copy at
        device-memory speed instead of through the host."""
        n, d, k = self.code.n, self.code.d, self.code.num_subsets
        placement = self.code.placement().reshape(-1)   # (n*d,) subset ids
        out = {}
        for name, v in batch.items():
            b = self.subset_size(v.shape[0])
            subsets = v.reshape(k, b, *v.shape[1:])  # subset j = rows j*b:(j+1)*b
            if isinstance(v, torch.Tensor):
                idx = torch.as_tensor(placement, device=v.device)
                picked = subsets.index_select(0, idx)
            else:
                picked = subsets[placement]
            out[name] = picked.reshape(n, d, b, *v.shape[1:])
        return out

    def unplace_subsets(self, placed):
        """Inverse sanity helper: recover (n, b_subset, ...) unique subsets."""
        return placed[:, 0]


# ------------------------------------------------------------ synthetic LM
def make_synthetic_batch(rng: np.random.Generator, cfg, global_batch: int,
                         seq_len: int = 0) -> dict[str, np.ndarray]:
    """One synthetic batch for any zoo config (tokens/labels/embeds/x/y),
    made on the host from ``rng``: the reference's numbers, draw for draw."""
    if cfg.family == "linear":
        x = rng.standard_normal((global_batch, cfg.d_model)).astype(np.float32)
        y = (rng.random(global_batch) < 0.5).astype(np.int32)
        return {"x": x, "y": y}
    toks = rng.integers(0, cfg.vocab, (global_batch, seq_len), dtype=np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family in ("vlm", "encdec"):
        batch["embeds"] = rng.standard_normal(
            (global_batch, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        # decoder tokens are bounded by dec_ctx
        S = min(seq_len, cfg.dec_ctx)
        batch["tokens"] = batch["tokens"][:, :S]
        batch["labels"] = batch["labels"][:, :S]
    return batch


def synthetic_lm_stream(cfg, global_batch: int, seq_len: int = 0,
                        seed: int = 0) -> Iterator[dict[str, np.ndarray]]:
    """Endless stream of synthetic batches from one seeded generator."""
    rng = np.random.default_rng(seed)
    while True:
        yield make_synthetic_batch(rng, cfg, global_batch, seq_len)


synthetic_stream = synthetic_lm_stream   # the name earlier slices exported


# ----------------------------------------------- synthetic logistic (Sec V)
def synthetic_logistic_dataset(n_samples: int = 26220, dim: int = 2048,
                               density: float = 0.01, seed: int = 0,
                               n_informative: int = 64):
    """Proxy for the one-hot-encoded Amazon Employee Access dataset: sparse
    binary features, a sparse ground-truth coefficient vector, label noise.
    (Shape/sparsity follow the paper's l=343474, N=26220 regime at a reduced
    ``dim``; the full-width dense matrix would be 36 GB and is never
    materialised.)"""
    rng = np.random.default_rng(seed)
    X = (rng.random((n_samples, dim)) < density).astype(np.float32)
    X[:, 0] = 1.0  # intercept
    beta = np.zeros(dim, np.float32)
    idx = rng.choice(dim, n_informative, replace=False)
    beta[idx] = rng.standard_normal(n_informative).astype(np.float32) * 4.0
    z = X @ beta + 0.5 * rng.standard_normal(n_samples).astype(np.float32)
    y = (z > np.median(z)).astype(np.int32)
    return X, y, beta
