"""The paper's own workload (Section V): l2-regularized logistic regression.
batch: {"x": (B, l) features, "y": (B,) in {0,1}}."""
from __future__ import annotations

import torch
import torch.nn.functional as F

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def init(cfg, device: str | torch.device = "cuda", generator=None):
    """All-zero ``beta`` of length ``cfg.d_model`` on ``device`` (the
    reference's initial point; ``generator`` is unused and kept for the
    uniform ``init`` signature)."""
    return {"beta": torch.zeros((cfg.d_model,), dtype=_DTYPES[cfg.param_dtype],
                                device=device)}


def logits(params, cfg, x):
    return x.to(torch.float32) @ params["beta"].to(torch.float32)


def loss(params, cfg, batch, l2: float = 0.0):
    z = logits(params, cfg, batch["x"])
    y = batch["y"].to(torch.float32)
    # sum (not mean): the paper's gradient is a sum over samples, which is
    # what the coded aggregation reconstructs exactly.
    nll = torch.sum(F.softplus(z) - y * z)
    if l2:
        nll = nll + 0.5 * l2 * torch.sum(params["beta"].to(torch.float32) ** 2)
    return nll


def predict_proba(params, cfg, x):
    return torch.sigmoid(logits(params, cfg, x))
