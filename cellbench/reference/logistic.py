"""Plain reference of the paper's Section V workload: logistic regression
(no l2 term, as the configuration runs it) over all the rows of a batch,
trained by NAG.

The loss of a batch is the sum over its rows of ``softplus(z) - y z`` with
``z = x beta``; its gradient ``x^T (sigmoid(z) - y)``.  Each is taken over
blocks of rows (one subset at a time), block sums added in float64.  A
coded step's reported loss is the mean of its subsets' losses; its decoded
gradient is the sum of theirs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .nag import NAG
from .ops import Products


def loss_and_grad(x, y, beta, subsets: int, products: Products):
    """The batch's mean subset loss (a float) and its gradient's sum."""
    prod = products.mm
    rows = x.shape[0] // subsets
    yf = y.to(torch.float32)
    loss, grad = 0.0, torch.zeros_like(beta)
    for j in range(subsets):
        xs, ys = x[j * rows:(j + 1) * rows], yf[j * rows:(j + 1) * rows]
        z = prod(xs, beta)
        loss += float(torch.sum(F.softplus(z) - ys * z))
        grad += prod(xs.T, torch.sigmoid(z) - ys)
    return loss / subsets, {"beta": grad}


def train(batch: dict, beta0: torch.Tensor, steps: int, lr: float,
          subsets: int, products: Products):
    """``steps`` NAG steps on one batch from ``beta0``: each step's loss,
    the first step's gradient, and the parameters after the last step."""
    params = {"beta": beta0}
    opt = NAG(lr, params)
    losses, first = [], None
    for _ in range(steps):
        loss, g = loss_and_grad(batch["x"], batch["y"], params["beta"],
                                subsets, products)
        losses.append(loss)
        first = g if first is None else first
        params = opt.step(params, g)
    return losses, first, params


def train_from_seed(c: dict, seed: int, device, steps: int,
                    products: Products, transform=None):
    """The configuration's first ``steps`` steps from its own inputs, made
    anew from the seed: ``(losses, first gradient, starting parameters,
    parameters after the steps)``.  ``transform(batch, subsets)`` changes
    the batch first (a fault planted for the control's measurements)."""
    from harness import inputs
    n = c["code"][0]
    batch = inputs.logistic_rows(n * c["train"]["rows_per_subset"],
                                 c["features"], seed, device)
    if transform is not None:
        batch = transform(batch, n)
    beta0 = torch.zeros((c["features"],), dtype=torch.float32, device=device)
    losses, first, last = train(batch, beta0, steps, c["train"]["lr"], n,
                                products)
    return losses, first, {"beta": beta0}, last
