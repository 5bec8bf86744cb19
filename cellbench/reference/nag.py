"""Nesterov's accelerated gradient as the paper's Section V uses it
(Bubeck, Foundations and Trends in ML 8(3-4), 2015, section 3.7), in
float32 on parameter dicts:

    x_{t+1} = y_t - lr g(y_t)
    y_{t+1} = x_{t+1} + gamma_t (x_{t+1} - x_t),   gamma_t = (l_t - 1) / l_{t+1}
    l_0 = 0,  l_{t+1} = (1 + sqrt(1 + 4 l_t^2)) / 2,  x_0 = y_0

The carried parameters are ``y``.
"""
from __future__ import annotations

import math


class NAG:
    """The optimizer's state and its update."""

    def __init__(self, lr: float, params: dict):
        self.lr = float(lr)
        self.lam = 0.0
        self.x = {k: v.detach().clone() for k, v in params.items()}

    def step(self, y: dict, g: dict) -> dict:
        """The new ``y`` from the current ``y`` and its gradient ``g``."""
        lam_next = 0.5 * (1.0 + math.sqrt(1.0 + 4.0 * self.lam * self.lam))
        gamma = (self.lam - 1.0) / lam_next
        out = {}
        for k, yk in y.items():
            x_new = yk - self.lr * g[k]
            out[k] = x_new + gamma * (x_new - self.x[k])
            self.x[k] = x_new
        self.lam = lam_next
        return out
