"""Move parameters and optimizer state between the reference's pytrees (as
trees of numpy arrays) and the port's flat dicts of tensors, so that a test
puts the same state through both packages.  Nothing here imports the
reference: the caller hands over numpy.

A nested dict flattens to ``"a/b/c"`` keys in the reference's own leaf
order (dict keys sorted at every level), which is the order the codec's
slot tables index.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ._device import resolve_device


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def flatten(tree: Mapping[str, Any]) -> dict:
    """Nested dict -> flat ``{"a/b": leaf}`` in the reference's leaf order."""
    return dict(_flatten(tree))


def _unflatten(flat: Mapping[str, Any]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        node = out
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def _tensor(x, device) -> torch.Tensor:
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":       # ml_dtypes array: go through f32
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


def params_from_jax(tree: Mapping[str, Any],
                    device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Tree of numpy arrays -> flat ``{"a/b": Tensor}`` on ``device``
    (default: the card; raises when there is none)."""
    dev = resolve_device(device)
    return {k: _tensor(v, dev) for k, v in _flatten(tree)}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> dict:
    """Flat dict of tensors -> nested tree of numpy arrays."""
    return _unflatten({k: _numpy(v) for k, v in params.items()})


# the sub-trees of each optimizer's state that mirror the parameter tree
_PARAM_SHAPED = ("x_prev", "mu", "m", "v")


def opt_state_from_jax(state: Mapping[str, Any],
                       device: str | torch.device = "cuda") -> dict:
    """Optimizer state of the reference (NAG ``x_prev``/``lam``, SGD ``mu``,
    AdamW ``m``/``v``/``t``) as numpy -> the port's state on ``device``
    (default: the card; raises when there is none)."""
    device = resolve_device(device)
    out = {}
    for k, v in state.items():
        out[k] = (params_from_jax(v, device) if k in _PARAM_SHAPED
                  else _tensor(v, device))
    return out


def opt_state_to_numpy(state: Mapping[str, Any]) -> dict:
    """The inverse of ``opt_state_from_jax``."""
    return {k: (params_to_numpy(v) if k in _PARAM_SHAPED else _numpy(v))
            for k, v in state.items()}
