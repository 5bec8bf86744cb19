"""The plain PyTorch versions under the reference's oracle names: the ground
truth the kernels are held against (results in the input's dtype)."""
from __future__ import annotations

import torch

from .coded_decode import coded_decode_plain
from .coded_encode import coded_encode_plain


def coded_encode_ref(G: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """G (d, V, m), C (d, m) -> (V,): the transmitted vector f_i."""
    assert G.ndim == 3
    return coded_encode_plain(G, C)


def coded_decode_ref(F: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """F (n, V), W (n, m) -> (V, m): decoded groups."""
    assert F.ndim == 2
    return coded_decode_plain(F, W)


def coded_encode_batch_ref(G: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """Encode with a trailing dim: G (d, V, m, R), C (d, m) -> (V, R)."""
    assert G.ndim == 4
    return coded_encode_plain(G, C)


def coded_decode_batch_ref(F: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """Decode with a trailing dim: F (n, V, R), W (n, m) -> (V, m, R)."""
    assert F.ndim == 3
    return coded_decode_plain(F, W)
