"""The comparison that decides ``correct``: numbers read from the program's
output against the plain reference's, each held to a limit of its own.

Norms are taken in float64 over float32 leaves, in chunks so that no float64
copy of a whole leaf is made.
"""
from __future__ import annotations

import dataclasses
import statistics

import torch

CHUNK = 1 << 26          # elements a float64 chunk


@dataclasses.dataclass(frozen=True)
class Reading:
    """One compared number and its limit; it passes at or under the limit
    (a NaN never does)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


def leaf_norm(a: torch.Tensor, b: torch.Tensor | None = None) -> float:
    """``||a||`` or ``||a - b||`` in float64, on ``b``'s device where ``a``
    is elsewhere (a copy kept on the host)."""
    fa = a.detach().reshape(-1)
    fb = None if b is None else b.detach().reshape(-1)
    dev = fa.device if fb is None else fb.device
    total = torch.zeros((), dtype=torch.float64, device=dev)
    for i in range(0, fa.numel(), CHUNK):
        x = fa[i:i + CHUNK].to(device=dev, dtype=torch.float64)
        if fb is not None:
            x = x - fb[i:i + CHUNK].double()
        total += torch.dot(x, x)
    return float(total.sqrt())


def first_gradient(y0: dict, x1: dict, lr: float) -> dict:
    """The first gradient as NAG applied it, ``(y_0 - x_1) / lr`` (the
    difference taken in float64), as float32 leaves on the host: kept
    there, it adds nothing to the card's memory until it is compared."""
    out = {}
    for k, a in y0.items():
        fa, fb = a.detach().reshape(-1), x1[k].detach().reshape(-1)
        g = torch.empty(fa.shape, dtype=torch.float32)
        for i in range(0, fa.numel(), CHUNK):
            g[i:i + CHUNK] = ((fa[i:i + CHUNK].double()
                               - fb[i:i + CHUNK].double()) / lr).float().cpu()
        out[k] = g.view(a.shape)
    return out


def norms(a: dict, b: dict | None = None) -> dict[str, float]:
    """Per leaf, ``||a||`` or ``||a - b||``."""
    return {k: leaf_norm(v, None if b is None else b[k]) for k, v in a.items()}


def worst(gaps: dict[str, float], ref: dict[str, float], floor: float = 1e-3
          ) -> tuple[float, str, list[str]]:
    """The worst of per-leaf ``gaps`` (absolute), each over the larger of
    that leaf's reference norm and the median leaf's; leaves whose reference
    norm is under ``floor`` times the median leaf's are left out (their
    gradient is nought to rounding).  Returns the gap, its leaf and the
    leaves left out."""
    med = statistics.median(ref.values())
    left_out = sorted(k for k, r in ref.items() if r < floor * med)
    worst, leaf = 0.0, ""
    for k, r in ref.items():
        if k in left_out:
            continue
        gap = gaps[k] / max(r, med)
        if gap != gap:                  # a NaN is the worst there is
            return gap, k, left_out
        if gap > worst:
            worst, leaf = gap, k
    return worst, leaf, left_out


def norm_gap(prog: dict[str, float], ref: dict[str, float],
             floor: float = 1e-3) -> tuple[float, str, list[str]]:
    """The worst leaf's gap between the program's norm and the reference's
    (``worst``)."""
    return worst({k: abs(prog[k] - r) for k, r in ref.items()}, ref, floor)


def diffs(prog: dict, ref: dict) -> dict[str, float]:
    """Per leaf, the norm of the difference between the program's tensors
    and the reference's (absolute; ``worst`` scales them)."""
    return {k: leaf_norm(prog[k], ref[k]) for k in ref}


def rel_gap(prog: float, ref: float) -> float:
    """``|prog - ref| / |ref|``."""
    return abs(prog - ref) / abs(ref)
