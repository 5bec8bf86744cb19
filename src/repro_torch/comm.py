"""The worker group: how ``n`` data-parallel workers exchange tensors.

The reference runs the workers as a ``shard_map`` over a device mesh
(``repro.launch.mesh.make_local_mesh(n, 1)``).  One GPU holds one process,
so the port's default group is a single process on one device: a per-worker
tensor carries a leading worker axis of size ``n``, and the collectives are
views of that axis — ``all_gather`` is the stack itself, ``all_to_all`` a
chunk transpose, ``psum`` a sum over axis 0.  In SPMD every worker would
receive the same gathered or summed value; here it exists once.

Every collective counts its calls (``Comm.counts``), which is how the tests
pin "O(1) collectives per wire bucket".  A ``torch.distributed`` group fits
behind the same three methods; the model axis has size 1.
"""
from __future__ import annotations

import torch

from ._device import resolve_device


class Comm:
    """Interface of a worker group of ``n`` workers on ``device``."""

    def __init__(self, n: int, device: torch.device):
        self.n = int(n)
        self.device = device
        self.counts = {"all_gather": 0, "all_to_all": 0, "psum": 0}

    def reset_counts(self) -> None:
        """Set every collective's call count to 0."""
        for k in self.counts:
            self.counts[k] = 0

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != self.n:
            raise ValueError(f"per-worker tensor needs leading axis "
                             f"n={self.n}, got shape {tuple(x.shape)}")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(n, *s) per-worker values -> the (n, *s) stack every worker gets."""
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(n, L, *s) per-worker buffers, ``n | L`` -> (n, n, L/n, *s):
        entry ``[p, q]`` is chunk ``p`` of worker ``q``'s buffer, i.e. row
        ``p`` is what worker ``p`` holds after the exchange."""
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """(n, *s) per-worker values -> their (*s) sum over the workers."""
        raise NotImplementedError


class LocalComm(Comm):
    """All ``n`` workers in this process, on one device."""

    def all_gather(self, x):
        self._check(x)
        self.counts["all_gather"] += 1
        return x.contiguous()

    def all_to_all(self, x):
        self._check(x)
        n, L = self.n, x.shape[1]
        if L % n:
            raise ValueError(f"all_to_all needs n | length, got {L} % {n}")
        self.counts["all_to_all"] += 1
        return (x.reshape(n, n, L // n, *x.shape[2:])
                .transpose(0, 1).contiguous())

    def psum(self, x):
        self._check(x)
        self.counts["psum"] += 1
        return x.sum(dim=0)


def make_local_comm(n: int, device: str | torch.device = "cuda") -> LocalComm:
    """The single-process group of ``n`` workers (the counterpart of the
    reference's ``make_local_mesh(n, 1)``).  ``device`` defaults to the card
    and raises when there is none; pass ``"cpu"`` for the host."""
    return LocalComm(n, resolve_device(device))
