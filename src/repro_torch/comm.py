"""The worker group: how ``n`` data-parallel workers exchange tensors.

The reference runs the workers as a ``shard_map`` over a device mesh
(``repro.launch.mesh.make_local_mesh(n, 1)``).  The port has two groups
behind one interface:

- ``LocalComm`` (the default): all ``n`` workers in one process on one
  device.  A per-worker tensor carries a leading worker axis of size ``n``,
  and the collectives are views of that axis — ``all_gather`` is the stack
  itself, ``all_to_all`` a chunk transpose, ``psum`` a sum over axis 0.  In
  SPMD every worker would receive the same gathered or summed value; here it
  exists once.
- ``DistComm``: the workers split in contiguous blocks over the ranks of a
  ``torch.distributed`` group (``make_dist_comm``), the counterpart of the
  reference's mesh execution.  Rank ``r`` of ``P`` computes only its own
  workers ``[r n // P, (r + 1) n // P)`` (``Comm.workers``), for any ``P``:
  the blocks differ by at most one worker, and a rank past ``n`` holds
  none but still takes part in every collective.  Its per-worker tensors
  carry those rows only, and the collectives are real ones between
  processes.  Every result is bitwise the one ``LocalComm`` gives on the
  same inputs: a gather is a copy, an all-to-all a permutation, and
  ``psum`` gathers the stack and sums it in ``LocalComm``'s own order
  (``all_reduce`` would sum in the backend's).

Every collective counts its calls (``Comm.counts``), which is how the tests
pin "O(1) collectives per wire bucket", and the bytes of its result that
one worker receives (``Comm.bytes``), the measure the reference's
``hlo_cost`` gives a collective.  The model axis has size 1.

Besides the wire, a group makes the few decisions that must come out the
same on every rank, none of them counted in ``counts`` or ``bytes``:
``step_wall`` (the slowest rank's wall, which a tuner records),
``check_same`` (a value every rank must hold alike, such as an adopted
plan or a restored step), ``is_root`` (the one rank that writes a
snapshot) and ``barrier``.  On ``LocalComm`` each is trivial.  ``rank``
and ``world_size`` say where the process stands (0 of 1 on ``LocalComm``):
``BatchedEngine`` splits its rows by them.  The
trainer and the server reach ``torch.distributed`` only through these.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from ._device import resolve_device

_KINDS = ("all_gather", "all_to_all", "psum")


class Comm:
    """Interface of a worker group of ``n`` workers on ``device``, of which
    this process computes ``workers`` (global indices, a contiguous
    ``range``)."""

    #: this process's place in the group of processes
    rank = 0
    world_size = 1

    def __init__(self, n: int, device: torch.device,
                 workers: range | None = None):
        self.n = int(n)
        self.device = device
        self.workers = range(self.n) if workers is None else workers
        self.counts = dict.fromkeys(_KINDS, 0)
        self.bytes = dict.fromkeys(_KINDS, 0)

    def reset_counts(self) -> None:
        """Set every collective's call count and byte count to 0."""
        for d in (self.counts, self.bytes):
            for k in d:
                d[k] = 0

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows (a view) of an ``(n, ...)`` tensor indexed by
        the global worker, such as the responder mask."""
        return x[self.workers.start:self.workers.stop]

    def _check(self, x: torch.Tensor) -> None:
        if x.shape[0] != len(self.workers):
            raise ValueError(f"per-worker tensor needs leading axis "
                             f"{len(self.workers)} (this process's workers "
                             f"of n={self.n}), got shape {tuple(x.shape)}")

    def _count(self, kind: str, out: torch.Tensor) -> None:
        """Count one call whose result is ``out``, ``(w, ...)`` with a row
        for each of this process's workers (``w`` may be 0), by the bytes
        of the row one worker receives."""
        self.counts[kind] += 1
        self.bytes[kind] += math.prod(out.shape[1:]) * out.element_size()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(w, *s) values of this process's w workers -> the (n, *s) stack
        every worker gets, row ``i`` from worker ``i``."""
        raise NotImplementedError

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """(w, L, *s) buffers of this process's w workers, ``n | L`` ->
        (w, n, L/n, *s): entry ``[p, q]`` is chunk ``workers[p]`` of worker
        ``q``'s buffer, i.e. row ``p`` is what worker ``workers[p]`` holds
        after the exchange."""
        raise NotImplementedError

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """(w, *s) values of this process's w workers -> the (*s) sum over
        all ``n`` workers."""
        raise NotImplementedError

    # ---- decisions made once for all ranks (not wire traffic: never in
    # ``counts`` or ``bytes``); every rank must call each at the same point
    @property
    def is_root(self) -> bool:
        """Whether this process is the group's first (the one that writes
        what the group writes once)."""
        return True

    def step_wall(self, seconds: float) -> float:
        """The slowest process's ``seconds``: a coded step or batch waits
        for its slowest process, and every process gets the same number
        (exact: a maximum does not depend on order)."""
        return float(seconds)

    def check_same(self, what: str, value: str) -> None:
        """Raise ``RuntimeError`` unless every process holds ``value``,
        naming ``what`` and the values by rank (every process raises)."""

    def barrier(self) -> None:
        """Return once every process has reached this call."""


class LocalComm(Comm):
    """All ``n`` workers in this process, on one device."""

    def all_gather(self, x):
        self._check(x)
        out = x.contiguous()
        self._count("all_gather", out[None])
        return out

    def all_to_all(self, x):
        self._check(x)
        n, L = self.n, x.shape[1]
        if L % n:
            raise ValueError(f"all_to_all needs n | length, got {L} % {n}")
        out = (x.reshape(n, n, L // n, *x.shape[2:])
               .transpose(0, 1).contiguous())
        self._count("all_to_all", out)
        return out

    def psum(self, x):
        self._check(x)
        out = x.sum(dim=0)
        self._count("psum", out[None])
        return out


def make_local_comm(n: int, device: str | torch.device = "cuda") -> LocalComm:
    """The single-process group of ``n`` workers (the counterpart of the
    reference's ``make_local_mesh(n, 1)``).  ``device`` defaults to the card
    and raises when there is none; pass ``"cpu"`` for the host."""
    return LocalComm(n, resolve_device(device))


class DistComm(Comm):
    """The ``n`` workers split over the ranks of the initialised default
    ``torch.distributed`` group: rank ``r`` of ``P`` computes workers
    ``[r n // P, (r + 1) n // P)``, for any ``P`` (``block(r)``).  A block
    may be empty (``P > n``): that rank holds no worker and still takes
    part in every collective.

    The tensors go to the backend as they are, on ``device``: ``gloo`` takes
    CUDA tensors for these collectives and moves them through the host
    itself, ``nccl`` keeps them on the card."""

    def __init__(self, n: int, device: torch.device):
        self.rank, self.world_size = dist.get_rank(), dist.get_world_size()
        super().__init__(n, device)
        self.workers = self.block(self.rank)
        self.backend = str(dist.get_backend())

    def block(self, rank: int) -> range:
        """The workers of rank ``rank``."""
        return range(rank * self.n // self.world_size,
                     (rank + 1) * self.n // self.world_size)

    @property
    def transport(self) -> str:
        """The backend, and where the tensors travel from."""
        return f"{self.backend}, {self.device.type} tensors handed over as is"

    def _gathered(self, x: torch.Tensor) -> torch.Tensor:
        """The (n, *s) stack of every rank's rows.  Equal blocks go straight
        into one buffer; uneven ones are padded to the largest block, and
        the padding rows are dropped after the gather."""
        P, rest = self.world_size, tuple(x.shape[1:])
        c = -(-self.n // P)                   # the largest block
        if c * P == self.n:                   # every block has c rows
            out = torch.empty((self.n, *rest), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x.contiguous())
            return out
        send = torch.zeros((c, *rest), dtype=x.dtype, device=x.device)
        send[:x.shape[0]] = x
        buf = torch.empty((P * c, *rest), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(buf, send)
        return torch.cat([buf[R * c:R * c + len(self.block(R))]
                          for R in range(P)])

    def all_gather(self, x):
        self._check(x)
        out = self._gathered(x)
        self._count("all_gather", out[None])
        return out

    def all_to_all(self, x):
        self._check(x)
        n, w, P, L = self.n, len(self.workers), self.world_size, x.shape[1]
        if L % n:
            raise ValueError(f"all_to_all needs n | length, got {L} % {n}")
        rest = tuple(x.shape[2:])
        sizes = [len(self.block(R)) for R in range(P)]
        # send[c, b] = chunk c of local worker b: the chunks of rank R's
        # workers are one run of rows, w_R * w of them; what arrives from
        # rank S is recv[a, b'] = chunk workers[a] of S's local worker b'
        send = (x.reshape(w, n, L // n, *rest).transpose(0, 1).contiguous()
                .reshape(n * w, L // n, *rest))
        recv = torch.empty((n * w, L // n, *rest), dtype=x.dtype,
                           device=x.device)
        dist.all_to_all_single(recv, send,
                               output_split_sizes=[w * k for k in sizes],
                               input_split_sizes=[k * w for k in sizes])
        parts = recv.split([w * k for k in sizes])
        out = torch.cat([p.reshape(w, k, L // n, *rest)
                         for p, k in zip(parts, sizes)], dim=1)
        self._count("all_to_all", out)
        return out

    def psum(self, x):
        self._check(x)
        # LocalComm's operation on the same (n, *s) stack: the same bits
        out = self._gathered(x).sum(dim=0)
        self._count("psum", out[None])
        return out

    @property
    def is_root(self):
        return self.rank == 0

    def step_wall(self, seconds):
        # gloo reduces a host tensor without a copy; nccl needs the card's
        dev = torch.device("cpu") if self.backend == "gloo" else self.device
        t = torch.tensor([float(seconds)], dtype=torch.float64, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return float(t.item())

    def check_same(self, what, value):
        values = [None] * self.world_size
        dist.all_gather_object(values, value)
        if len(set(values)) > 1:
            raise RuntimeError(
                f"the ranks disagree on {what}: "
                + "; ".join(f"rank {r}: {v}" for r, v in enumerate(values)))

    def barrier(self):
        dist.barrier()


def stack_rows(rows: list, shape: tuple, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """``torch.stack(rows)``: one value of shape ``shape`` for each of this
    process's workers, as the ``(w, *shape)`` tensor a collective takes;
    ``(0, *shape)`` on a rank that holds no worker."""
    if rows:
        return torch.stack(rows)
    return torch.zeros((0, *shape), dtype=dtype, device=device)


def check_group(world_size: int, backend: str,
                device: torch.device) -> None:
    """Refuse a group this port cannot run, before any process group is
    made: a world size below 1, ``nccl`` off the card, and ``nccl`` with
    more ranks than cards (NCCL refuses two ranks on one device; ``gloo``
    takes them).  Any world size splits any number of workers."""
    if world_size < 1:
        raise ValueError(f"a group needs at least one rank, not "
                         f"{world_size}")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("backend 'nccl' needs a cuda device; use "
                             "'gloo' on the cpu")
        cards = torch.cuda.device_count()
        if world_size > cards:
            raise ValueError(
                f"backend 'nccl' cannot put {world_size} ranks on {cards} "
                f"card(s): NCCL refuses two ranks on one device; use "
                f"backend 'gloo', which takes them")


def make_dist_comm(n: int, *, device: str | torch.device = "cuda",
                   backend: str | None = None, init_method: str | None = None,
                   rank: int | None = None,
                   world_size: int | None = None) -> DistComm:
    """This process's share of ``n`` workers over ``torch.distributed``.

    ``device`` defaults to the card and raises when there is none; pass
    ``"cpu"`` for the host.  ``backend`` defaults to ``"nccl"`` on a cuda
    device and ``"gloo"`` on the cpu.  When no default process group exists
    yet, one is made from ``init_method``, ``rank`` and ``world_size``
    (default: the ``RANK`` / ``WORLD_SIZE`` environment, as ``env://``
    reads it), after ``check_group`` has refused what cannot run; otherwise
    the existing group is taken (``repro_torch.launch.ranks`` makes one per
    rank)."""
    dev = resolve_device(device)
    if dist.is_initialized():
        have = str(dist.get_backend())
        if backend is not None and backend != have:
            raise ValueError(f"the process group runs {have!r}, not "
                             f"{backend!r}")
        check_group(dist.get_world_size(), have, dev)
    else:
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        ws = int(world_size if world_size is not None
                 else os.environ.get("WORLD_SIZE", 1))
        r = int(rank if rank is not None else os.environ.get("RANK", 0))
        check_group(ws, backend, dev)
        dist.init_process_group(backend, init_method=init_method, rank=r,
                                world_size=ws)
    return DistComm(n, dev)
