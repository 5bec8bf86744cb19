"""Start, join and collect a group of ranks on this machine.

``run_ranks(fn, nproc, args=...)`` spawns ``nproc`` processes; rank ``r``
sets its thread count to the caller's, joins a ``torch.distributed`` group
through a file rendezvous in a fresh temporary directory (never a fixed TCP
port), calls ``fn(r, nproc, device, *args)`` and sends back what it
returns.  ``fn`` must be importable by name (a module-level function) and
return plain picklable values, not tensors.

Rank ``r`` runs on ``cuda:{r % torch.cuda.device_count()}`` for a cuda
device, on the host for ``"cpu"``.  The caller gives up at ``timeout``
seconds: a rank that raises, dies or hangs ends the whole group with an
error in the caller (the rank's traceback, its exit code, or the ranks still
running), and every process is stopped before ``run_ranks`` returns.
"""
from __future__ import annotations

import multiprocessing as mp
import pathlib
import pickle
import queue
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable

import torch

from .._device import resolve_device
from ..comm import check_group


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The device rank ``rank`` runs on: the host, or card ``rank %
    torch.cuda.device_count()``."""
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank, nproc, init_method, backend, device, threads, fn, args,
               out_q):
    import torch.distributed as dist
    sys.stdout.reconfigure(line_buffering=True)
    try:
        torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=nproc)
        msg = pickle.dumps((rank, True, fn(rank, nproc, dev, *args)))
    except BaseException:                     # noqa: BLE001 - sent home
        msg = pickle.dumps((rank, False, traceback.format_exc()))
    out_q.put(msg)
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(fn: Callable, nproc: int, *, args: tuple = (),
              device: str | torch.device = "cuda", backend: str | None = None,
              timeout: float = 600.0) -> list[Any]:
    """Run ``fn(rank, nproc, device, *args)`` on ``nproc`` spawned ranks and
    return their results in rank order.

    ``device`` defaults to the card and raises when there is none; pass
    ``"cpu"`` for the host.  ``backend`` defaults to ``"nccl"`` on a cuda
    device and ``"gloo"`` on the cpu; ``nccl`` with more ranks than cards is
    refused before anything starts (``comm.check_group``).  Raises
    ``RuntimeError`` when a rank fails or exits without a result and
    ``TimeoutError`` past ``timeout`` seconds."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    check_group(nproc, backend, dev)
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    rdv = pathlib.Path(tempfile.mkdtemp(prefix="repro_torch_ranks_"))
    init_method = (rdv / "rendezvous").as_uri()
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(r, nproc, init_method, backend, str(rank_device(dev, r)),
              torch.get_num_threads(), fn, tuple(args), out_q))
        for r in range(nproc)]
    results: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) < nproc:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(nproc)) - set(results))
                raise TimeoutError(f"ranks {late} of {nproc} gave no result "
                                   f"within {timeout} s")
            try:
                rank, ok, value = pickle.loads(out_q.get(timeout=min(left,
                                                                     0.5)))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r not in results and p.exitcode not in (None, 0):
                        raise RuntimeError(f"rank {r} of {nproc} exited with "
                                           f"code {p.exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {nproc} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.pid is None:                 # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(5)
        out_q.close()
        shutil.rmtree(rdv, ignore_errors=True)
    return [results[r] for r in range(nproc)]
