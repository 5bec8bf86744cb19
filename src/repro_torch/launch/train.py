"""Coded-training launcher: the port's twin of ``python -m
repro.launch.train``, with the same flags and defaults.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
      --reduced --n-data 4 --d 3 --s 1 --m 2 --steps 20 --schedule gather

The ``n_data`` workers are one worker group on one device (the card by
default: ``--device cuda`` raises when there is none; ``--device cpu`` runs
the plain PyTorch versions).  The port runs a model axis of 1, so
``--n-model`` must be 1.

Flags of the port's own, after the reference's:

- ``--nproc P`` (default 1) splits the workers over ``P`` ranks
  (``repro_torch.comm.DistComm``), started by ``repro_torch.launch.ranks``
  with a file rendezvous; rank ``r`` runs on ``cuda:{r % cards}`` or on the
  host, with the caller's thread count, and computes the subsets of its
  workers ``[r n_data // P, (r + 1) n_data // P)`` (any ``P``: the blocks
  differ by at most one worker, and a rank past ``n_data`` holds none).  Every rank builds the same trainer from the same seeds
  and applies the same update; after the last step the ranks compare a
  digest of their parameters and optimizer state and raise if any two
  differ.  Rank 0 prints the step lines, the launcher the final line, so
  the output keeps its form (one line of rank-to-device mapping first).
- ``--dist-backend`` ``gloo`` or ``nccl`` (default: ``nccl`` on the card,
  ``gloo`` on the cpu); ``nccl`` with more ranks than cards is refused.
- ``--pipelined`` runs the stale-by-one pipelined step, fused with the
  update when the optimizer is ``sgd``, and drains it after the last step
  (the drain's metrics are the last entry of the returned logs).

A rank that fails ends its group at once, and a group still running
after ``RANKS_TIMEOUT`` seconds is stopped; either way the launcher exits
non-zero.

``main`` returns the per-step metrics; ``last_run`` then holds every rank's
report (``run_job``): its metrics, the digest, the collectives of each step,
its kernel launches and peak device memory.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import hashlib
from typing import Any, Mapping

#: every rank's report of the last ``main`` call (one entry for --nproc 1)
last_run: list[dict] | None = None
#: seconds a ``--nproc`` group may take before it is given up
RANKS_TIMEOUT = 1800.0


@dataclasses.dataclass(frozen=True)
class TrainJob:
    """One coded training run, as every rank builds it alike.

    ``code`` is ``(n, d, s, m)``; ``optimizer`` a name of
    ``repro_torch.optim.get_optimizer``; ``stragglers`` a straggler source
    (``repro_torch.tune``).  The batches are ``batches`` when given, else
    the synthetic stream of ``global_batch`` rows of ``seq`` tokens; the
    parameters start from ``params`` (numpy, the reference's tree) when
    given, else from the trainer's seed 0.  A pipelined spec is drained
    after the last step."""
    cfg: Any
    code: tuple
    optimizer: str
    lr: float
    spec: Any
    stragglers: Any
    steps: int
    global_batch: int = 0
    seq: int = 0
    batches: tuple | None = None
    params: Mapping | None = None
    keep_state: bool = False


_CHUNK = 1 << 22          # words a checksum chunk
_MIX = -7046029254386353131   # 0x9E3779B97F4A7C15 as a signed 64-bit word


def _checksum(t) -> int:
    """A position-weighted sum of a tensor's 32-bit words (16-bit for a
    2-byte type, bytes for a 1-byte one) in 64-bit wrapping arithmetic,
    computed where the tensor lies.  Every weight is odd, so a change of
    one word always changes the sum, and sums taken in any order agree."""
    import torch
    t = t.detach().contiguous().reshape(-1)
    size = t.element_size()
    words = t.view({1: torch.uint8, 2: torch.int16}.get(size, torch.int32))
    words = words.reshape(-1)
    idx = torch.arange(min(_CHUNK, words.numel()), dtype=torch.int64,
                       device=t.device)
    total = torch.zeros((), dtype=torch.int64, device=t.device)
    for start in range(0, words.numel(), _CHUNK):
        w = words[start:start + _CHUNK].to(torch.int64)
        total += (w * ((idx[:w.numel()] + start) * _MIX * 2 + 1)).sum()
    return int(total)


def state_digest(params: Mapping, opt_state: Mapping) -> str:
    """SHA-256 over every parameter and optimizer-state tensor's name,
    dtype, shape and ``_checksum``: replicas that differ in any one word of
    their state get different digests (a difference spread over several
    words could cancel only by a 2^-64 chance)."""
    h = hashlib.sha256()

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, Mapping):
                walk(v, f"{prefix}{k}/")
                continue
            h.update(f"{prefix}{k}:{v.dtype}:{tuple(v.shape)}:"
                     f"{_checksum(v)};".encode())

    walk(params, "params/")
    walk(opt_state, "opt_state/")
    return h.hexdigest()


def run_job(job: TrainJob, device, comm=None, *, log_every: int = 0,
            log_path: str | None = None) -> dict:
    """Build the job's ``Trainer`` on ``device`` (over ``comm``; default the
    single-process group), run it and return its report: ``logs`` (the
    per-step metrics), ``coded_fraction``, ``digest`` (``state_digest``),
    ``collectives`` (each step's counts and bytes), ``launches`` (the
    process's kernel launch counts), ``peak_bytes`` (the device's peak
    allocation, None on the cpu),
    ``workers`` and, with ``keep_state``, ``state`` (parameters and
    optimizer state as numpy trees)."""
    import torch

    from .. import convert
    from ..core import make_code
    from ..data import synthetic_lm_stream
    from ..kernels import ops
    from ..optim import get_optimizer
    from ..train import Trainer

    tr = Trainer(job.cfg, make_code(*job.code),
                 get_optimizer(job.optimizer, job.lr),
                 spec=job.spec,
                 # a copy: the job's source is drawn from afresh by each run
                 straggler_source=copy.deepcopy(job.stragglers),
                 device=device, comm=comm)
    if job.params is not None:
        tr.params = convert.params_from_jax(job.params, device=tr.device)
        tr.opt_state = tr.optimizer.init(tr.params)
    stream = (iter(job.batches) if job.batches is not None
              else synthetic_lm_stream(job.cfg, job.global_batch, job.seq))
    group = tr.arts.comm
    per_step = []
    step = tr.step

    def counted(batch):
        # each step's collectives, read around Trainer.step as run calls it
        group.reset_counts()
        out = step(batch)
        per_step.append({"counts": dict(group.counts),
                         "bytes": dict(group.bytes)})
        return out

    tr.step = counted
    logs = tr.run(stream, job.steps, log_every=log_every, log_path=log_path)
    if tr.pipelined:
        group.reset_counts()
        logs.append(tr.drain())
        per_step.append({"counts": dict(group.counts),
                         "bytes": dict(group.bytes)})
    dev = tr.device
    report = {
        "logs": logs, "coded_fraction": tr.arts.coded_fraction,
        "digest": state_digest(tr.params, tr.opt_state),
        "collectives": per_step, "launches": ops.launch_counts(),
        "paths": ops.path_counts(),
        "peak_bytes": (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else None),
        "workers": [group.workers.start, group.workers.stop],
        "device": str(dev)}
    if job.keep_state:
        report["state"] = {
            "params": convert.params_to_numpy(tr.params),
            "opt_state": convert.opt_state_to_numpy(tr.opt_state)}
    return report


def job_rank(rank: int, nproc: int, device, job: TrainJob,
             log_every: int = 0, log_path: str | None = None) -> dict:
    """One rank of a ``run_ranks`` group: run ``job`` over a ``DistComm``,
    then check that every rank ended with the same parameters and optimizer
    state.  Rank 0 prints the step lines and writes ``log_path``."""
    from ..comm import make_dist_comm
    comm = make_dist_comm(job.code[0], device=device)
    report = run_job(job, device, comm,
                     log_every=log_every if rank == 0 else 0,
                     log_path=log_path if rank == 0 else None)
    comm.check_same("the replicas' state digest", report["digest"])
    report.update(rank=rank, transport=comm.transport)
    return report


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """The launcher's flags from ``argv`` (default: the command line)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--n-data", type=int, default=4)
    ap.add_argument("--n-model", type=int, default=1)
    ap.add_argument("--d", type=int, default=3)
    ap.add_argument("--s", type=int, default=1)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--schedule", default="gather",
                    choices=["gather", "a2a", "psum"])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-per-subset", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--stragglers", default="random",
                    choices=["none", "random", "fixed"])
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks to split the n_data workers over")
    ap.add_argument("--dist-backend", default=None, choices=["gloo", "nccl"],
                    help="default: nccl on cuda, gloo on the cpu")
    ap.add_argument("--pipelined", action="store_true",
                    help="the pipelined step (fused with sgd), drained at "
                         "the end")
    args = ap.parse_args(argv)
    if args.n_model != 1:
        ap.error(f"--n-model {args.n_model}: the port runs one card with "
                 f"n_model = 1 (the model axis is not sharded)")
    return args


def make_job(args: argparse.Namespace) -> TrainJob:
    """The ``TrainJob`` the flags describe, as every rank runs it."""
    from .. import coding
    from ..configs import get_config
    from ..tune import FixedStragglers, NoStragglers, RandomStragglers

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    source = {"none": NoStragglers(), "random": RandomStragglers(seed=1),
              "fixed": FixedStragglers(())}[args.stragglers]
    spec = coding.SchemeSpec(schedule=args.schedule)
    if args.pipelined:
        spec = spec.replace(pipelined=True,
                            fuse_apply=args.optimizer == "sgd")
    return TrainJob(cfg=cfg, code=(args.n_data, args.d, args.s, args.m),
                    optimizer=args.optimizer, lr=args.lr, spec=spec,
                    stragglers=source, steps=args.steps,
                    global_batch=args.n_data * args.batch_per_subset,
                    seq=args.seq)


def _block_label(rank: int, n: int, nproc: int) -> str:
    """Rank ``rank``'s workers of ``n`` over ``nproc`` ranks, as ``DistComm``
    splits them: ``"a-b"``, ``"a"`` for one, ``"none"`` for an empty
    block."""
    lo, hi = rank * n // nproc, (rank + 1) * n // nproc
    return "none" if hi == lo else f"{lo}" if hi == lo + 1 else f"{lo}-{hi - 1}"


def main(argv: list[str] | None = None) -> list[dict]:
    """Parse ``argv`` (default: the command line), train, print the final
    loss line, and return the per-step metrics."""
    from .._device import resolve_device
    from ..comm import check_group
    from .ranks import rank_device, run_ranks

    global last_run
    args = parse_args(argv)
    device = resolve_device(args.device)
    job = make_job(args)
    log_every = max(1, args.steps // 10)
    if args.nproc == 1:
        last_run = [run_job(job, device, log_every=log_every,
                            log_path=args.log)]
    else:
        backend = args.dist_backend or ("nccl" if device.type == "cuda"
                                        else "gloo")
        check_group(args.nproc, backend, device)
        print(f"ranks {args.nproc} ({backend}): " + ", ".join(
            f"rank {r} on {rank_device(device, r)} workers "
            + _block_label(r, args.n_data, args.nproc)
            for r in range(args.nproc)), flush=True)
        if device.type == "cuda":
            from ..kernels import _build
            _build.build_once()   # one nvcc run for all ranks
        # the rank body by its module's own name: this file may be running
        # as __main__, whose functions a spawned rank cannot import
        import importlib
        body = importlib.import_module("repro_torch.launch.train").job_rank
        last_run = run_ranks(body, args.nproc,
                             args=(job, log_every, args.log), device=device,
                             backend=backend, timeout=RANKS_TIMEOUT)
    logs = last_run[0]["logs"]
    print(f"final loss {logs[-1]['loss']:.4f} "
          f"(coded fraction {last_run[0]['coded_fraction']:.3f})")
    return logs


if __name__ == "__main__":
    main()
