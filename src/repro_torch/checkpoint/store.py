"""Checkpointing: atomic npz snapshots of trees of tensors with step
management, in the reference's file layout.

- A tree is nested dicts (keys sorted at every level), lists and tuples
  (by index) with tensors or numpy arrays at the leaves; each leaf is
  stored under its path joined by ``"//"``, so a snapshot written by the
  reference (``repro/checkpoint/store.py``) restores here and the reverse.
  The port's flat ``"a/b"`` parameter dicts are nested first
  (``repro_torch.convert.unflatten``), as the ``Trainer`` does, so that
  their keys are the reference's byte for byte.
- bfloat16 leaves are stored as their 16-bit words with the numpy type
  ``|V2``, which is what ``np.savez`` makes of the reference's bfloat16
  arrays; they restore bit for bit into a bfloat16 leaf.
- Writes are atomic (tmp file + fsync + rename + directory fsync), so a
  preempted host never leaves a torn snapshot under the final name; where a
  filesystem reorders the rename ahead of the data anyway,
  ``CheckpointManager.restore_latest`` walks back past unreadable snapshots
  to the newest intact one.
- ``CheckpointManager`` keeps the newest ``keep`` steps and prunes only
  after the new snapshot reads back, so a failed save never costs an older
  good one.

Tensors on the card are copied to the host to be saved; ``restore_tree``
puts each leaf on its ``like`` leaf's device, in its type.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import tempfile
import warnings
import zipfile
import zlib
from typing import Any, Mapping

import numpy as np
import torch

Tree = Any

_SEP = "//"

#: Exceptions a torn/corrupt npz raises on open or decompress, the set
#: ``CheckpointManager.restore_latest`` treats as "fall back one step".  A
#: shape mismatch (ValueError from :func:`restore_tree`) is not here: that is
#: a caller bug (restoring into the wrong structure), not corruption.
TORN_CHECKPOINT_ERRORS = (zipfile.BadZipFile, EOFError, OSError,
                          zlib.error, KeyError)


def _leaves(tree: Tree, path: tuple = ()):
    """(path, leaf) pairs in the reference's order: dict keys sorted,
    sequences by index; ``None`` is an empty subtree."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _rebuild(tree: Tree, fn, path: tuple = ()):
    """``tree``'s structure with each leaf replaced by ``fn(path, leaf)``."""
    if isinstance(tree, Mapping):
        return {k: _rebuild(tree[k], fn, path + (str(k),)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, path + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as the array ``np.savez`` writes (bfloat16 as ``|V2`` words)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_tensor(arr: np.ndarray, like: torch.Tensor, key: str) -> torch.Tensor:
    """A stored array on ``like``'s device in ``like``'s type; raw 16-bit
    words go into a bfloat16 leaf bit for bit."""
    arr = np.asarray(arr, order="C")
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
            raise TypeError(f"leaf {key!r} holds raw {arr.dtype} words, which "
                            f"restore into bfloat16 only, not {like.dtype}")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def _fsync_dir(directory: pathlib.Path) -> None:
    """fsync a directory so a just-renamed entry survives power loss.

    Best-effort: some filesystems refuse O_RDONLY fsync on directories; the
    rename is still atomic there, only durability after a power cut
    degrades.
    """
    try:
        fd = os.open(directory, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save_tree(path: str | pathlib.Path, tree: Tree,
              metadata: dict | None = None) -> None:
    """Atomically and durably write a tree of tensors (+ JSON metadata).

    The write sequence is tmp file -> flush -> ``fsync(file)`` ->
    ``os.replace`` -> ``fsync(parent dir)``: without the first fsync the
    rename can land before the data blocks (a power cut then leaves a named
    torn file); without the second the rename itself may vanish on power
    loss (the old state simply persists).
    """
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    arrays = {_SEP.join(p): _to_numpy(v) for p, v in _leaves(tree)}
    if metadata:
        arrays["__metadata__"] = np.frombuffer(
            json.dumps(metadata).encode(), dtype=np.uint8)
    fd, tmp = tempfile.mkstemp(dir=path.parent, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(path.parent)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore_tree(path: str | pathlib.Path, like: Tree) -> tuple[Tree, dict]:
    """Restore into the structure of ``like`` (leaf paths must match).

    A tensor leaf of ``like`` gives a tensor on its device in its type (the
    stored bits where the types agree); another leaf gives the stored numpy
    array.  A missing leaf raises KeyError, a shape that differs ValueError.
    """
    with np.load(path) as data:
        meta = {}
        if "__metadata__" in data:
            meta = json.loads(bytes(data["__metadata__"]).decode())

        def leaf(p, ref):
            key = _SEP.join(p)
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"shape mismatch at {key!r}: "
                                 f"{arr.shape} vs {tuple(ref.shape)}")
            if isinstance(ref, torch.Tensor):
                return _to_tensor(arr, ref, key)
            return arr

        return _rebuild(like, leaf), meta


class CheckpointManager:
    """Step-numbered checkpoints with retention and torn-file fallback."""

    _RE = re.compile(r"ckpt_(\d+)\.npz$")

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        """``keep`` newest snapshots are retained; must be >= 1 (``keep=0``
        would delete every checkpoint right after writing it: the
        ``list[:-0] == list`` footgun)."""
        if int(keep) < 1:
            raise ValueError(
                f"keep must be >= 1, got {keep}: retention would delete "
                f"every checkpoint immediately after writing it")
        self.dir = pathlib.Path(directory)
        self.keep = int(keep)
        self.dir.mkdir(parents=True, exist_ok=True)

    def _step_path(self, step: int) -> pathlib.Path:
        return self.dir / f"ckpt_{step:08d}.npz"

    def steps(self) -> list[int]:
        """The saved steps, oldest first."""
        out = []
        for f in self.dir.glob("ckpt_*.npz"):
            m = self._RE.search(f.name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def save(self, step: int, tree: Tree, metadata: dict | None = None) -> None:
        """Write the step snapshot, verify it reads back, then prune.

        The verification open (the zip directory only, no array data) and
        the prune order together keep the newest retained snapshots
        readable: a save that fails to land never deletes the older ones a
        resume would need.
        """
        md = dict(metadata or {})
        md["step"] = step
        path = self._step_path(step)
        save_tree(path, tree, md)
        with np.load(path) as data:   # verify before pruning old steps
            data.files
        for s in self.steps()[:-self.keep]:
            self._step_path(s).unlink(missing_ok=True)

    def latest_step(self) -> int | None:
        """The newest saved step (readable or not), or None."""
        s = self.steps()
        return s[-1] if s else None

    def restore_latest(self, like: Tree) -> tuple[Tree, dict] | None:
        """Restore the newest readable checkpoint (or None if there is none).

        Snapshots are tried newest first; one that fails to open or
        decompress (:data:`TORN_CHECKPOINT_ERRORS`, or numpy's ValueError
        for content it does not recognise) is skipped with a warning and the
        next older step is tried.  A shape mismatch still raises: the
        caller's ``like`` is wrong, and resuming an older compatible
        snapshot would hide that.
        """
        last_err: Exception | None = None
        for s in reversed(self.steps()):
            try:
                return restore_tree(self._step_path(s), like)
            except TORN_CHECKPOINT_ERRORS + (ValueError,) as e:
                if (isinstance(e, ValueError)
                        and str(e).startswith("shape mismatch")):
                    raise
                warnings.warn(
                    f"checkpoint step {s} unreadable "
                    f"({type(e).__name__}: {e}); falling back to the "
                    f"previous step", stacklevel=2)
                last_err = e
        if last_err is not None:
            warnings.warn("no readable checkpoint found; starting fresh",
                          stacklevel=2)
        return None
