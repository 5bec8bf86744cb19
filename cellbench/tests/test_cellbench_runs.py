"""Whole runs of the tiny cells on the CPU: the plain references agree with
the program, and each fault planted under the timed path makes ``correct``
false.  (The one-chip cells have no exchange between chips to leave out.)"""
from __future__ import annotations

import dataclasses

import pytest

import control
import run
import tiny

CELLS = list(tiny.CELLS)
TRAIN = [c for c in CELLS if ".train" in c]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_program(cell, tiny_root, cpu):
    r = run.run_cell(cell, 2**33 + 17, 0.2, False, device=cpu, root=tiny_root)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    for name, got in r["compared"].items():
        assert got["value"] <= 1e-4, (name, got)
    assert set(r["metrics"]) >= {"setup_s", "peak_mem_gib"}


def _unchanged_state(monkeypatch):
    from repro_torch.train import trainer
    build = trainer.make_coded_train_step

    def broken(*a, **kw):
        arts = build(*a, **kw)

        def step(params, opt_state, *rest):
            return params, opt_state, arts.step(params, opt_state, *rest)[2]
        return dataclasses.replace(arts, step=step)
    monkeypatch.setattr(trainer, "make_coded_train_step", broken)


def _half_batch(monkeypatch):
    from repro_torch.data import CodedBatcher
    place = CodedBatcher.place
    monkeypatch.setattr(CodedBatcher, "place", lambda self, batch: place(
        self, control.half_batch(batch, self.code.num_subsets)))


FAULTS = ([(c, "unchanged_state") for c in TRAIN]
          + [(c, "half_batch") for c in TRAIN])


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(cell, fault, tiny_root, cpu,
                                        monkeypatch):
    if fault == "unchanged_state":
        _unchanged_state(monkeypatch)
    else:
        _half_batch(monkeypatch)
    r = run.run_cell(cell, 41, 0.2, False, device=cpu, root=tiny_root)
    assert r["correct"] is False, r["compared"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_far_above_the_program(cell, tiny_root, cpu):
    """At the tiny size the control (products in TF32) reads at least ten
    times what the program does on the same seed, on one of the cell's
    numbers; its readings at the cells' own sizes, on the card, set the
    limits (PERF.md)."""
    from harness.manifest import load_cell, load_manifest
    prog = run.run_cell(cell, 9, 0.1, False, device=cpu, root=tiny_root)
    c = load_cell(load_manifest(tiny_root), cell, tiny_root)
    ctx = run.Context(c, 9, 0.0, False, cpu)
    rows = control.train_readings(ctx, 9)
    ctl = next(r for r in rows if r["variant"] == "control")
    assert any(ctl[k] >= 10 * max(v["value"], 1e-9)
               for k, v in prog["compared"].items())
