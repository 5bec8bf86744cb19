"""The port's training launcher, ``python -m repro_torch.launch.train``:
the reference's flags and defaults (plus ``--device``), the reference
launcher's losses and final line on the same flags, and the same losses,
bit for bit, as a port ``Trainer`` driven by hand with the same arguments.
It runs on the card unless ``--device cpu`` asks for the host, and refuses a
model axis other than 1."""
import ast
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.launch.train as jlaunch
import repro.train as jtrain
import repro.train.trainer as jtrainer_mod
import repro_torch.train.trainer as ttrainer_mod
import repro_torch.configs as tconfigs
import repro_torch.launch.train as tlaunch
from repro_torch import coding
from repro_torch.core import make_code
from repro_torch.data import synthetic_lm_stream
from repro_torch.optim import get_optimizer
from repro_torch.train import Trainer
from repro_torch.tune import FixedStragglers, NoStragglers, RandomStragglers

torch.set_num_threads(1)

_get_config = tconfigs.get_config
_jget_config = jconfigs.get_config


def _flags(module):
    """Every ``add_argument`` call of a module, as (args, keywords) dumps."""
    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            out.append((tuple(a.value for a in node.args),
                        tuple((k.arg, ast.dump(k.value))
                              for k in node.keywords)))
    return out


def test_flags_and_defaults_are_the_references():
    """The reference's flags, in its order and with its defaults, then the
    port's own: the device, and the rank group's and pipeline's flags."""
    port, ref = _flags(tlaunch), _flags(jlaunch)
    assert port[:len(ref)] == ref
    assert [f[0] for f in port[len(ref):]] == [
        ("--device",), ("--nproc",), ("--dist-backend",), ("--pipelined",)]


def _by_hand(arch, reduced, n_data, d, s, m, schedule, steps, bps, seq, lr,
             optimizer, stragglers):
    """A port ``Trainer`` built and run as the launcher says it is."""
    cfg = tconfigs.get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    source = {"none": NoStragglers(), "random": RandomStragglers(seed=1),
              "fixed": FixedStragglers(())}[stragglers]
    tr = Trainer(cfg, make_code(n_data, d, s, m),
                 get_optimizer(optimizer, lr),
                 spec=coding.SchemeSpec(schedule=schedule),
                 straggler_source=source, device="cpu")
    logs = tr.run(synthetic_lm_stream(cfg, n_data * bps, seq), steps,
                  log_every=0)
    return logs, tr


def _bitwise(a, b):
    for ma, mb in zip(a, b, strict=True):
        for k in ("loss", "grad_norm"):
            assert np.float64(ma[k]).tobytes() == np.float64(mb[k]).tobytes()


def test_reduced_lm_equals_a_trainer_by_hand(capsys, tmp_path):
    log = tmp_path / "log.json"
    logs = tlaunch.main(["--steps", "2", "--device", "cpu",
                         "--log", str(log)])
    out = capsys.readouterr().out
    want, tr = _by_hand("qwen3-1.7b", True, 4, 3, 1, 2, "gather", 2, 2, 64,
                        3e-4, "adamw", "random")
    _bitwise(logs, want)
    assert out.splitlines()[-1] == (f"final loss {want[-1]['loss']:.4f} "
                                    f"(coded fraction "
                                    f"{tr.arts.coded_fraction:.3f})")
    assert [m["loss"] for m in json.loads(log.read_text())] == \
        [m["loss"] for m in logs]


@pytest.mark.parametrize("schedule,stragglers", [("gather", "random"),
                                                 ("a2a", "none"),
                                                 ("psum", "fixed")])
def test_logistic_equals_a_trainer_by_hand(monkeypatch, capsys, schedule,
                                           stragglers):
    """``logistic-paper`` at d_model = 32 with the chip's flags otherwise."""
    monkeypatch.setattr(tconfigs, "get_config", lambda name: dataclasses.replace(
        _get_config(name), d_model=32))
    logs = tlaunch.main(["--arch", "logistic-paper", "--full", "--n-data",
                         "8", "--d", "4", "--s", "2", "--m", "2",
                         "--batch-per-subset", "4", "--steps", "5",
                         "--optimizer", "nag", "--lr", "1e-2",
                         "--stragglers", stragglers, "--schedule", schedule,
                         "--device", "cpu"])
    want, tr = _by_hand("logistic-paper", False, 8, 4, 2, 2, schedule, 5, 4,
                        64, 1e-2, "nag", stragglers)
    _bitwise(logs, want)
    assert len(logs) == 5 and np.isfinite([m["loss"] for m in logs]).all()
    assert capsys.readouterr().out.splitlines()[-1].endswith(
        "(coded fraction 1.000)")


_LOGISTIC = ["--arch", "logistic-paper", "--full", "--n-data", "8", "--d",
             "4", "--s", "2", "--m", "2", "--batch-per-subset", "4",
             "--steps", "5", "--optimizer", "nag", "--lr", "1e-2"]


@pytest.mark.parametrize("schedule,stragglers", [("gather", "random"),
                                                 ("a2a", "none"),
                                                 ("psum", "fixed")])
def test_logistic_follows_the_reference_launcher(monkeypatch, capsys,
                                                 schedule, stragglers):
    """Both launchers on the same flags, ``logistic-paper`` at d_model = 32
    (beta starts at zero in both packages, so no weights are carried
    across): the reference on the 8-device host mesh, the port on the CPU.
    Each step's stragglers and decode inputs are equal, each step's loss
    and grad norm agree, and so does the final line."""
    flags = _LOGISTIC + ["--stragglers", stragglers, "--schedule", schedule]
    seen = {"jax": [], "torch": []}
    for side, mod in (("jax", jtrainer_mod), ("torch", ttrainer_mod)):
        def rec(code, stragglers=(), *a, _orig=mod.make_step_inputs,
                _side=side, **kw):
            out = _orig(code, stragglers, *a, **kw)
            seen[_side].append((tuple(int(i) for i in stragglers),
                                {k: np.asarray(v).copy()
                                 for k, v in out.items()}))
            return out
        monkeypatch.setattr(mod, "make_step_inputs", rec)
    monkeypatch.setattr(tconfigs, "get_config", lambda name: dataclasses.replace(
        _get_config(name), d_model=32))
    monkeypatch.setattr(jconfigs, "get_config", lambda name: dataclasses.replace(
        _jget_config(name), d_model=32))
    jlogs = []
    jrun = jtrain.Trainer.run

    def run(self, *a, **k):
        jlogs.extend(jrun(self, *a, **k))
        return jlogs

    monkeypatch.setattr(jtrain.Trainer, "run", run)
    monkeypatch.setattr(sys, "argv", ["train.py"] + flags)
    jlaunch.main()
    jline = capsys.readouterr().out.splitlines()[-1]
    logs = tlaunch.main(flags + ["--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == jline
    assert len(jlogs) == len(logs) == 5
    assert len(seen["jax"]) == len(seen["torch"]) == 5
    for (js, ji), (ts, ti) in zip(seen["jax"], seen["torch"]):
        assert ts == js and ti.keys() == ji.keys()
        for k in ji:
            np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
    if stragglers == "random":
        assert any(js for js, _ in seen["jax"])
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[k] for m in logs],
                                   [float(m[k]) for m in jlogs],
                                   rtol=1e-4, atol=1e-5)


def test_olmoe_follows_the_reference_launcher(monkeypatch, capsys):
    """``--arch olmoe-1b-7b`` (reduced) on both launchers with the default
    flags otherwise: the port's trainer starts from the reference's
    parameters (its seed-0 ``init``, carried across with ``convert``); each
    step's stragglers and decode inputs are equal, the losses agree at rtol
    1e-4, and so does the final line."""
    import jax
    import repro.models.api as japi
    import repro_torch.models.api as tapi
    from repro_torch import convert

    jcfg = _jget_config("olmoe-1b-7b").reduced()
    start = jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(0), jcfg))
    monkeypatch.setattr(tapi, "init", lambda cfg, device, gen=None:
                        convert.params_from_jax(start, device=device))
    seen = {"jax": [], "torch": []}
    for side, mod in (("jax", jtrainer_mod), ("torch", ttrainer_mod)):
        def rec(code, stragglers=(), *a, _orig=mod.make_step_inputs,
                _side=side, **kw):
            out = _orig(code, stragglers, *a, **kw)
            seen[_side].append((tuple(int(i) for i in stragglers),
                                {k: np.asarray(v).copy()
                                 for k, v in out.items()}))
            return out
        monkeypatch.setattr(mod, "make_step_inputs", rec)
    jlogs = []
    jrun = jtrain.Trainer.run

    def run(self, *a, **k):
        jlogs.extend(jrun(self, *a, **k))
        return jlogs

    flags = ["--arch", "olmoe-1b-7b", "--steps", "2"]
    monkeypatch.setattr(jtrain.Trainer, "run", run)
    monkeypatch.setattr(sys, "argv", ["train.py"] + flags)
    jlaunch.main()
    jline = capsys.readouterr().out.splitlines()[-1]
    logs = tlaunch.main(flags + ["--device", "cpu"])
    assert capsys.readouterr().out.splitlines()[-1] == jline
    assert len(jlogs) == len(logs) == len(seen["jax"]) == len(seen["torch"]) \
        == 2
    for (js, ji), (ts, ti) in zip(seen["jax"], seen["torch"]):
        assert ts == js and ti.keys() == ji.keys()
        for k in ji:
            np.testing.assert_array_equal(ti[k], ji[k], err_msg=k)
    np.testing.assert_allclose([m["loss"] for m in logs],
                               [float(m["loss"]) for m in jlogs], rtol=1e-4)
    assert jline.startswith("final loss ") and jline.endswith(
        "(coded fraction 1.000)")


def test_model_axis_other_than_one_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--n-model", "2", "--device", "cpu"])
    assert e.value.code == 2
    assert "n_model = 1" in capsys.readouterr().err


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tlaunch.main(["--steps", "1"])
