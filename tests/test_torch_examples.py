"""The port's twins of the reference's four examples
(``examples/*_torch.py``), each ``run(device="cpu")`` held against the
reference's public API on the same inputs (the reference's ``Trainer`` on a
host mesh ``make_local_mesh(n, 1)``, its ``BatchedEngine``; never its
scripts), at small sizes:

- ``logistic_amazon``: the three (d, s, m) triples and the simulated
  ``cum_time`` exactly, each scheme's ``beta`` at every iteration at the
  trajectory tolerance of ``test_torch_step.py`` (rtol=1e-4, atol=1e-5),
  each AUC within 1e-3;
- ``quickstart``: ``describe()``, the hetero loads and ``coded_fraction``
  exactly, every loss and the partial step's error bound at the trajectory
  tolerance, with the reference's seed-0 weights carried across by
  ``convert.params_from_jax``, and the auto-tuner's events exactly, on
  the reduced ``qwen3-1.7b`` the twin runs (fewer steps and tokens).  A
  tuner ranks with measured step walls, so both trainer modules read one
  fake clock here that makes every step wall 10 ms;
- ``train_lm_coded``: both configs' fields equal those the reference
  builds (its ``dataclasses.replace`` keywords read from its source);
- ``serve_batched``: with the weights carried across, the greedy tokens of
  the reduced ``qwen3-1.7b`` equal the reference engine's.

Also: the twin's ``auc_score`` against a pairwise count, the flags and
defaults against the reference's, and ``main([])`` refusing to run on a
machine without a card."""
import ast
import dataclasses
import functools
import importlib.util
import pathlib
import time

import jax
import numpy as np
import pytest
import torch

import repro.coding as jc
import repro.core as jcore
import repro.core.runtime_model as jrm
import repro.data as jdata
import repro.optim as joptim
import repro.train.trainer as jtrainer_mod
import repro.tune as jtune
import repro_torch.train.trainer as ttrainer_mod
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_local_mesh
from repro.models import api as japi
from repro.serving.engine import BatchedEngine as JEngine
from repro.train import Trainer as JTrainer
import repro_torch.coding as tcoding
import repro_torch.core as tcore
import repro_torch.optim as toptim
import repro_torch.tune as ttune
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.train import Trainer as TTrainer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("logistic_amazon", "quickstart", "train_lm_coded", "serve_batched")
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)


def _twin(name):
    """Import ``examples/<name>_torch.py`` by path (examples is no
    package)."""
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pairwise_auc(y, score):
    """AUC as the share of (positive, negative) pairs ranked right, a tie
    counting 1/2: every one of the n1 * n0 pairs compared."""
    pos, neg = score[y == 1][:, None], score[y != 1][None, :]
    if pos.size == 0 or neg.size == 0:
        return 0.5
    wins = (pos > neg).sum() + 0.5 * (pos == neg).sum()
    return float(wins / (pos.size * neg.size))


# ------------------------------------------------------------------ auc_score
@pytest.mark.parametrize("case", ["distinct", "ties", "one_class", "constant"])
def test_auc_score_is_the_pairwise_count(case):
    rng = np.random.default_rng(3)
    y = (rng.random(60) < 0.4).astype(np.int32)
    score = {"distinct": rng.standard_normal(60),
             "ties": rng.integers(0, 5, 60).astype(np.float64),
             "one_class": rng.standard_normal(60),
             "constant": np.ones(60)}[case]
    if case == "one_class":
        y = np.ones(60, np.int32)
    got = _twin("logistic_amazon").auc_score(y, score)
    assert got == pytest.approx(_pairwise_auc(y, score), abs=1e-12)


# ------------------------------------------------------------ logistic_amazon
# the reference's default width: a test row's score sums about ten
# features, so scores rarely tie.  At a narrow width (dim 96, two features a
# row) most scores tie, and a feature whose labels balance has a gradient of
# exactly 0 at beta = 0 on one side and a 1e-10 residue of the m = 2 decode
# on the other: tied pairs split and that AUC moves by 1.2e-3, with every
# beta within the trajectory tolerance
LA = dict(iters=4, dim=1024, samples=1024, n=4, lr=2.0)


def _reference_logistic(X, y, iters, dim, n, lr):
    """The reference example's loop through the reference's API (on the
    ``ref`` backend): per scheme the ``beta`` of every iteration and the
    simulated ``cum_time``, and the triples."""
    ntr = int(len(X) * 0.75)
    Xtr, ytr = X[:ntr], y[:ntr]
    cfg = dataclasses.replace(jget_config("logistic-paper"), d_model=dim)
    params_rt = jrm.RuntimeParams(n=n, lambda1=0.5, lambda2=0.2, t1=0.5,
                                  t2=16.0)
    (d1, s1, m1), _ = jrm.optimal_triple(params_rt, npts=30_000,
                                         restrict_m1=True)
    (d2, s2, m2), _ = jrm.optimal_triple(params_rt, npts=30_000)
    schemes = {
        "naive": (jcore.make_code(n, 1, 0, 1), "psum", jtune.NoStragglers()),
        f"m1_d{d1}": (jcore.make_code(n, d1, s1, m1), "gather",
                      jtune.RandomStragglers(seed=1)),
        f"ours_d{d2}m{m2}": (jcore.make_code(n, d2, s2, m2), "gather",
                             jtune.RandomStragglers(seed=1)),
    }
    mesh = make_local_mesh(n, 1)
    gb = ntr - ntr % n
    batch = {"x": Xtr[:gb].astype(np.float32), "y": ytr[:gb]}
    out = {"triples": {"m1": (d1, s1, m1), "ours": (d2, s2, m2)}}
    for name, (code, schedule, source) in schemes.items():
        tr = JTrainer(cfg, code, mesh, joptim.get_optimizer("nag", lr / gb),
                      spec=jc.SchemeSpec(schedule=schedule, backend="ref"),
                      straggler_source=source)
        betas = []
        for _ in range(iters):
            tr.step(batch)
            betas.append(np.asarray(tr.params["beta"], np.float64))
        times = jrm.simulate_runtimes(params_rt, code.d, code.s, code.m,
                                      iters, seed=1)
        if name == "naive":
            rng = np.random.default_rng(1)
            times = (params_rt.t1 + rng.exponential(1 / params_rt.lambda1,
                                                    (iters, n))
                     + params_rt.t2 + rng.exponential(1 / params_rt.lambda2,
                                                      (iters, n))
                     ).max(axis=1)
        out[name] = {"betas": np.stack(betas),
                     "cum_time": np.cumsum(times).tolist()}
    return out


@functools.lru_cache(maxsize=None)
def _logistic_pair():
    if len(jax.devices()) < LA["n"]:
        pytest.skip(f"needs {LA['n']} devices")
    X, y, _ = jdata.synthetic_logistic_dataset(LA["samples"], LA["dim"],
                                               seed=0)
    ref = _reference_logistic(X, y, LA["iters"], LA["dim"], LA["n"],
                              LA["lr"])
    got = _twin("logistic_amazon").run(device="cpu", keep_betas=True, **LA)
    return X, y, ref, got


def test_logistic_triples_and_schemes_are_the_references():
    _, _, ref, got = _logistic_pair()
    assert got["triples"] == ref["triples"]
    assert list(got["results"]) == [k for k in ref if k != "triples"]


@pytest.mark.parametrize("scheme", [0, 1, 2])
def test_logistic_cum_time_is_bitwise_the_references(scheme):
    _, _, ref, got = _logistic_pair()
    name = list(got["results"])[scheme]
    assert got["results"][name]["cum_time"] == ref[name]["cum_time"]


@pytest.mark.parametrize("scheme", [0, 1, 2])
def test_logistic_beta_follows_the_reference_every_iteration(scheme):
    _, _, ref, got = _logistic_pair()
    name = list(got["results"])[scheme]
    betas = got["schemes"][name]["betas"]
    assert betas.shape == (LA["iters"], LA["dim"])
    for it in range(LA["iters"]):
        np.testing.assert_allclose(betas[it], ref[name]["betas"][it],
                                   err_msg=f"{name} iteration {it}",
                                   **TRAJ_TOL)
    np.testing.assert_array_equal(got["schemes"][name]["beta"], betas[-1])


@pytest.mark.parametrize("scheme", [0, 1, 2])
def test_logistic_auc_follows_the_reference(scheme):
    X, y, ref, got = _logistic_pair()
    ntr = int(len(X) * 0.75)
    Xte, yte = X[ntr:], y[ntr:]
    name = list(got["results"])[scheme]
    want = [_pairwise_auc(yte, Xte @ b) for b in ref[name]["betas"]]
    np.testing.assert_allclose(got["results"][name]["auc"], want, atol=1e-3)
    assert got["results"]["naive"]["auc"][0] == 0.5   # NAG's first step


def test_logistic_target_and_out_file(tmp_path):
    """The target and each time to it follow from the results as the
    reference computes them; ``out`` holds the reference's schema."""
    out = tmp_path / "sub" / "logistic_amazon_torch.json"
    got = _twin("logistic_amazon").run(device="cpu", out=str(out), **LA)
    res = got["results"]
    naive = res["naive"]["auc"]
    assert got["target"] == 0.5 * (naive[0] + max(naive))
    for name, r in res.items():
        hit = [t for a, t in zip(r["auc"], r["cum_time"])
               if a >= got["target"]]
        assert got["time_to_target"][name] == hit[0]
    import json
    assert json.loads(out.read_text()) == res
    assert got["schemes"]["naive"]["launches"] == {
        k: 0 for k in got["schemes"]["naive"]["launches"]}   # plain versions


# ----------------------------------------------------------------- quickstart
# 15 tuned steps: the tuner re-plans after steps 4, 9 and 14, the last one
# after the drift at step 10
QS = dict(steps=3, hetero_steps=2, autotune_steps=15, global_batch=8,
          seq_len=16)
STEP_WALL_S = 0.01


class _Clock:
    """``time`` for a trainer module: ``perf_counter`` advances by
    ``STEP_WALL_S / 2`` a call (a step reads it twice), ``time`` is the
    wall clock."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += STEP_WALL_S / 2
        return self.t

    time = staticmethod(time.time)


def _reference_quickstart(cfg, steps, hetero_steps, autotune_steps,
                          global_batch, seq_len):
    """The reference example's four parts through the reference's API (on
    the ``ref`` backend), one stream through all of them."""
    n = 4
    mesh = make_local_mesh(n, 1)
    spec = jc.SchemeSpec(schedule="gather", backend="ref")

    def trainer(code, spec, source, autotune=None):
        return JTrainer(cfg, code, mesh,
                        optimizer=joptim.get_optimizer("adamw", 3e-3),
                        spec=spec, straggler_source=source,
                        autotune=autotune)

    code = jcore.make_code(n, 3, 1, 2)
    tr = trainer(code, spec, jtune.RandomStragglers(seed=1))
    params = jax.tree.map(np.asarray, tr.params)
    stream = jdata.synthetic_lm_stream(cfg, global_batch=global_batch,
                                       seq_len=seq_len)
    out = {"params": params, "uniform": {
        "describe": code.describe(), "logs": tr.run(stream, steps, 0),
        "coded_fraction": tr.arts.coded_fraction}}
    hcode = jcore.make_hetero_code(speeds=[0.5, 1.0, 1.0, 1.5], s=1, m=2)
    htr = trainer(hcode, spec, jtune.RandomStragglers(seed=1))
    out["hetero"] = {"describe": hcode.describe(), "loads": hcode.loads,
                     "logs": htr.run(stream, hetero_steps, 0)}
    ptr = trainer(hcode, spec.replace(partial=True),
                  jtune.FixedStragglers((0, 3)))
    out["partial"] = {"metrics": ptr.step(next(stream)), "s": hcode.s}
    comm = jrm.RuntimeParams(n=n, lambda1=0.5, lambda2=0.2, t1=0.5, t2=16.0)
    comp = jrm.RuntimeParams(n=n, lambda1=0.5, lambda2=0.2, t1=16.0, t2=0.5)
    atr = trainer(jcore.make_code(n, 4, 2, 2), spec,
                  jtune.DriftingSampler([(0, comm), (10, comp)], seed=3),
                  autotune=jtune.AutotunePolicy(
                      interval=5, window=10, min_samples=5,
                      schedules=("gather",)))
    logs = atr.run(stream, autotune_steps, 0)
    out["autotune"] = {"code": (atr.code.d, atr.code.s, atr.code.m),
                       "events": atr.autotune_events,
                       "cached_schemes": atr.cached_schemes, "logs": logs}
    return out


@pytest.fixture(scope="module")
def quickstart_pair():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer_mod, "time", _Clock())
        mp.setattr(ttrainer_mod, "time", _Clock())
        ref = _reference_quickstart(jget_config("qwen3-1.7b").reduced(), **QS)
        got = _twin("quickstart").run(device="cpu", params=ref["params"],
                                      log_every=0, **QS)
    return ref, got


def test_quickstart_codes_are_the_references(quickstart_pair):
    ref, got = quickstart_pair
    assert got["uniform"]["describe"] == ref["uniform"]["describe"]
    assert got["uniform"]["coded_fraction"] == ref["uniform"]["coded_fraction"]
    assert got["hetero"]["describe"] == ref["hetero"]["describe"]
    assert got["hetero"]["loads"] == ref["hetero"]["loads"]
    assert got["partial"]["s"] == ref["partial"]["s"]


@pytest.mark.parametrize("part", ["uniform", "hetero", "autotune"])
def test_quickstart_losses_follow_the_reference(quickstart_pair, part):
    ref, got = quickstart_pair
    g, r = got[part]["logs"], ref[part]["logs"]
    assert len(g) == len(r) == {"uniform": QS["steps"],
                                "hetero": QS["hetero_steps"],
                                "autotune": QS["autotune_steps"]}[part]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose([m[k] for m in g], [m[k] for m in r],
                                   err_msg=f"{part} {k}", **TRAJ_TOL)


def test_quickstart_partial_step_follows_the_reference(quickstart_pair):
    ref, got = quickstart_pair
    g, r = got["partial"]["metrics"], ref["partial"]["metrics"]
    assert np.isfinite(g["decode_err_bound"]) and g["decode_err_bound"] > 0
    for k in ("loss", "grad_norm", "decode_err_bound"):
        np.testing.assert_allclose(g[k], r[k], err_msg=k, **TRAJ_TOL)


def test_quickstart_autotune_events_are_the_references(quickstart_pair):
    ref, got = quickstart_pair
    key = lambda es: [(e["step"], e["switched"], e["best"]) for e in es]
    assert key(got["autotune"]["events"]) == key(ref["autotune"]["events"])
    assert got["autotune"]["switches"] >= 1
    assert got["autotune"]["code"] == ref["autotune"]["code"]
    assert got["autotune"]["cached_schemes"] == \
        ref["autotune"]["cached_schemes"]


@pytest.mark.parametrize("stragglers", [(3,), (0, 3)])
def test_partial_decode_pairs_the_references_coordinates(stragglers):
    """The reference never groups a leaf along a dim its parameter specs
    shard over the model axis (d_ff, vocab), even at a model axis of 1,
    and the port's trainer takes the same rule.  On the reduced
    ``qwen3-1.7b`` (d_ff and vocab wider than d_model) every leaf is
    grouped alike, so within the budget (one straggler: an exact decode)
    and past it (two: a least-squares estimate, which depends on the
    pairing) the step's loss, gradient norm and certified bound agree."""
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    jcfg = jget_config("qwen3-1.7b").reduced()
    tcfg = tget_config("qwen3-1.7b").reduced()
    assert jcfg.d_ff > jcfg.d_model and jcfg.vocab > jcfg.d_model
    jt = JTrainer(jcfg, jcore.make_code(4, 3, 1, 2), make_local_mesh(4, 1),
                  joptim.get_optimizer("sgd", 1e-2),
                  spec=jc.SchemeSpec(backend="ref", partial=True),
                  straggler_source=jtune.FixedStragglers(stragglers))
    tt = TTrainer(tcfg, tcore.make_code(4, 3, 1, 2),
                  toptim.get_optimizer("sgd", 1e-2),
                  spec=tcoding.SchemeSpec(partial=True),
                  straggler_source=ttune.FixedStragglers(stragglers),
                  device="cpu")
    tt.params = convert.params_from_jax(jax.tree.map(np.asarray, jt.params),
                                        device="cpu")
    tt.opt_state = tt.optimizer.init(tt.params)
    jplans = convert.flatten(jt.arts.plans)
    assert {k: (p.coded, p.group_dim) for k, p in tt.arts.plans.items()} == \
        {k: (p.coded, p.group_dim) for k, p in jplans.items()}
    assert jplans["layers/mlp/w_up"].group_dim == 1      # (L, d_model, d_ff)
    batch = next(jdata.synthetic_lm_stream(jcfg, global_batch=8, seq_len=16))
    mj, mt = jt.step(batch), tt.step(batch)
    for k in ("loss", "grad_norm", "decode_err_bound"):
        np.testing.assert_allclose(mt[k], mj[k], err_msg=k, **TRAJ_TOL)


# ------------------------------------------------------------- train_lm_coded
def _reference_lm_configs():
    """The two configs the reference script builds: its
    ``dataclasses.replace`` calls, in order (``--full-100m`` first, then
    the demo), with their keywords read from its source."""
    tree = ast.parse((ROOT / "examples" / "train_lm_coded.py").read_text())
    calls = [node for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute)
             and node.func.attr == "replace"]
    base = jget_config("qwen3-1.7b")
    bases = {"base": base, "base.reduced()": base.reduced()}
    out = []
    for call in calls:
        kw = {k.arg: ast.literal_eval(k.value) for k in call.keywords}
        out.append(dataclasses.replace(bases[ast.unparse(call.args[0])],
                                       **kw))
    assert [c.name for c in out] == ["coded-lm-100m", "coded-lm-demo"]
    return dict(zip(("full_100m", "demo"), out))


@pytest.mark.parametrize("which", ["demo", "full_100m"])
def test_train_lm_configs_are_the_references(which):
    want = _reference_lm_configs()[which]
    got = getattr(_twin("train_lm_coded"), f"{which}_config")()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_train_lm_main_runs_on_the_cpu_and_logs(tmp_path, capsys):
    log = tmp_path / "train_lm_coded_torch.json"
    res = _twin("train_lm_coded").main([
        "--device", "cpu", "--steps", "2", "--seq", "16",
        "--batch-per-subset", "1", "--log", str(log)])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("model coded-lm-demo: ")
    assert lines[-1].startswith("done: loss ")
    import json
    logged = json.loads(log.read_text())
    assert [m["step"] for m in logged] == [0, 1]
    assert all(np.isfinite(m["loss"]) for m in logged)
    from repro_torch.models import api as tapi
    assert res["n_params"] == sum(
        v.numel() for v in tapi.init(_twin("train_lm_coded").demo_config(),
                                     "meta").values())


# -------------------------------------------------------------- serve_batched
SB = dict(batch=4, prompt_len=8, max_new=4)


@pytest.mark.parametrize("window", [0, 8])
def test_serve_batched_tokens_are_the_reference_engines(window):
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 devices")
    cfg = jget_config("qwen3-1.7b").reduced()
    jp = japi.init(jax.random.PRNGKey(0), cfg)
    eng = JEngine(cfg, make_local_mesh(4, 1), jp, batch=SB["batch"],
                  seq_len=SB["prompt_len"] + SB["max_new"] + 8,
                  window=window)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (SB["batch"], SB["prompt_len"]), dtype=np.int32)
    want = np.asarray(eng.generate(prompts, SB["max_new"]))
    got = _twin("serve_batched").run(
        tget_config("qwen3-1.7b").reduced(), window=window, device="cpu",
        params=jax.tree.map(np.asarray, jp), **SB)
    np.testing.assert_array_equal(got["prompts"], prompts)
    assert got["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want)


# ------------------------------------------------------- flags and the device
def _flags(path):
    """Every ``add_argument`` call of a script: (flag, default) pairs."""
    tree = ast.parse(path.read_text())
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            default = (ast.literal_eval(kw["default"]) if "default" in kw
                       else None)
            out.append((node.args[0].value, default))
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_flags_and_defaults_are_the_references(name):
    """The reference's flags and defaults, in its order, but for the
    differences each twin's docstring names: outputs named with
    ``_torch``, ``--n-model`` dropped; then ``--device``, the one flag
    the reference has not."""
    ref = _flags(ROOT / "examples" / f"{name}.py")
    port = _flags(ROOT / "examples" / f"{name}_torch.py")
    want = [(f, d.replace(".json", "_torch.json")
             if f in ("--out", "--log") else d)
            for f, d in ref if f != "--n-model"]
    assert port[:len(want)] == want
    assert [f for f, _ in port[len(want):]] == ["--device"]
    assert dict(port)["--device"] == "cuda"


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a machine without a card")
@pytest.mark.parametrize("name", EXAMPLES)
def test_main_without_a_card_raises(name):
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _twin(name).main([])


@pytest.mark.parametrize("name", EXAMPLES)
def test_docstring_names_the_reference(name):
    doc = _twin(name).__doc__
    assert f"``examples/{name}.py``" in doc and "It differs in" in doc
