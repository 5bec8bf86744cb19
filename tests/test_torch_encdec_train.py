"""Coded training of the encoder-decoder (reduced ``whisper-tiny``: 8
frame embeddings and 64 decoder tokens a sequence, code (4, 3, 1, 2)) in
the port against the reference: 3-step trajectories of the port's
``Trainer`` against the reference's, from the same parameters on the same
batches (frames included), synchronous NAG under the schedules and
straggler sets the reference trains with (gather with worker 2
straggling, a2a with worker 1), at ``lm_train_cases.py``'s tolerance (rtol
1e-4 / atol 1e-5) on every metric, parameter and optimizer-state leaf; the
synthetic batches of both packages draw for draw.  ``check_trajectory``
also runs the pipelined case (``test_torch_encdec_pipeline.py``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lm_train_cases as cases
import repro.coding as jc
import repro.core as jcore
import repro.data as jdata
import repro.models.api as japi
import repro.optim as joptim
import repro.tune as jtune
import repro_torch.coding as tc
import repro_torch.core as tcore
import repro_torch.optim as toptim
import repro_torch.tune as ttune
from repro.compat import set_mesh
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_local_mesh
from repro.train import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.data import make_synthetic_batch
from repro_torch.train import Trainer

torch.set_num_threads(1)

ARCH = "whisper-tiny"
# (schedule, pipelined) -> fixed stragglers
RUNS = {("gather", False): (2,), ("a2a", False): (1,), ("gather", True): (2,)}
OPT = {False: "nag", True: "sgd"}


def _batches():
    cfg = jget_config(ARCH).reduced()
    rng = np.random.default_rng(7)
    return [jdata.make_synthetic_batch(rng, cfg, 4, cases.SEQ)
            for _ in range(cases.STEPS)]


@functools.lru_cache(maxsize=None)
def _init_params():
    cfg = jget_config(ARCH).reduced()
    return jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(3), cfg))


def _spec(mod, schedule, pipelined, **kw):
    if pipelined:
        kw.update(pipelined=True, fuse_apply=True)
    return mod.SchemeSpec(schedule=schedule, **kw)


@functools.lru_cache(maxsize=None)
def _reference_run(schedule: str, pipelined: bool):
    cfg = jget_config(ARCH).reduced()
    opt = OPT[pipelined]
    jt = JTrainer(cfg, jcore.make_code(*cases.CODE),
                  make_local_mesh(cases.CODE[0], 1),
                  joptim.get_optimizer(opt, cases.LR[opt]),
                  spec=_spec(jc, schedule, pipelined, backend="ref"),
                  straggler_source=jtune.FixedStragglers(
                      RUNS[schedule, pipelined]),
                  seed=0)
    jt.params = jax.tree.map(jnp.asarray, _init_params())
    jt.opt_state = jt.optimizer.init(jt.params)
    metrics = [jt.step(b) for b in _batches()]
    if pipelined:
        with set_mesh(jt.mesh):
            jt.params, jt.opt_state, m = jt._driver.drain(jt.params,
                                                          jt.opt_state)
        metrics.append({k: float(v[0]) for k, v in m.items()})
    return (metrics, jax.tree.map(np.asarray, jt.params),
            jax.tree.map(np.asarray, jt.opt_state))


def check_trajectory(schedule: str, pipelined: bool) -> None:
    """The port's run against the reference's: metrics of every step (NaN
    where the pipeline fills), then every parameter and state leaf."""
    batches = _batches()
    assert batches[0]["embeds"].shape == (4, 8, 256)
    assert batches[0]["tokens"].shape == (4, 64)
    jm, jp, js = _reference_run(schedule, pipelined)
    opt = OPT[pipelined]
    tt = Trainer(tget_config(ARCH).reduced(), tcore.make_code(*cases.CODE),
                 toptim.get_optimizer(opt, cases.LR[opt]),
                 spec=_spec(tc, schedule, pipelined),
                 straggler_source=ttune.FixedStragglers(
                     RUNS[schedule, pipelined]),
                 seed=0, device="cpu")
    tt.params = convert.params_from_jax(_init_params(), device="cpu")
    tt.opt_state = tt.optimizer.init(tt.params)
    tm = [tt.step(b) for b in batches]
    if pipelined:
        tm.append(tt.drain())
    assert len(jm) == len(tm) == cases.STEPS + pipelined
    for a, b in zip(jm, tm):
        for k in ("loss", "grad_norm"):
            if np.isnan(a[k]):                # the pipeline's fill
                assert np.isnan(b[k])
                continue
            assert np.isfinite(b[k])
            np.testing.assert_allclose(b[k], a[k], err_msg=k,
                                       **cases.TRAJ_TOL)
    assert tt.arts.coded_fraction == 1.0
    got = convert.flatten(convert.params_to_numpy(tt.params))
    want = convert.flatten(jp)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **cases.TRAJ_TOL)
    st = convert.opt_state_to_numpy(tt.opt_state)
    assert set(st) == set(js)
    for k in js:
        for a, b in zip(jax.tree.leaves(js[k]), jax.tree.leaves(st[k])):
            np.testing.assert_allclose(b, a, err_msg=k, **cases.TRAJ_TOL)


@pytest.mark.parametrize("schedule", ["gather", "a2a"])
def test_encdec_trajectory_matches_reference(schedule):
    if len(jax.devices()) < cases.CODE[0]:
        pytest.skip(f"needs {cases.CODE[0]} devices")
    check_trajectory(schedule, False)


def test_synthetic_batches_are_the_references():
    """Frames, and tokens cut to ``dec_ctx``, draw for draw."""
    cfg = tget_config(ARCH).reduced()
    a = jdata.make_synthetic_batch(np.random.default_rng(5), cfg, 4, 100)
    b = make_synthetic_batch(np.random.default_rng(5), cfg, 4, 100)
    assert set(a) == set(b) == {"tokens", "labels", "embeds"}
    assert b["tokens"].shape == (4, cfg.dec_ctx)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k])
