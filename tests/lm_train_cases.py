"""What the dense-LM training tests share (not a test module): 3-step
trajectories of the port's ``Trainer`` and of the reference's ``Trainer``
(a ``shard_map`` over forced host devices) on reduced ``qwen3-1.7b`` at
S = 64, from the same parameters (through ``convert.py``), on the same
batches and the same random stragglers, code (4, 3, 1, 2).

Tolerance: rtol 1e-4 / atol 1e-5 on every parameter, optimizer-state leaf
and metric (``tests/test_torch_step.py``'s): both sides compute in f32 and
add the same terms in other orders, compounded over the steps.  Each
reference run is made once per process and kept, since it compiles for
seconds; the test files split the runs so that each stays near a minute on
one core.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

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
from repro.configs import get_config as jget_config
from repro.compat import set_mesh
from repro.launch.mesh import make_local_mesh
from repro.train import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.train import Trainer as TTrainer

torch.set_num_threads(1)

CODE = (4, 3, 1, 2)
STEPS = 3
SEQ = 64
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
LR = {"nag": 1e-2, "sgd": 1e-2, "adamw": 1e-3}
# AdamW's eps.  A gradient element that is exactly 0 (an embedding row
# that no token of the batch selects) comes out of the decode as rounding
# residue, up to ~1e-7 and with other bits on each side; AdamW's step
# m / (sqrt(v) + eps) is blind to scale, so eps = 1e-8 turns that residue
# into a full step of either sign on both sides alike.  eps = 1e-4 damps it
# below atol while the real gradients (~1e-3 and up) keep nearly full steps
KW = {"adamw": {"eps": 1e-4}}


def batches():
    cfg = jget_config("qwen3-1.7b").reduced()
    rng = np.random.default_rng(7)
    return [jdata.make_synthetic_batch(rng, cfg, 4, SEQ) for _ in range(STEPS)]


def init_params():
    cfg = jget_config("qwen3-1.7b").reduced()
    return jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(3), cfg))


def _spec(mod, schedule, pipelined, **kw):
    if pipelined:
        kw.update(pipelined=True, fuse_apply=True)
    return mod.SchemeSpec(schedule=schedule, **kw)


@functools.lru_cache(maxsize=None)
def reference_run(schedule: str, opt: str, pipelined: bool):
    """Metrics per step, then params and optimizer state as numpy."""
    cfg = jget_config("qwen3-1.7b").reduced()
    jt = JTrainer(cfg, jcore.make_code(*CODE), make_local_mesh(CODE[0], 1),
                  joptim.get_optimizer(opt, LR[opt], **KW.get(opt, {})),
                  spec=_spec(jc, schedule, pipelined, backend="ref"),
                  straggler_source=jtune.RandomStragglers(seed=5), seed=0)
    jt.params = jax.tree.map(jnp.asarray, init_params())
    jt.opt_state = jt.optimizer.init(jt.params)
    metrics = [jt.step(b) for b in batches()]
    if pipelined:
        # the reference's Trainer keeps its driver; retire the last update
        with set_mesh(jt.mesh):
            jt.params, jt.opt_state, m = jt._driver.drain(jt.params,
                                                          jt.opt_state)
        metrics.append({k: float(v[0]) for k, v in m.items()})
    return (metrics, jax.tree.map(np.asarray, jt.params),
            jax.tree.map(np.asarray, jt.opt_state))


def port_run(schedule: str, opt: str, pipelined: bool):
    cfg = tget_config("qwen3-1.7b").reduced()
    tt = TTrainer(cfg, tcore.make_code(*CODE),
                  toptim.get_optimizer(opt, LR[opt], **KW.get(opt, {})),
                  spec=_spec(tc, schedule, pipelined),
                  straggler_source=ttune.RandomStragglers(seed=5), seed=0,
                  device="cpu")
    tt.params = convert.params_from_jax(init_params(), device="cpu")
    tt.opt_state = tt.optimizer.init(tt.params)
    metrics = [tt.step(b) for b in batches()]
    if pipelined:
        metrics.append(tt.drain())
    return metrics, tt


def check_trajectory(schedule: str, opt: str, pipelined: bool) -> None:
    """The port's run against the reference's: metrics of every step (NaN
    where the pipeline fills), then every parameter and state leaf."""
    jm, jp, js = reference_run(schedule, opt, pipelined)
    tm, tt = port_run(schedule, opt, pipelined)
    assert len(jm) == len(tm)
    for a, b in zip(jm, tm):
        for k in ("loss", "grad_norm"):
            if np.isnan(a[k]):                # the pipeline's fill
                assert np.isnan(b[k])
                continue
            assert np.isfinite(b[k])
            np.testing.assert_allclose(b[k], a[k], err_msg=k, **TRAJ_TOL)
    got = convert.params_to_numpy(tt.params)
    for path, want in jax.tree_util.tree_leaves_with_path(jp):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        np.testing.assert_allclose(leaf, want, err_msg=str(path), **TRAJ_TOL)
    st = convert.opt_state_to_numpy(tt.opt_state)
    assert set(st) == set(js)
    for k in js:
        for a, b in zip(jax.tree.leaves(js[k]), jax.tree.leaves(st[k])):
            np.testing.assert_allclose(b, a, err_msg=k, **TRAJ_TOL)
