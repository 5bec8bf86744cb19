"""Coded training of the MoE LM (reduced ``olmoe-1b-7b``, S = 64, code (4,
3, 1, 2)) in the port against the reference, and its contracts in the
port:

- 3-step trajectories of the port's ``Trainer`` against the reference's
  (NAG, synchronous gather; SGD-momentum, pipelined fused with a drain),
  from the same parameters on the same batches and random stragglers
  (``lm_train_cases.py``'s constants and tolerance, rtol 1e-4 / atol
  1e-5), on both dispatches (``DISPATCH`` set on both sides; the einsum
  one in chunks of ``EINSUM_CHUNK`` tokens, so a subset's 64 tokens run
  as 4 chunks, each recomputed in the backward);
- bitwise, on the plain backend: fill + drain equals the synchronous step
  (fused and not), the packed wire's decoded gradient equals the per-leaf
  one for both schedules, and a subset gradient repeats its bits, also on
  a batch that drops picks;
- an MoE trainer's checkpoint crosses to the reference's layout (nested
  ``params//layers//moe//w_gate`` keys) and back, bit for bit.
"""
import functools
import warnings
import zipfile

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
from repro.models import moe as jmoe
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
from repro_torch.data import CodedBatcher, make_synthetic_batch
from repro_torch.models import api
from repro_torch.models import moe as tmoe
from repro_torch.optim import sgd_momentum
from repro_torch.train import PipelineDriver, Trainer, make_coded_train_step

torch.set_num_threads(1)

ARCH = "olmoe-1b-7b"
PATTERNS = ((2,), (0,))
EINSUM_CHUNK = 16


def _batches():
    cfg = jget_config(ARCH).reduced()
    rng = np.random.default_rng(7)
    return [jdata.make_synthetic_batch(rng, cfg, 4, cases.SEQ)
            for _ in range(cases.STEPS)]


@functools.lru_cache(maxsize=None)
def _init_params():
    cfg = jget_config(ARCH).reduced()
    return jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(3), cfg))


@functools.lru_cache(maxsize=None)
def _reference_run(opt: str, pipelined: bool, dispatch: str):
    """The reference's run; ``dispatch`` keys the cache (the caller has set
    it on ``repro.models.moe``)."""
    cfg = jget_config(ARCH).reduced()
    jt = JTrainer(cfg, jcore.make_code(*cases.CODE),
                  make_local_mesh(cases.CODE[0], 1),
                  joptim.get_optimizer(opt, cases.LR[opt]),
                  spec=cases._spec(jc, "gather", pipelined, backend="ref"),
                  straggler_source=jtune.RandomStragglers(seed=5), seed=0)
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


@pytest.mark.parametrize("opt,pipelined,dispatch", [
    pytest.param("nag", False, "scatter", id="nag-False"),
    pytest.param("sgd", True, "scatter", id="sgd-True"),
    pytest.param("nag", False, "einsum", id="nag-False-einsum"),
    pytest.param("sgd", True, "einsum", id="sgd-True-einsum")])
def test_moe_trajectory_matches_reference(monkeypatch, opt, pipelined,
                                          dispatch):
    if len(jax.devices()) < cases.CODE[0]:
        pytest.skip(f"needs {cases.CODE[0]} devices")
    for mod in (jmoe, tmoe):
        monkeypatch.setattr(mod, "DISPATCH", dispatch)
        monkeypatch.setattr(mod, "TOKEN_CHUNK", EINSUM_CHUNK)
    chunks = []
    slots = tmoe.einsum_slots
    monkeypatch.setattr(tmoe, "einsum_slots",
                        lambda *a: chunks.append(1) or slots(*a))
    jm, jp, js = _reference_run(opt, pipelined, dispatch)
    tt = Trainer(tget_config(ARCH).reduced(), tcore.make_code(*cases.CODE),
                 toptim.get_optimizer(opt, cases.LR[opt]),
                 spec=cases._spec(tc, "gather", pipelined),
                 straggler_source=ttune.RandomStragglers(seed=5), seed=0,
                 device="cpu")
    tt.params = convert.params_from_jax(_init_params(), device="cpu")
    tt.opt_state = tt.optimizer.init(tt.params)
    tm = [tt.step(b) for b in _batches()]
    if pipelined:
        tm.append(tt.drain())
    assert bool(chunks) == (dispatch == "einsum")
    assert len(jm) == len(tm)
    for a, b in zip(jm, tm):
        for k in ("loss", "grad_norm"):
            if np.isnan(a[k]):                # the pipeline's fill
                assert np.isnan(b[k])
                continue
            np.testing.assert_allclose(b[k], a[k], err_msg=k,
                                       **cases.TRAJ_TOL)
    got = convert.flatten(convert.params_to_numpy(tt.params))
    want = convert.flatten(jp)
    assert set(got) == set(want) and "layers/moe/w_gate" in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **cases.TRAJ_TOL)
    st = convert.opt_state_to_numpy(tt.opt_state)
    assert set(st) == set(js)
    for k in js:
        for a, b in zip(jax.tree.leaves(js[k]), jax.tree.leaves(st[k])):
            np.testing.assert_allclose(b, a, err_msg=k, **cases.TRAJ_TOL)


# ----------------------------------------------- the port's own contracts
def _setup(forced=False):
    cfg = tget_config(ARCH).reduced()
    code = tcore.make_code(*cases.CODE)
    params = api.init(cfg, "cpu", torch.Generator().manual_seed(4))
    rng = np.random.default_rng(8)
    batcher = CodedBatcher(code)
    placed = []
    for _ in PATTERNS:
        b = make_synthetic_batch(rng, cfg, 4, cases.SEQ)
        if forced:     # one token a sequence: its picks overflow
            b = {k: np.repeat(v[:, :1], cases.SEQ, axis=1)
                 for k, v in b.items()}
        placed.append(batcher.place({k: torch.from_numpy(v)
                                     for k, v in b.items()}))
    return cfg, code, params, placed


def _assert_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_equal(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("fuse", [False, True])
def test_moe_fill_drain_equals_sync_bitwise(fuse):
    cfg, code, params, placed = _setup()
    opt = sgd_momentum(1e-2)
    sync = make_coded_train_step(cfg, code, opt, device="cpu")
    pipe = make_coded_train_step(
        cfg, code, opt, device="cpu",
        spec=tc.SchemeSpec(pipelined=True, fuse_apply=fuse))
    ps = pp = params
    ss = sp = opt.init(params)
    drv = PipelineDriver(pipe)
    for b, st in zip(placed, PATTERNS):
        inp = sync.step_inputs(st)
        a = (inp["W"], inp["mask"], inp["rho"])
        ps, ss, ms = sync.step(ps, ss, b, *a)
        pp, sp, mp = drv.step(pp, sp, b, *a)
        assert mp is None
        pp, sp, mp = drv.drain(pp, sp)
        _assert_equal(ps, pp)
        _assert_equal(ss, sp)
        assert torch.equal(ms["loss"], mp["loss"])


@pytest.mark.parametrize("schedule", ["gather", "a2a"])
def test_moe_packed_equals_per_leaf_bitwise(schedule):
    cfg, code, params, placed = _setup()
    grads = []
    for packed in (True, False):
        arts = make_coded_train_step(
            cfg, code, sgd_momentum(1e-2), device="cpu",
            spec=tc.SchemeSpec(schedule=schedule, packed=packed))
        inp = arts.step_inputs(PATTERNS[0])
        g, m = arts.aggregate(params, placed[0], inp["W"], inp["mask"],
                              inp["rho"])
        assert np.isfinite(float(m["loss"]))
        grads.append(g)
    _assert_equal(*grads)


@pytest.mark.parametrize("forced", [False, True], ids=["random", "forced"])
def test_moe_subset_gradient_repeats_its_bits(monkeypatch, forced):
    """One subset's gradient twice, the same bits (fixed-order sums in the
    dispatch, forward and backward); the forced batch drops picks."""
    cfg, code, params, placed = _setup(forced)
    sub = {k: v[0, 0] for k, v in placed[0].items()}
    loss = api.make_loss(cfg)
    out = []
    for _ in range(2):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        lval = loss(p, sub)
        out.append((lval, torch.autograd.grad(lval, list(p.values()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    kept = []
    dispatch = tmoe.dispatch

    def rec(*a):
        r = dispatch(*a)
        kept.append(r.keep)
        return r

    monkeypatch.setattr(tmoe, "dispatch", rec)
    with torch.no_grad():
        tmoe.forward(params, cfg, sub["tokens"])
    if forced:
        assert sum(int((~k).sum()) for k in kept) > 0


# ------------------------------------------------------------ checkpoints
def _bits(x):
    x = np.asarray(x)
    return x.view(np.dtype(f"u{x.dtype.itemsize}"))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_moe_checkpoint_crosses_to_the_reference(tmp_path, writer):
    """A snapshot of one side's MoE trainer restores on the other's, bit
    for bit, under the reference's keys."""
    cfg = tget_config(ARCH).reduced()
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=1, seed=0)
    code = (4, 3, 1, 2)
    if writer == "port":
        a = Trainer(cfg, tcore.make_code(*code), toptim.get_optimizer(
            "nag", 1e-2), device="cpu", **kw)
        a.step(_batches()[0])
    else:
        a = JTrainer(jget_config(ARCH).reduced(), jcore.make_code(*code),
                     make_local_mesh(4, 1), joptim.get_optimizer("nag", 1e-2),
                     **kw)
        a.maybe_checkpoint(force=True)
    (snap,) = tmp_path.glob("*.npz")
    names = zipfile.ZipFile(snap).namelist()
    assert "params//layers//moe//w_gate.npy" in names
    assert "params//layers//router.npy" in names
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if writer == "port":
            b = JTrainer(jget_config(ARCH).reduced(), jcore.make_code(*code),
                         make_local_mesh(4, 1),
                         joptim.get_optimizer("nag", 1e-2), **kw)
        else:
            b = Trainer(cfg, tcore.make_code(*code),
                        toptim.get_optimizer("nag", 1e-2), device="cpu", **kw)
    assert not [w for w in caught if issubclass(w.category, UserWarning)]
    assert b._step_count == a._step_count
    pa = convert.flatten(jax.tree.map(np.asarray, a.params)) \
        if writer == "reference" else \
        convert.flatten(convert.params_to_numpy(a.params))
    pb = convert.flatten(convert.params_to_numpy(b.params)) \
        if writer == "reference" else \
        convert.flatten(jax.tree.map(np.asarray, b.params))
    assert set(pa) == set(pb)
    for k in pa:
        np.testing.assert_array_equal(_bits(pa[k]), _bits(pb[k]), err_msg=k)
