"""Coded training of the hybrid (``zamba2-1.2b``: the reduced config, and
``short``: 5 layers in groups of 2, the last group short; S = 64, code
(4, 3, 1, 2)) in the port against the reference, and its contracts in the
port:

- a 3-step NAG trajectory of the port's ``Trainer`` against the
  reference's (its ``make_coded_train_step`` under its ``Trainer``), from
  the same parameters on the same batches, worker 2 straggling (gather),
  on both configs, at ``lm_train_cases.py``'s tolerance (rtol 1e-4 / atol
  1e-5: tighter than the 5e-4 the reference's own
  ``test_coded_equals_uncoded`` holds zamba2-1.2b to); the shared block's
  leaves among those compared; the synthetic batches of both packages are
  the same tokens and labels;
- on the plain backend: the decoded gradient with a straggler is the
  uncoded mean of the subsets' gradients (rtol 1e-5), the packed wire's
  decoded gradient equals the per-leaf one bitwise for both schedules, and
  a subset's gradient repeats its bits;
- a hybrid trainer's checkpoint restores bit for bit in a new port
  trainer, and crosses to the reference's layout
  (``params//shared_attn//attn//wq``) and back.
"""
import dataclasses
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
import repro_torch.coding as tc
import repro_torch.core as tcore
import repro_torch.optim as toptim
import repro_torch.tune as ttune
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_local_mesh
from repro.train import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.data import CodedBatcher, make_synthetic_batch
from repro_torch.models import api
from repro_torch.optim import sgd_momentum
from repro_torch.train import Trainer, make_coded_train_step

torch.set_num_threads(1)

ARCH = "zamba2-1.2b"
CONFIGS = ["reduced", "short"]
RUNS = {"gather": (2,), "a2a": (1,)}     # schedule -> fixed stragglers


def _cfg(get_config, which="reduced"):
    cfg = get_config(ARCH).reduced()
    return cfg if which == "reduced" else dataclasses.replace(
        cfg, n_layers=5, attn_every=2)


def _batches():
    cfg = jget_config(ARCH).reduced()
    rng = np.random.default_rng(7)
    return [jdata.make_synthetic_batch(rng, cfg, 4, cases.SEQ)
            for _ in range(cases.STEPS)]


@functools.lru_cache(maxsize=None)
def _init_params(which):
    cfg = _cfg(jget_config, which)
    return jax.tree.map(np.asarray, japi.init(jax.random.PRNGKey(3), cfg))


@functools.lru_cache(maxsize=None)
def _reference_run(schedule: str, which: str):
    cfg = _cfg(jget_config, which)
    jt = JTrainer(cfg, jcore.make_code(*cases.CODE),
                  make_local_mesh(cases.CODE[0], 1),
                  joptim.get_optimizer("nag", cases.LR["nag"]),
                  spec=jc.SchemeSpec(schedule=schedule, backend="ref"),
                  straggler_source=jtune.FixedStragglers(RUNS[schedule]),
                  seed=0)
    jt.params = jax.tree.map(jnp.asarray, _init_params(which))
    jt.opt_state = jt.optimizer.init(jt.params)
    metrics = [jt.step(b) for b in _batches()]
    return (metrics, jax.tree.map(np.asarray, jt.params),
            jax.tree.map(np.asarray, jt.opt_state))


@pytest.mark.parametrize("which", CONFIGS)
def test_hybrid_trajectory_matches_reference(which):
    schedule = "gather"
    if len(jax.devices()) < cases.CODE[0]:
        pytest.skip(f"needs {cases.CODE[0]} devices")
    batches = _batches()
    assert set(batches[0]) == {"tokens", "labels"}
    jm, jp, js = _reference_run(schedule, which)
    tt = Trainer(_cfg(tget_config, which), tcore.make_code(*cases.CODE),
                 toptim.get_optimizer("nag", cases.LR["nag"]),
                 spec=tc.SchemeSpec(schedule=schedule),
                 straggler_source=ttune.FixedStragglers(RUNS[schedule]),
                 seed=0, device="cpu")
    tt.params = convert.params_from_jax(_init_params(which), device="cpu")
    tt.opt_state = tt.optimizer.init(tt.params)
    tm = [tt.step(b) for b in batches]
    assert len(jm) == len(tm) == cases.STEPS
    for a, b in zip(jm, tm):
        for k in ("loss", "grad_norm"):
            assert np.isfinite(b[k])
            np.testing.assert_allclose(b[k], a[k], err_msg=k,
                                       **cases.TRAJ_TOL)
    assert tt.arts.coded_fraction == 1.0
    got = convert.flatten(convert.params_to_numpy(tt.params))
    want = convert.flatten(jp)
    assert set(got) == set(want)
    assert {k for k in want if k.startswith("shared_attn/")} == {
        "shared_attn/attn/wk", "shared_attn/attn/wo", "shared_attn/attn/wq",
        "shared_attn/attn/wv", "shared_attn/ln1", "shared_attn/ln2",
        "shared_attn/mlp/w_down", "shared_attn/mlp/w_gate",
        "shared_attn/mlp/w_up"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k,
                                   **cases.TRAJ_TOL)
    st = convert.opt_state_to_numpy(tt.opt_state)
    assert set(st) == set(js)
    for k in js:
        for a, b in zip(jax.tree.leaves(js[k]), jax.tree.leaves(st[k])):
            np.testing.assert_allclose(b, a, err_msg=k, **cases.TRAJ_TOL)


def test_synthetic_batches_are_the_references():
    cfg = tget_config(ARCH).reduced()
    a = jdata.make_synthetic_batch(np.random.default_rng(5), cfg, 4, 32)
    b = make_synthetic_batch(np.random.default_rng(5), cfg, 4, 32)
    assert set(a) == set(b) == {"tokens", "labels"}
    assert all(np.array_equal(a[k], b[k]) for k in a)


# ----------------------------------------------- the port's own contracts
def _setup(which="reduced"):
    cfg = _cfg(tget_config, which)
    code = tcore.make_code(*cases.CODE)
    params = api.init(cfg, "cpu", torch.Generator().manual_seed(4))
    batch = {k: torch.from_numpy(v) for k, v in make_synthetic_batch(
        np.random.default_rng(8), cfg, 4, cases.SEQ).items()}
    return cfg, code, params, batch


def _assert_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("which,schedule", [("reduced", "gather"),
                                            ("reduced", "a2a"),
                                            ("short", "gather")])
def test_hybrid_decoded_gradient_is_the_uncoded_mean(which, schedule):
    """With worker ``RUNS[schedule]`` straggling, the decoded gradient is
    the mean over the 4 sequences of each one's gradient, within f32
    rounding of the decode's weights (the shared block's too)."""
    cfg, code, params, batch = _setup(which)
    arts = make_coded_train_step(cfg, code, sgd_momentum(1e-2), device="cpu",
                                 spec=tc.SchemeSpec(schedule=schedule))
    inp = arts.step_inputs(RUNS[schedule])
    dec, m = arts.aggregate(params, CodedBatcher(code).place(batch),
                            inp["W"], inp["mask"], inp["rho"])
    loss = api.make_loss(cfg)
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    want = {k: torch.zeros_like(v) for k, v in params.items()}
    losses = []
    for j in range(4):
        lval = loss(p, {k: v[j:j + 1] for k, v in batch.items()})
        for k, g in zip(p, torch.autograd.grad(lval, list(p.values()))):
            want[k] += g / 4
        losses.append(float(lval.detach()))
    np.testing.assert_allclose(float(m["loss"]), np.mean(losses), rtol=1e-5)
    for k in params:
        scale = float(want[k].abs().max())
        assert scale > 0, k
        np.testing.assert_allclose(dec[k].numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("schedule", ["gather", "a2a"])
def test_hybrid_packed_equals_per_leaf_bitwise(schedule):
    cfg, code, params, batch = _setup("short")
    placed = CodedBatcher(code).place(batch)
    grads = []
    for packed in (True, False):
        arts = make_coded_train_step(
            cfg, code, sgd_momentum(1e-2), device="cpu",
            spec=tc.SchemeSpec(schedule=schedule, packed=packed))
        inp = arts.step_inputs(RUNS[schedule])
        g, m = arts.aggregate(params, placed, inp["W"], inp["mask"],
                              inp["rho"])
        assert np.isfinite(float(m["loss"]))
        grads.append(g)
    _assert_equal(*grads)


def test_hybrid_subset_gradient_repeats_its_bits():
    cfg, _, params, batch = _setup("short")
    sub = {k: v[:1] for k, v in batch.items()}
    loss = api.make_loss(cfg)
    out = []
    for _ in range(2):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        lval = loss(p, sub)
        out.append((lval, torch.autograd.grad(lval, list(p.values()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


# ------------------------------------------------------------ checkpoints
def _bits(x):
    x = np.asarray(x)
    return x.view(np.dtype(f"u{x.dtype.itemsize}"))


def test_hybrid_checkpoint_restores_bitwise(tmp_path):
    """Two steps with a snapshot after each; a new trainer on the directory
    resumes at step 2 with the same parameters and NAG state, bit for bit,
    and its next step equals the first trainer's (16-token sequences)."""
    cfg, code, _, _ = _setup()
    rng = np.random.default_rng(9)
    batches = [make_synthetic_batch(rng, cfg, 4, 16) for _ in range(3)]
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=1, seed=0,
              straggler_source=ttune.FixedStragglers((2,)), device="cpu")
    a = Trainer(cfg, code, toptim.get_optimizer("nag", 1e-2), **kw)
    for b in batches[:2]:
        a.step(b)
    b_ = Trainer(cfg, code, toptim.get_optimizer("nag", 1e-2), **kw)
    assert b_._step_count == a._step_count == 2
    _assert_equal(a.params, b_.params)
    _assert_equal(a.opt_state["x_prev"], b_.opt_state["x_prev"])
    assert torch.equal(a.opt_state["lam"], b_.opt_state["lam"])
    ma, mb = a.step(batches[2]), b_.step(batches[2])
    assert float(ma["loss"]) == float(mb["loss"])
    _assert_equal(a.params, b_.params)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_hybrid_checkpoint_crosses_to_the_reference(tmp_path, writer):
    """A snapshot of one side's hybrid trainer restores on the other's, bit
    for bit, under the reference's keys."""
    cfg = tget_config(ARCH).reduced()
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=1, seed=0)
    code = (4, 3, 1, 2)

    def reference():
        return JTrainer(jget_config(ARCH).reduced(), jcore.make_code(*code),
                        make_local_mesh(4, 1),
                        joptim.get_optimizer("nag", 1e-2), **kw)

    def port():
        return Trainer(cfg, tcore.make_code(*code),
                       toptim.get_optimizer("nag", 1e-2), device="cpu", **kw)

    if writer == "port":
        a = port()
        a.step(_batches()[0])
    else:
        a = reference()
        a.maybe_checkpoint(force=True)
    (snap,) = tmp_path.glob("*.npz")
    names = zipfile.ZipFile(snap).namelist()
    assert "params//shared_attn//attn//wq.npy" in names
    assert "params//mamba//in_proj.npy" in names
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        b = reference() if writer == "port" else port()
    assert not [w for w in caught if issubclass(w.category, UserWarning)]
    assert b._step_count == a._step_count

    def flat(tr):
        if isinstance(tr, Trainer):
            return convert.flatten(convert.params_to_numpy(tr.params))
        return convert.flatten(jax.tree.map(np.asarray, tr.params))

    pa, pb = flat(a), flat(b)
    assert set(pa) == set(pb)
    for k in pa:
        np.testing.assert_array_equal(_bits(pa[k]), _bits(pb[k]), err_msg=k)
