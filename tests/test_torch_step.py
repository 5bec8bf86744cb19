"""The train step as a whole: the same parameters (through ``convert.py``), the
same batches and the same straggler sequence go through the reference's
``Trainer`` (a ``shard_map`` over forced host devices) and the port's (the
single-process worker group, on the CPU with the plain kernels).

Trajectory tolerance: rtol=1e-4, atol=1e-5 — both sides compute in f32 and
add the same terms in different orders (XLA's reductions and einsums against
the port's ordered sums), and three optimizer steps compound that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.coding as jc
import repro.core as jcore
import repro.data as jdata
import repro.optim as joptim
import repro.tune as jtune
import repro_torch.coding as tc
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.optim as toptim
import repro_torch.tune as ttune
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_local_mesh
from repro.train import Trainer as JTrainer
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.train import Trainer as TTrainer
from repro_torch.train import make_coded_train_step

torch.set_num_threads(1)

N, D_, S_, M_ = 4, 3, 1, 2
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
LR = {"nag": 1e-3, "sgd": 1e-2, "adamw": 3e-3}


def _cfgs(d_model=64):
    return (dataclasses.replace(jget_config("logistic-paper"), d_model=d_model),
            dataclasses.replace(tget_config("logistic-paper"), d_model=d_model))


def _sources(kind):
    if kind == "none":
        return None, None
    if kind == "random":
        return jtune.RandomStragglers(seed=5), ttune.RandomStragglers(seed=5)
    idx = tuple(int(c) for c in kind)
    return jtune.FixedStragglers(idx), ttune.FixedStragglers(idx)


def _pair(opt, schedule, stragglers, code=(N, D_, S_, M_), partial=False,
          packed=True, wire="float32"):
    """A reference trainer and a port trainer in the same state."""
    if len(jax.devices()) < code[0]:
        pytest.skip(f"needs {code[0]} devices")
    jcfg, tcfg = _cfgs()
    jsrc, tsrc = _sources(stragglers)
    kw = dict(schedule=schedule, partial=partial, packed=packed,
              encode_dtype=wire)
    jt = JTrainer(jcfg, jcore.make_code(*code), make_local_mesh(code[0], 1),
                  joptim.get_optimizer(opt, LR[opt]),
                  spec=jc.SchemeSpec(backend="ref", **kw),
                  straggler_source=jsrc, seed=0)
    tt = TTrainer(tcfg, tcore.make_code(*code),
                  toptim.get_optimizer(opt, LR[opt]),
                  spec=tc.SchemeSpec(**kw), straggler_source=tsrc, seed=0,
                  device="cpu")
    beta = (0.1 * np.random.default_rng(11).standard_normal(64)).astype(
        np.float32)
    jt.params = {"beta": jnp.asarray(beta)}
    jt.opt_state = jt.optimizer.init(jt.params)
    tt.params = convert.params_from_jax({"beta": beta}, device="cpu")
    tt.opt_state = convert.opt_state_from_jax(
        jax.tree.map(np.asarray, jt.opt_state), device="cpu")
    return jt, tt


def _batches(steps, batch=16):
    jcfg, tcfg = _cfgs()
    ra, rb = np.random.default_rng(1), np.random.default_rng(1)
    out = []
    for _ in range(steps):
        a = jdata.make_synthetic_batch(ra, jcfg, batch, 0)
        b = tdata.make_synthetic_batch(rb, tcfg, batch, 0)
        assert all(np.array_equal(a[k], b[k]) for k in a)
        out.append(b)
    return out


def _run_both(jt, tt, steps=3):
    for b in _batches(steps, batch=4 * jt.code.n):
        mj, mt = jt.step(b), tt.step(b)
        for k in mj:
            np.testing.assert_allclose(mt[k], mj[k], err_msg=k, **TRAJ_TOL)
    got = convert.params_to_numpy(tt.params)["beta"]
    np.testing.assert_allclose(got, np.asarray(jt.params["beta"]), **TRAJ_TOL)
    sj = jax.tree.map(np.asarray, jt.opt_state)
    st = convert.opt_state_to_numpy(tt.opt_state)
    assert set(sj) == set(st)
    for k in sj:
        for a, b in zip(jax.tree.leaves(sj[k]), jax.tree.leaves(st[k])):
            np.testing.assert_allclose(b, a, err_msg=k, **TRAJ_TOL)
    return mj, mt


@pytest.mark.parametrize("stragglers", ["none", "random"])
@pytest.mark.parametrize("schedule", ["gather", "a2a", "psum"])
@pytest.mark.parametrize("opt", ["nag", "sgd"])
def test_trajectory_matches_reference(opt, schedule, stragglers):
    jt, tt = _pair(opt, schedule, stragglers)
    assert tt.arts.coded_fraction == jt.arts.coded_fraction == 1.0
    _run_both(jt, tt)


@pytest.mark.parametrize("schedule", ["gather", "a2a"])
def test_partial_past_s_matches_reference(schedule):
    """Three stragglers against s = 2: the least-squares decode and its
    ``decode_err_bound`` certificate agree with the reference's."""
    jt, tt = _pair("nag", schedule, "012", code=(8, 4, 2, 2), partial=True)
    mj, mt = _run_both(jt, tt)
    assert mt["decode_err_bound"] > 0 and "decode_err_bound" in mj


def test_partial_within_s_and_psum_baseline_bound():
    jt, tt = _pair("sgd", "gather", "1", partial=True)
    _, mt = _run_both(jt, tt)
    assert mt["decode_err_bound"] < 1e-3
    jt, tt = _pair("sgd", "psum", "1", partial=True)
    _, mt = _run_both(jt, tt)
    assert mt["decode_err_bound"] == 0.0


def test_per_leaf_and_bf16_wire_match_reference():
    jt, tt = _pair("nag", "gather", "random", packed=False)
    _run_both(jt, tt)
    jt, tt = _pair("sgd", "gather", "none", wire="bfloat16")
    for b in _batches(2):
        mj, mt = jt.step(b), tt.step(b)
        np.testing.assert_allclose(mt["loss"], mj["loss"], **TRAJ_TOL)
    # a bf16 wire rounds each encoding once: bf16 tolerance on the params
    np.testing.assert_allclose(tt.params["beta"].numpy(),
                               np.asarray(jt.params["beta"]),
                               rtol=2e-2, atol=2e-2)


def test_adamw_matches_reference():
    jt, tt = _pair("adamw", "gather", "none")
    _run_both(jt, tt)


# ------------------------------------------------- contracts inside the port
def _port_params_after(schedule, packed, wire, stragglers=(1,), steps=3):
    _, tcfg = _cfgs()
    code = tcore.make_code(N, D_, S_, M_)
    opt = toptim.get_optimizer("sgd", 1e-2)
    arts = make_coded_train_step(
        tcfg, code, opt, device="cpu",
        spec=tc.SchemeSpec(schedule=schedule, packed=packed,
                           encode_dtype=wire))
    params = convert.params_from_jax(
        {"beta": (0.1 * np.random.default_rng(11).standard_normal(64))
         .astype(np.float32)}, device="cpu")
    state = opt.init(params)
    inp = arts.step_inputs(stragglers)
    batcher = tdata.CodedBatcher(code)
    for b in _batches(steps):
        placed = batcher.place({k: torch.as_tensor(v) for k, v in b.items()})
        params, state, metrics = arts.step(params, state, placed, inp["W"],
                                           inp["mask"], inp["rho"])
    return params["beta"], metrics, arts


@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", ["gather", "a2a"])
def test_packed_step_bitwise_equals_per_leaf(schedule, wire):
    a, ma, arts = _port_params_after(schedule, True, wire)
    b, mb, _ = _port_params_after(schedule, False, wire)
    assert arts.pack_plan is not None
    assert torch.equal(a, b)
    assert torch.equal(ma["loss"], mb["loss"])
    assert torch.equal(ma["grad_norm"], mb["grad_norm"])


def test_straggler_invariance_and_coded_equals_uncoded():
    """The decoded update is the same for every straggler set of size <= s
    (paper Definition 1) and equals the uncoded baseline's."""
    base, _, _ = _port_params_after("psum", True, "float32", stragglers=())
    for st in ((), (0,), (1,), (2,), (3,)):
        got, _, _ = _port_params_after("gather", True, "float32",
                                       stragglers=st)
        torch.testing.assert_close(got, base, rtol=1e-4, atol=1e-5)


def test_collectives_per_step():
    _, _, arts = _port_params_after("gather", True, "float32", steps=1)
    assert arts.comm.counts == {"all_gather": 1, "all_to_all": 0, "psum": 1}
    _, _, arts = _port_params_after("a2a", True, "float32", steps=1)
    assert arts.comm.counts == {"all_gather": 1, "all_to_all": 1, "psum": 1}


def _mlp_case():
    """A two-layer MLP as a plain parameter dict with a custom loss: a 2D
    leaf grouped on dim 1 (trailing dim -> the kernels' 3D variants), a 2D
    leaf grouped on dim 0, and a bias that no dimension codes."""
    rng = np.random.default_rng(21)
    params = {
        "w1": torch.from_numpy(
            (0.3 * rng.standard_normal((6, 16))).astype(np.float32)),
        "b1": torch.from_numpy(
            (0.1 * rng.standard_normal((7,))).astype(np.float32)),
        "w2": torch.from_numpy(
            (0.3 * rng.standard_normal((16, 7))).astype(np.float32)),
    }

    def loss_fn(p, batch):
        h = torch.tanh(batch["x"] @ p["w1"])
        out = h @ p["w2"] + p["b1"]
        return torch.sum((out - batch["t"]) ** 2)

    batch = {"x": torch.from_numpy(
                 rng.standard_normal((16, 6)).astype(np.float32)),
             "t": torch.from_numpy(
                 rng.standard_normal((16, 7)).astype(np.float32))}
    return params, loss_fn, batch


@pytest.mark.parametrize("schedule", ["gather", "a2a"])
def test_generic_params_and_loss(schedule):
    """``make_coded_train_step`` takes any parameter dict and loss: the
    decoded gradient with a straggler equals autograd's gradient of the
    whole batch, packed == per-leaf bitwise, mixed coded/psum leaves."""
    params, loss_fn, batch = _mlp_case()
    code = tcore.make_code(4, 3, 1, 2)
    opt = toptim.get_optimizer("sgd", 1e-2)
    placed = tdata.CodedBatcher(code).place(batch)
    grads = {}
    for packed in (True, False):
        arts = make_coded_train_step(
            None, code, opt, device="cpu", loss_fn=loss_fn,
            params_like=params, grad_scale=1.0,
            spec=tc.SchemeSpec(schedule=schedule, packed=packed))
        assert not arts.plans["b1"].coded and arts.plans["w1"].coded
        assert 0.9 < arts.coded_fraction < 1.0
        inp = arts.step_inputs((2,))
        grads[packed], metrics = arts.aggregate(
            params, placed, inp["W"], inp["mask"], inp["rho"])
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    want = torch.autograd.grad(loss_fn(p, batch), list(p.values()))
    for (k, g), w in zip(grads[True].items(), want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
        assert torch.equal(g, grads[False][k])
    # loss: the masked, rho-weighted sum over subsets, over k subsets
    torch.testing.assert_close(metrics["loss"] * code.n,
                               loss_fn(params, batch), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ trainer
def test_trainer_run_and_loss_decreases():
    _, tcfg = _cfgs()
    tr = TTrainer(tcfg, tcore.make_code(N, D_, S_, M_),
                  toptim.get_optimizer("nag", 1e-3),
                  straggler_source=ttune.RandomStragglers(seed=2), seed=1,
                  device="cpu")
    assert all(torch.count_nonzero(v) == 0 for v in tr.params.values())
    fixed = tdata.make_synthetic_batch(np.random.default_rng(1), tcfg, 16)
    logs = tr.run(iter(lambda: fixed, None), steps=12, log_every=0)
    assert [m["step"] for m in logs] == list(range(12))
    assert logs[-1]["loss"] < logs[0]["loss"]
    assert all(np.isfinite(m["grad_norm"]) for m in logs)


@pytest.mark.parametrize("kw", ["autotune", "checkpoint_dir", "pipelined",
                                "schedule", "injector"])
def test_trainer_refuses_what_is_not_ported_yet(kw, tmp_path):
    """The reference's deprecated keywords (the pipelined step itself is
    ``spec=SchemeSpec(pipelined=True)``).  Checkpointing is ported:
    ``checkpoint_dir`` takes a directory and refuses a value that is no
    path.  The auto-tuner is ported: ``autotune`` refuses an untimed
    straggler source with the reference's ``ValueError``."""
    _, tcfg = _cfgs()
    code = tcore.make_code(N, D_, S_, M_)
    if kw == "checkpoint_dir":
        tr = TTrainer(tcfg, code, toptim.get_optimizer("nag", 1e-3),
                      device="cpu", checkpoint_dir=str(tmp_path))
        assert tr._ckpt.dir == tmp_path and tr._ckpt.steps() == []
        with pytest.raises(TypeError):
            TTrainer(tcfg, code, toptim.get_optimizer("nag", 1e-3),
                     device="cpu", checkpoint_dir=1)
    elif kw == "autotune":
        with pytest.raises(ValueError, match="needs per-worker timings: "
                                             "pass a timed straggler_source"):
            TTrainer(tcfg, code, toptim.get_optimizer("nag", 1e-3),
                     device="cpu", autotune=ttune.AutotunePolicy())
    else:
        msg = r"pipelined.*SchemeSpec\(pipelined=True\)" \
            if kw == "pipelined" else kw
        with pytest.raises(NotImplementedError, match=msg):
            TTrainer(tcfg, code, toptim.get_optimizer("nag", 1e-3),
                     device="cpu", **{kw: 1})
    with pytest.raises(TypeError):
        TTrainer(tcfg, tcore.make_code(N, D_, S_, M_),
                 toptim.get_optimizer("nag", 1e-3), device="cpu", bogus=1)


def test_batcher_places_numpy_and_tensors_alike():
    code = tcore.make_code(N, D_, S_, M_)
    b = _batches(1)[0]
    a = jdata.CodedBatcher(jcore.make_code(N, D_, S_, M_)).place(b)
    p_np = tdata.CodedBatcher(code).place(b)
    p_t = tdata.CodedBatcher(code).place(
        {k: torch.as_tensor(v) for k, v in b.items()})
    for k in b:
        assert np.array_equal(a[k], p_np[k])
        assert np.array_equal(a[k], p_t[k].numpy())
    with pytest.raises(ValueError):
        tdata.CodedBatcher(code).place({"x": np.zeros((6, 3))})


def test_convert_roundtrips():
    tree = {"b": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "a": np.ones(4, np.float32)}
    flat = convert.params_from_jax(tree, device="cpu")
    assert list(flat) == ["a", "b/w"]
    back = convert.params_to_numpy(flat)
    assert np.array_equal(back["b"]["w"], tree["b"]["w"])
    params = {"beta": jnp.ones((4,), jnp.float32)}
    for name in ("nag", "sgd", "adamw"):
        js = jax.tree.map(np.asarray,
                          joptim.get_optimizer(name, 0.1).init(params))
        ts = convert.opt_state_from_jax(js, device="cpu")
        mine = toptim.get_optimizer(name, 0.1).init(
            convert.params_from_jax(jax.tree.map(np.asarray, params),
                                    device="cpu"))
        assert set(ts) == set(mine)
        back = convert.opt_state_to_numpy(ts)
        for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for k in ts:
            ours = mine[k]
            assert type(ours) is type(ts[k])
            if isinstance(ours, torch.Tensor):
                assert ours.dtype == ts[k].dtype and ours.shape == ts[k].shape


# ------------------------------------------------ the rest of the workload
def test_linear_model_forward_and_loss_match_reference():
    import repro.models.api as japi
    import repro_torch.models.api as tapi
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(8)
    beta = rng.standard_normal(64).astype(np.float32)
    b = tdata.make_synthetic_batch(rng, tcfg, 16)
    jp, tp = {"beta": jnp.asarray(beta)}, {"beta": torch.from_numpy(beta)}
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    np.testing.assert_allclose(
        tapi.make_forward(tcfg)(tp, tb).numpy(),
        np.asarray(japi.make_forward(jcfg)(jp, b)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        float(tapi.make_loss(tcfg)(tp, tb)),
        float(japi.make_loss(jcfg)(jp, b)), rtol=1e-5)
    from repro.models import linear as jlin
    from repro_torch.models import linear as tlin
    np.testing.assert_allclose(
        float(tlin.loss(tp, tcfg, tb, l2=0.5)),
        float(jlin.loss(jp, jcfg, b, l2=0.5)), rtol=1e-5)
    np.testing.assert_allclose(
        tlin.predict_proba(tp, tcfg, tb["x"]).numpy(),
        np.asarray(jlin.predict_proba(jp, jcfg, b["x"])), rtol=1e-5, atol=1e-6)
    init = tapi.init(tcfg, "cpu")
    assert list(init) == ["beta"] and init["beta"].shape == (64,)
    with pytest.raises(NotImplementedError, match="ssm"):
        tapi.make_loss(dataclasses.replace(tcfg, family="ssm"))


def test_synthetic_data_equals_reference_exactly():
    a = jdata.synthetic_logistic_dataset(n_samples=200, dim=64, seed=3,
                                         n_informative=8)
    b = tdata.synthetic_logistic_dataset(n_samples=200, dim=64, seed=3,
                                         n_informative=8)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    jcfg, tcfg = _cfgs()
    sa = jdata.synthetic_lm_stream(jcfg, 8, 0, seed=4)
    sb = tdata.synthetic_stream(tcfg, 8, seed=4)
    for _ in range(2):
        x, y = next(sa), next(sb)
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert tget_config("logistic-paper") == dataclasses.replace(
        tget_config("logistic-paper"))
    assert dataclasses.asdict(tget_config("logistic-paper")) == \
        dataclasses.asdict(jget_config("logistic-paper"))
    with pytest.raises(KeyError):
        tget_config("olmoe-1b-7b")


def test_straggler_sources_equal_reference():
    jcode, tcode = jcore.make_code(8, 4, 2, 2), tcore.make_code(8, 4, 2, 2)
    a, b = jtune.RandomStragglers(seed=9), ttune.RandomStragglers(seed=9)
    for step in range(6):
        assert a.draw(step, jcode).stragglers == b.draw(step, tcode).stragglers
    times = np.array([3.0, 1.0, np.nan, 2.0, 5.0, 0.5, 4.0, 1.5])
    wa = jtune.WorkerTimes(compute_s=times, comm_s=np.zeros(8))
    wb = ttune.WorkerTimes(compute_s=times, comm_s=np.zeros(8))
    assert wa.order_stat(2) == wb.order_stat(2)
    src = ttune.as_straggler_source(lambda step, code: wb)
    draw = src.draw(0, tcode)
    assert isinstance(src, ttune.TimedSource) and src.provides_times
    assert draw.stragglers == wa.order_stat(2)[0] and draw.times is wb
    assert ttune.StragglerDraw(stragglers=(1, 9)).restrict(8).stragglers == (1,)
    assert isinstance(ttune.as_straggler_source(None), ttune.NoStragglers)
