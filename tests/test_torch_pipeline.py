"""The pipelined (stale-by-one) step of the port against the reference's, and
its contracts inside the port.

- Kernels: the plain versions of ``coded_encode_acc`` and
  ``coded_decode_apply`` against the reference's Pallas kernels in interpret
  mode (f32 2e-5, bf16 2e-2; rtol 1e-5 on ``Σg²``), and the two bitwise
  identities they promise: the accumulating encode equals
  ``acc + coded_encode(G, C, f32)``, the fused decode equals ``coded_decode``
  followed by the very update of ``optim.sgd_momentum``.
- The slice: the port's ``PipelineDriver`` trajectories against the
  reference's on ``make_local_mesh(4, 1)``, params, optimizer state and
  metrics at rtol 1e-4 / atol 1e-5 (``tests/test_torch_step.py``'s
  tolerance: both sides add in f32 in different orders).
- Inside the port, bitwise on the plain backend: fill + drain == the
  synchronous step, fused == sync on params and momentum, steady(b1, W0) ==
  sync(b0), and the same for a parameter dict with trailing dims and a
  psum-fallback leaf.
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
import repro_torch.coding as tc
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.optim as toptim
from repro.configs import get_config as jget_config
from repro.kernels.coded_decode import coded_decode_apply as jax_decode_apply
from repro.kernels.coded_encode import coded_encode_acc as jax_encode_acc
from repro.launch.mesh import make_local_mesh
from repro.train import PipelineDriver as JDriver
from repro.train.coded_step import make_coded_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.kernels import (coded_decode, coded_decode_apply,
                                 coded_decode_apply_plain, coded_encode,
                                 coded_encode_acc, coded_encode_acc_plain, ops)
from repro_torch.train import (PipelineDriver, Trainer, make_coded_train_step,
                               pipelining_supported)

torch.set_num_threads(1)

N = 4
PATTERNS = ([2], [], [0])          # one straggler pattern per chained batch
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
LR = {"sgd": 1e-2, "nag": 1e-3}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(arr, dtype):
    """The same values in both frameworks, rounded to ``dtype`` by jax."""
    j = jnp.asarray(arr, JDT[dtype])
    return j, torch.from_numpy(np.array(j, np.float32)).to(TDT[dtype])


def _f32(arr):
    arr = np.asarray(arr, np.float32)
    return jnp.asarray(arr), torch.from_numpy(arr.copy())


# ------------------------------------------------------------------ kernels
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 64, 2), (3, 96, 3), (2, 640, 4),
                                   (1, 16, 2, 128), (2, 40, 5, 96)])
def test_encode_acc_plain_matches_pallas(shape, dtype):
    rng = np.random.default_rng([3, *shape])
    Gj, Gt = _pair(rng.standard_normal(shape), dtype)
    Cj, Ct = _pair(rng.standard_normal((shape[0], shape[2])), "float32")
    out = (shape[1], shape[3]) if len(shape) == 4 else (shape[1],)
    aj, at = _f32(rng.standard_normal(out))
    want = np.asarray(jax_encode_acc(aj, Gj, Cj, interpret=True))
    got = coded_encode_acc_plain(at, Gt, Ct)
    assert got.dtype == torch.float32 and tuple(got.shape) == out
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype))
    # the wrapper on a CPU tensor: the plain version, written into acc
    acc = at.clone()
    assert coded_encode_acc(acc, Gt, Ct) is acc
    assert torch.equal(acc, got)
    # bitwise: the two-step spelling of the synchronous step
    assert torch.equal(got, at + coded_encode(Gt, Ct, out_dtype=torch.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,L,m", [(4, 128, 2), (8, 384, 3), (3, 256, 1)])
def test_decode_apply_plain_matches_pallas(n, L, m, dtype):
    rng = np.random.default_rng([4, n, L, m])
    Fj, Ft = _pair(rng.standard_normal((n, L)), dtype)
    Wj, Wt = _f32(rng.standard_normal((n, m)))
    Pj, Pt = _f32(rng.standard_normal((L, m)))
    Mj, Mt = _f32(rng.standard_normal((L, m)))
    hy = dict(lr=0.05, momentum=0.9, scale=0.5)
    pj, mj, ssj = jax_decode_apply(Fj, Wj, Pj, Mj, interpret=True, **hy)
    pt, mt, sst = coded_decode_apply_plain(Ft, Wt, Pt, Mt, **hy)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **_tol(dtype))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **_tol(dtype))
    np.testing.assert_allclose(float(sst), float(ssj[0, 0]), rtol=1e-5)
    # bitwise: coded_decode, the step's grad scaling, then sgd_momentum
    g = coded_decode(Ft, Wt, out_dtype=torch.float32) * hy["scale"]
    opt = toptim.sgd_momentum(hy["lr"], hy["momentum"])
    new_p, new_s = opt.update({"x": g}, {"mu": {"x": Mt}}, {"x": Pt})
    assert torch.equal(pt, new_p["x"]) and torch.equal(mt, new_s["mu"]["x"])
    # the wrapper on CPU tensors: the plain version, written into P and MU
    P, MU = Pt.clone(), Mt.clone()
    rp, rm, rs = coded_decode_apply(Ft, Wt, P, MU, **hy)
    assert rp is P and rm is MU
    assert torch.equal(P, pt) and torch.equal(MU, mt) and torch.equal(rs, sst)


def test_fused_ops_modes_and_refusals():
    rng = np.random.default_rng(5)
    G = torch.from_numpy(rng.standard_normal((1, 64, 2)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((1, 2)).astype(np.float32))
    acc = torch.ones(64)
    ref = ops.encode_acc(acc, G, C, mode="ref")
    assert torch.equal(acc, torch.ones(64))              # ref: untouched
    assert torch.equal(ops.encode_acc(acc, G, C), ref)   # auto: in place
    assert torch.equal(acc, ref)
    F = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32))
    hy = dict(lr=0.1, momentum=0.9, scale=1.0)
    want = ops.decode_apply(F, W, torch.ones(64, 2), torch.ones(64, 2),
                            mode="ref", **hy)
    got = ops.decode_apply(F, W, torch.ones(64, 2), torch.ones(64, 2), **hy)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    ops.reset_launch_counts()
    ops.encode_acc(acc, G, C)
    assert set(ops.launch_counts()) == {
        "coded_encode_2d", "coded_encode_3d", "coded_encode_acc_2d",
        "coded_encode_acc_3d", "coded_decode_2d", "coded_decode_3d",
        "coded_decode_apply", "flash_attention"}
    assert all(v == 0 for v in ops.launch_counts().values())
    with pytest.raises(TypeError, match="float32"):
        coded_encode_acc(acc.to(torch.bfloat16), G, C)
    with pytest.raises(ValueError):
        coded_encode_acc(torch.zeros(32), G, C)
    with pytest.raises(ValueError):
        coded_decode_apply(F, W, torch.zeros(63, 2), torch.zeros(64, 2), **hy)
    with pytest.raises(TypeError):
        coded_decode_apply(F, W, torch.zeros(64, 2, dtype=torch.bfloat16),
                           torch.zeros(64, 2), **hy)


# --------------------------------------------------------- the slice vs JAX
def _cfgs(d_model=64):
    return (dataclasses.replace(jget_config("logistic-paper"), d_model=d_model),
            dataclasses.replace(tget_config("logistic-paper"), d_model=d_model))


def _raw_batches(count=3, seed=0):
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(seed)
    return [jdata.make_synthetic_batch(rng, jcfg, 16, 0) for _ in range(count)]


def _beta():
    return (0.1 * np.random.default_rng(11).standard_normal(64)).astype(
        np.float32)


def _jax_run(schedule, opt_name, fuse, backend, raw):
    jcfg, _ = _cfgs()
    code = jcore.make_code(N, 3, 1, 2)
    opt = joptim.get_optimizer(opt_name, LR[opt_name])
    arts = jmake_step(jcfg, code, make_local_mesh(N, 1), opt,
                      spec=jc.SchemeSpec(schedule=schedule, backend=backend,
                                         pipelined=True, fuse_apply=fuse))
    batcher = jdata.CodedBatcher(code)
    params = {"beta": jnp.asarray(_beta())}
    state = opt.init(params)
    drv = JDriver(arts, donate=False)
    metrics = []
    for b, st in zip(raw, PATTERNS):
        inp = arts.step_inputs(st)
        params, state, m = drv.step(params, state,
                                    jax.tree.map(jnp.asarray, batcher.place(b)),
                                    inp["W"], inp["mask"], inp["rho"])
        metrics.append(m)
    params, state, m = drv.drain(params, state)
    metrics.append(m)
    return params, state, metrics


def _port_run(schedule, opt_name, fuse, raw, backend="auto"):
    _, tcfg = _cfgs()
    code = tcore.make_code(N, 3, 1, 2)
    opt = toptim.get_optimizer(opt_name, LR[opt_name])
    arts = make_coded_train_step(
        tcfg, code, opt, device="cpu",
        spec=tc.SchemeSpec(schedule=schedule, backend=backend, pipelined=True,
                           fuse_apply=fuse))
    batcher = tdata.CodedBatcher(code)
    params = convert.params_from_jax({"beta": _beta()})
    state = opt.init(params)
    drv = PipelineDriver(arts)
    metrics = []
    for b, st in zip(raw, PATTERNS):
        inp = arts.step_inputs(st)
        placed = batcher.place({k: torch.as_tensor(v) for k, v in b.items()})
        params, state, m = drv.step(params, state, placed, inp["W"],
                                    inp["mask"], inp["rho"])
        metrics.append(m)
    params, state, m = drv.drain(params, state)
    metrics.append(m)
    return params, state, metrics


@pytest.mark.parametrize("schedule,opt_name,fuse,backend", [
    ("gather", "sgd", False, "ref"), ("a2a", "sgd", False, "ref"),
    ("gather", "sgd", True, "pallas"), ("gather", "nag", False, "ref")])
def test_pipeline_trajectory_matches_reference(schedule, opt_name, fuse,
                                               backend):
    if len(jax.devices()) < N:
        pytest.skip(f"needs {N} devices")
    raw = _raw_batches()
    jp, js, jm = _jax_run(schedule, opt_name, fuse, backend, raw)
    tp, ts, tm = _port_run(schedule, opt_name, fuse, raw)
    assert jm[0] is None and tm[0] is None          # the fill retired nothing
    for a, b in zip(jm[1:], tm[1:]):
        for k in a:
            np.testing.assert_allclose(float(b[k]), float(a[k][0]),
                                       err_msg=k, **TRAJ_TOL)
    np.testing.assert_allclose(tp["beta"].numpy(), np.asarray(jp["beta"]),
                               **TRAJ_TOL)
    sj = jax.tree.map(np.asarray, js)
    st = convert.opt_state_to_numpy(ts)
    assert set(sj) == set(st)
    for k in sj:
        for a, b in zip(jax.tree.leaves(sj[k]), jax.tree.leaves(st[k])):
            np.testing.assert_allclose(b, a, err_msg=k, **TRAJ_TOL)


def test_opt_state_with_nonzero_momentum_roundtrips():
    mu = {"beta": _beta(), "w": {"a": np.arange(6, dtype=np.float32)}}
    state = convert.opt_state_from_jax({"mu": mu})
    assert list(state["mu"]) == ["beta", "w/a"]
    back = convert.opt_state_to_numpy(state)
    assert np.array_equal(back["mu"]["beta"], mu["beta"])
    assert np.array_equal(back["mu"]["w"]["a"], mu["w"]["a"])


# ---------------------------------------------------- contracts in the port
def _port_step_pair(schedule="gather", opt_name="sgd", fuse=False, **kw):
    _, tcfg = _cfgs()
    code = tcore.make_code(N, 3, 1, 2)
    opt = toptim.get_optimizer(opt_name, LR[opt_name])
    sync = make_coded_train_step(tcfg, code, opt, device="cpu",
                                 spec=tc.SchemeSpec(schedule=schedule), **kw)
    pipe = make_coded_train_step(
        tcfg, code, opt, device="cpu",
        spec=tc.SchemeSpec(schedule=schedule, pipelined=True,
                           fuse_apply=fuse), **kw)
    return code, opt, sync, pipe


def _placed(code, raw):
    batcher = tdata.CodedBatcher(code)
    return [batcher.place({k: torch.as_tensor(v) for k, v in b.items()})
            for b in raw]


def _assert_trees_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("schedule,opt_name,fuse", [
    ("gather", "sgd", False), ("a2a", "sgd", False), ("gather", "nag", False),
    ("gather", "sgd", True), ("a2a", "sgd", True)])
def test_fill_drain_equals_sync_bitwise(schedule, opt_name, fuse):
    code, opt, sync, pipe = _port_step_pair(schedule, opt_name, fuse)
    assert pipe.pipelined and pipe.fuse_apply == fuse
    ps = pp = convert.params_from_jax({"beta": _beta()})
    ss = sp = opt.init(ps)
    drv = PipelineDriver(pipe)
    for b, st in zip(_placed(code, _raw_batches(seed=2)), PATTERNS):
        inp = sync.step_inputs(st)
        a = (inp["W"], inp["mask"], inp["rho"])
        ps, ss, ms = sync.step(ps, ss, b, *a)
        pp, sp, mp = drv.step(pp, sp, b, *a)
        assert mp is None and drv.in_flight
        pp, sp, mp = drv.drain(pp, sp)
        assert not drv.in_flight
        _assert_trees_equal(ps, pp)
        _assert_trees_equal(ss, sp)
        if fuse:   # grad_norm sums squares in bucket order instead
            torch.testing.assert_close(mp["grad_norm"], ms["grad_norm"],
                                       rtol=1e-5, atol=1e-6)
            torch.testing.assert_close(mp["loss"], ms["loss"], rtol=1e-5,
                                       atol=1e-6)
        else:
            _assert_trees_equal(ms, mp)


@pytest.mark.parametrize("fuse", [False, True])
def test_steady_retires_the_previous_batch_exactly(fuse):
    """fill(b0) then steady(b1, W0) retires exactly the synchronous update
    of b0; its encode half belongs to b1."""
    code, opt, sync, pipe = _port_step_pair(fuse=fuse)
    b0, b1 = _placed(code, _raw_batches(count=2, seed=3))
    params = convert.params_from_jax({"beta": _beta()})
    state = opt.init(params)
    inp0, inp1 = sync.step_inputs([1]), sync.step_inputs([])
    wire = pipe.pipeline.fill(params, b0, inp0["mask"], inp0["rho"])
    assert len(wire) == pipe.pipeline.num_buffers == 2
    out = pipe.pipeline.steady(params, state, b1, inp0["W"], inp1["mask"],
                               inp1["rho"], *wire)
    ps, ss, ms = sync.step(params, state, b0, inp0["W"], inp0["mask"],
                           inp0["rho"])
    _assert_trees_equal(ps, out[0])
    _assert_trees_equal(ss, out[1])
    assert torch.equal(ms["loss"], out[2]["loss"])
    # the new wire is b1 encoded at the pre-update params
    again = pipe.pipeline.fill(params, b1, inp1["mask"], inp1["rho"])
    assert all(torch.equal(a, b) for a, b in zip(out[3:], again))


def _mlp_case():
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
        return torch.sum((h @ p["w2"] + p["b1"] - batch["t"]) ** 2)

    batches = [{"x": torch.from_numpy(
                    rng.standard_normal((16, 6)).astype(np.float32)),
                "t": torch.from_numpy(
                    rng.standard_normal((16, 7)).astype(np.float32))}
               for _ in range(3)]
    return params, loss_fn, batches


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("schedule", ["gather", "a2a"])
def test_generic_params_pipelined_equals_sync(schedule, fuse):
    """A parameter dict with a trailing-dim leaf (the 3D kernel variants)
    and a psum-fallback leaf (the side buffer)."""
    params, loss_fn, batches = _mlp_case()
    code = tcore.make_code(4, 3, 1, 2)
    opt = toptim.sgd_momentum(1e-2)
    kw = dict(device="cpu", loss_fn=loss_fn, params_like=params,
              grad_scale=1.0)
    sync = make_coded_train_step(None, code, opt,
                                 spec=tc.SchemeSpec(schedule=schedule), **kw)
    pipe = make_coded_train_step(
        None, code, opt, spec=tc.SchemeSpec(schedule=schedule, pipelined=True,
                                            fuse_apply=fuse), **kw)
    assert not pipe.plans["b1"].coded and pipe.plans["w1"].coded
    ps = pp = params
    ss = sp = opt.init(params)
    drv = PipelineDriver(pipe)
    batcher = tdata.CodedBatcher(code)
    for b, st in zip(batches, PATTERNS):
        placed = batcher.place(b)
        inp = sync.step_inputs(st)
        a = (inp["W"], inp["mask"], inp["rho"])
        ps, ss, ms = sync.step(ps, ss, placed, *a)
        drv.step(pp, sp, placed, *a)
        pp, sp, mp = drv.drain(pp, sp)
        _assert_trees_equal(ps, pp)
        _assert_trees_equal(ss, sp)
        assert torch.equal(ms["loss"], mp["loss"])
        torch.testing.assert_close(mp["grad_norm"], ms["grad_norm"],
                                   rtol=1e-5, atol=1e-6)
    # the inputs were never written: the fused path packs private buffers
    assert all(torch.equal(params[k], _mlp_case()[0][k]) for k in params)


def test_driver_drains_on_a_batch_shape_change():
    code, opt, sync, pipe = _port_step_pair()
    small, big = _raw_batches(count=1)[0], None
    _, tcfg = _cfgs()
    big = tdata.make_synthetic_batch(np.random.default_rng(9), tcfg, 32)
    b_small, b_big = _placed(code, [small, big])
    params = convert.params_from_jax({"beta": _beta()})
    state = opt.init(params)
    inp = sync.step_inputs([1])
    a = (inp["W"], inp["mask"], inp["rho"])
    drv = PipelineDriver(pipe)
    p1, s1, m = drv.step(params, state, b_small, *a)
    assert m is None and p1 is params
    # a new shape: the small batch is drained first, its metrics come back
    p2, s2, m = drv.step(p1, s1, b_big, *a)
    assert m is not None and drv.in_flight
    ps, ss, ms = sync.step(params, state, b_small, *a)
    _assert_trees_equal(ps, p2)
    assert torch.equal(ms["loss"], m["loss"])
    drv.drain(p2, s2)
    with pytest.raises(RuntimeError, match="nothing in flight"):
        drv.drain(p2, s2)
    with pytest.raises(ValueError, match="pipelined=True"):
        PipelineDriver(sync)


def test_pipelined_builder_validation():
    _, tcfg = _cfgs()
    code = tcore.make_code(N, 3, 1, 2)
    sgd = toptim.get_optimizer("sgd", 1e-2)
    with pytest.raises(ValueError, match="encoding"):
        make_coded_train_step(tcfg, code, sgd, device="cpu",
                              spec=tc.SchemeSpec(schedule="psum",
                                                 pipelined=True))
    with pytest.raises(ValueError, match="packed"):
        make_coded_train_step(tcfg, code, sgd, device="cpu",
                              spec=tc.SchemeSpec(packed=False,
                                                 pipelined=True))
    with pytest.raises(ValueError, match="partial"):
        make_coded_train_step(tcfg, code, sgd, device="cpu",
                              spec=tc.SchemeSpec(partial=True,
                                                 pipelined=True))
    with pytest.raises(ValueError, match="pipelined"):
        make_coded_train_step(tcfg, code, sgd, device="cpu",
                              spec=tc.SchemeSpec(fuse_apply=True))
    with pytest.raises(ValueError, match="sgd"):
        make_coded_train_step(
            tcfg, code, toptim.get_optimizer("nag", 1e-3), device="cpu",
            spec=tc.SchemeSpec(pipelined=True, fuse_apply=True))
    # a Schedule object gets past the spec's name check; the builder refuses
    with pytest.raises(ValueError, match="encoding"):
        make_coded_train_step(
            tcfg, code, sgd, device="cpu",
            spec=tc.SchemeSpec(schedule=tc.PsumSchedule(), pipelined=True))


def test_pipelining_supported_predicate():
    from repro_torch.comm import make_local_comm
    comm = make_local_comm(N, "cpu")
    assert not pipelining_supported(comm, "psum")      # nothing to overlap
    assert pipelining_supported(comm, "gather")
    assert pipelining_supported(comm, "a2a")


def test_trainer_pipelined_staleness_bound():
    """The twin of the reference's test: the fill step reports NaN metrics,
    every later metric describes the previous batch, and after the drain the
    trajectory lags the synchronous run by one step of gradient staleness."""
    _, tcfg = _cfgs()
    code = tcore.make_code(N, 3, 1, 2)
    steps = 6
    fixed = tdata.make_synthetic_batch(np.random.default_rng(11), tcfg, 16)

    def run(pipelined):
        tr = Trainer(tcfg, code, toptim.get_optimizer("sgd", 0.1),
                     spec=tc.SchemeSpec(pipelined=pipelined), seed=0,
                     device="cpu")
        losses = [tr.step(fixed)["loss"] for _ in range(steps)]
        if pipelined:
            assert tr._driver is not None and tr._driver.in_flight
            losses.append(tr.drain()["loss"])
            assert tr.drain() is None                 # nothing in flight
        else:
            assert tr.drain() is None
        return losses

    sync = run(False)
    pipe = run(True)
    assert np.isnan(pipe[0])
    assert not any(np.isnan(v) for v in pipe[1:])
    np.testing.assert_allclose(pipe[1], sync[0], rtol=1e-6)
    assert pipe[-1] <= sync[-2] * 1.5
    assert pipe[-1] < pipe[1] * 1e-2


# -------------------------------------------------------------- the repair
def test_pack_param_groups_returns_a_private_buffer():
    """A leaf that fills its bucket exactly (no gap, no tail) is packed into
    a new buffer: writing the buffer leaves the leaf as it was."""
    leaf = torch.arange(256, dtype=torch.float32)      # V = 128 = the align
    tree = {"w": leaf}
    plans = tc.plan_tree(tree, 2, 1)
    pplan = tc.make_pack_plan(tree, plans, m=2, n=4)
    (bucket,) = pplan.buckets
    assert bucket.padding == 0 and len(bucket.slots) == 1
    buf = tc.pack_param_groups([leaf], bucket, 2)
    assert buf.shape == (128, 2) and buf.is_contiguous()
    assert buf.untyped_storage().data_ptr() != leaf.untyped_storage().data_ptr()
    buf.fill_(-1.0)
    assert torch.equal(leaf, torch.arange(256, dtype=torch.float32))
