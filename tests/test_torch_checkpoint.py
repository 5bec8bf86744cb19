"""The port's checkpoint store and the checkpointed ``Trainer``.

The reference's ``tests/test_checkpoint.py`` mirrored on the port (round
trip, shape mismatch, retention, ``keep < 1``, the torn-file fallback, a
failed save that never prunes, trainer resume and the bitwise crash
recovery, the seed and scheme warnings); then, against the reference on the
CPU: a snapshot written by either side restores on the other bit for bit
(f32, int32 and bf16 leaves, nested as the trainers save them) with the same
npz keys, a trainer of either side resumes from the other's snapshot, and
the copied ``scheme_k`` / ``scheme_loads``."""
import dataclasses
import inspect
import warnings
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.core as jcore
import repro.optim as joptim
import repro.tune.telemetry as jtelemetry
from repro.configs import get_config as jget_config
from repro.launch.mesh import make_local_mesh
from repro.models import api as japi
from repro.train import Trainer as JTrainer
from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager, restore_tree, save_tree
from repro_torch.checkpoint import store as ckpt_store
from repro_torch.configs import get_config
from repro_torch.core import make_code
from repro_torch.data import make_synthetic_batch
from repro_torch.models import api as model_api
from repro_torch.optim import get_optimizer
from repro_torch.train import Trainer
from repro_torch.tune import telemetry as ttelemetry

torch.set_num_threads(1)


def _bits(x) -> np.ndarray:
    """A leaf's bits as unsigned words (bf16 tensors and arrays included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        x = x.numpy()
    x = np.asarray(x)
    return x.view(np.dtype(f"u{x.dtype.itemsize}")) if x.dtype.kind in "fV" \
        or x.dtype == ml_dtypes.bfloat16 else x


def _leaves(tree):
    return [v for _, v in ckpt_store._leaves(tree)]


# ------------------------------------------------- the reference's tests
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_save_restore_roundtrip(tmp_path, dtype):
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              param_dtype=dtype)
    params = model_api.init(cfg, "cpu", torch.Generator().manual_seed(0))
    tree = convert.unflatten(params)
    p = tmp_path / "ckpt.npz"
    save_tree(p, tree, {"note": "hi"})
    like = convert.unflatten({k: torch.zeros_like(v) for k, v in params.items()})
    restored, meta = restore_tree(p, like)
    assert meta["note"] == "hi"
    for a, b in zip(_leaves(tree), _leaves(restored)):
        assert b.dtype == a.dtype and b.shape == a.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_restore_shape_mismatch_rejected(tmp_path):
    tree = {"w": torch.ones((4, 4))}
    p = tmp_path / "c.npz"
    save_tree(p, tree)
    with pytest.raises(ValueError):
        restore_tree(p, {"w": torch.ones((4, 5))})
    with pytest.raises(KeyError):
        restore_tree(p, {"w2": torch.ones((4, 4))})


def test_manager_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    assert mgr.steps() == [3, 4]
    restored, meta = mgr.restore_latest({"x": torch.zeros((2,))})
    assert meta["step"] == 4
    assert float(restored["x"][0]) == 4.0


def test_manager_rejects_keep_below_one(tmp_path):
    with pytest.raises(ValueError, match="keep"):
        CheckpointManager(tmp_path, keep=0)
    with pytest.raises(ValueError, match="keep"):
        CheckpointManager(tmp_path, keep=-2)


@pytest.mark.parametrize("corruption", ["truncated", "empty", "garbage"])
def test_restore_latest_falls_back_past_torn_newest(tmp_path, corruption):
    mgr = CheckpointManager(tmp_path, keep=3)
    for s in (1, 2, 3):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    p = tmp_path / "ckpt_00000003.npz"
    if corruption == "truncated":
        p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
    elif corruption == "empty":
        p.write_bytes(b"")
    else:
        p.write_bytes(b"this is not an npz archive at all")
    with pytest.warns(UserWarning, match="unreadable"):
        restored, meta = mgr.restore_latest({"x": torch.zeros((2,))})
    assert meta["step"] == 2
    assert float(restored["x"][0]) == 2.0


def test_restore_latest_all_torn_returns_none(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    for s in (1, 2):
        mgr.save(s, {"x": torch.zeros((2,))})
    for f in tmp_path.glob("ckpt_*.npz"):
        f.write_bytes(b"")
    with pytest.warns(UserWarning, match="starting fresh"):
        assert mgr.restore_latest({"x": torch.zeros((2,))}) is None


def test_restore_latest_shape_mismatch_still_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, {"x": torch.zeros((2,))})
    mgr.save(2, {"x": torch.zeros((2,))})
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore_latest({"x": torch.zeros((5,))})


def test_failed_save_never_prunes_older_snapshots(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save(1, {"x": torch.zeros((2,))})

    def torn_save(path, tree, metadata=None):
        path.write_bytes(b"torn")   # lands under the final name, unreadable

    monkeypatch.setattr(ckpt_store, "save_tree", torn_save)
    with pytest.raises(Exception):
        mgr.save(2, {"x": torch.zeros((2,))})   # verification open fails
    monkeypatch.undo()
    (tmp_path / "ckpt_00000002.npz").unlink()
    restored, meta = mgr.restore_latest({"x": torch.zeros((2,))})
    assert meta["step"] == 1


def test_trainer_resume(tmp_path):
    cfg = get_config("qwen3-1.7b").reduced()
    code = make_code(4, 3, 1, 2)
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2, seed=0,
              device="cpu")
    tr = Trainer(cfg, code, get_optimizer("sgd", 1e-2), **kw)
    rng = np.random.default_rng(0)
    batch = make_synthetic_batch(rng, cfg, 8, 16)
    for _ in range(4):
        tr.step(batch)
    assert tr._ckpt.latest_step() == 4
    tr2 = Trainer(cfg, code, get_optimizer("sgd", 1e-2), **kw)
    assert tr2._step_count == 4
    assert list(tr2.params) == list(tr.params)
    for a, b in zip(tr.params.values(), tr2.params.values()):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for k in tr.opt_state["mu"]:
        np.testing.assert_array_equal(_bits(tr.opt_state["mu"][k]),
                                      _bits(tr2.opt_state["mu"][k]))


def test_crash_recovery_trajectory_exact(tmp_path):
    """The original run checkpoints at steps 2/4/6 and "crashes" while
    writing step 6 (the file torn); the resumed run falls back to step 4,
    skips the 4 batches already inside the parameters, replays batches 5
    and 6, and reaches the original step-6 parameters bit for bit."""
    cfg = dataclasses.replace(get_config("logistic-paper"), d_model=32)
    code = make_code(4, 3, 1, 2)
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2, seed=0,
              device="cpu")

    def batches():
        rng = np.random.default_rng(123)
        while True:
            yield make_synthetic_batch(rng, cfg, 8, 0)

    tr = Trainer(cfg, code, get_optimizer("sgd", 1e-2), **kw)
    stream = batches()
    for _ in range(6):
        tr.step(next(stream))
    final = [v.clone() for v in tr.params.values()]
    assert tr._ckpt.steps() == [2, 4, 6]

    p6 = tmp_path / "ckpt_00000006.npz"
    p6.write_bytes(p6.read_bytes()[: p6.stat().st_size // 3])

    with pytest.warns(UserWarning, match="unreadable"):
        tr2 = Trainer(cfg, code, get_optimizer("sgd", 1e-2), **kw)
    assert tr2._step_count == 4
    assert tr2._data_cursor == 4
    stream2 = tr2.skip_to_cursor(batches())
    for _ in range(2):
        tr2.step(next(stream2))
    for a, b in zip(final, tr2.params.values()):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_resume_warns_on_seed_and_scheme_mismatch(tmp_path):
    cfg = dataclasses.replace(get_config("logistic-paper"), d_model=32)
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=1, device="cpu")
    tr = Trainer(cfg, make_code(4, 3, 1, 2), get_optimizer("sgd", 1e-2),
                 seed=0, **kw)
    rng = np.random.default_rng(0)
    tr.step(make_synthetic_batch(rng, cfg, 8, 0))
    with pytest.warns(UserWarning, match="seed"):
        Trainer(cfg, make_code(4, 3, 1, 2), get_optimizer("sgd", 1e-2),
                seed=1, **kw)
    with pytest.warns(UserWarning, match="scheme"):
        Trainer(cfg, make_code(4, 2, 1, 1), get_optimizer("sgd", 1e-2),
                seed=0, **kw)


# ------------------------------------------------------- the port's own
def test_restore_gives_like_device_and_type(tmp_path):
    p = tmp_path / "c.npz"
    x = torch.randn(3, 5, generator=torch.Generator().manual_seed(0))
    save_tree(p, {"a": x, "b": [x.to(torch.bfloat16), np.arange(3)],
                  "t": torch.tensor(7, dtype=torch.int32)})
    like = {"a": torch.zeros(3, 5, dtype=torch.float64),
            "b": [torch.zeros(3, 5, dtype=torch.bfloat16), np.zeros(3)],
            "t": torch.zeros((), dtype=torch.int32)}
    got, meta = restore_tree(p, like)
    assert meta == {}
    assert got["a"].dtype == torch.float64 and torch.equal(got["a"],
                                                           x.double())
    assert torch.equal(got["b"][0].view(torch.int16),
                       x.to(torch.bfloat16).view(torch.int16))
    assert isinstance(got["b"][1], np.ndarray)
    assert got["t"].shape == () and int(got["t"]) == 7
    with pytest.raises(TypeError, match="bfloat16"):
        restore_tree(p, {**like, "b": [torch.zeros(3, 5), np.zeros(3)]})


def test_trainer_refuses_only_the_tuner():
    """The auto-tuner is ported; an untimed straggler source is refused as
    the reference refuses it, and a timed one is taken."""
    from repro_torch.core.runtime_model import RuntimeParams
    from repro_torch.tune import AutotunePolicy, ShiftedExpSampler
    cfg = dataclasses.replace(get_config("logistic-paper"), d_model=32)
    with pytest.raises(ValueError, match="autotune needs per-worker timings"):
        Trainer(cfg, make_code(4, 3, 1, 2), get_optimizer("sgd", 1e-2),
                device="cpu", autotune=AutotunePolicy())
    timed = ShiftedExpSampler(RuntimeParams(n=4, lambda1=1.0, lambda2=1.0,
                                            t1=1.0, t2=1.0))
    tr = Trainer(cfg, make_code(4, 3, 1, 2), get_optimizer("sgd", 1e-2),
                 device="cpu", autotune=AutotunePolicy(),
                 straggler_source=timed)
    assert tr.autotune_events == [] and len(tr.telemetry) == 0


# ------------------------------------------------ against the reference
def _ref_tree(opt: str) -> dict:
    """A tree nested as the reference's Trainer saves it, with bf16
    parameters and the optimizer's f32 (and, for AdamW, int32) state, all
    leaves drawn from a seed."""
    cfg = dataclasses.replace(jget_config("qwen3-1.7b").reduced(),
                              param_dtype="bfloat16")
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0), cfg))
    params = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(
            ml_dtypes.bfloat16)), shapes)
    f32 = jax.tree.map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape, np.float32)),
        shapes)
    if opt == "nag":
        state = {"x_prev": f32, "lam": jnp.asarray(1.75, jnp.float32)}
    else:
        state = {"m": f32, "v": jax.tree.map(jnp.abs, f32),
                 "t": jnp.asarray(7, jnp.int32)}
    return {"params": params, "opt_state": state}


def _port_tree(ref: dict) -> dict:
    """The same leaves as the port's tree of CPU tensors, through
    ``convert`` as the trainers' states cross."""
    np_tree = jax.tree.map(np.asarray, ref)
    params = convert.params_from_jax(np_tree["params"], device="cpu")
    state = convert.opt_state_from_jax(np_tree["opt_state"], device="cpu")
    return {"params": convert.unflatten(params),
            "opt_state": {k: convert.unflatten(v) if isinstance(v, dict)
                          else v for k, v in state.items()}}


def _zeros_like(tree):
    return ckpt_store._rebuild(tree, lambda _, v: torch.zeros_like(v))


@pytest.mark.parametrize("opt", ["nag", "adamw"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshots_cross_between_reference_and_port(tmp_path, writer, opt):
    ref = _ref_tree(opt)
    port = _port_tree(ref)
    p = tmp_path / "ckpt.npz"
    if writer == "reference":
        jckpt.save_tree(p, ref, {"step": 3})
        got, meta = restore_tree(p, _zeros_like(port))
        want = port
    else:
        save_tree(p, port, {"step": 3})
        got, meta = jckpt.restore_tree(p, ref)
        want = ref
    assert meta == {"step": 3}
    got_leaves = [v for _, v in ckpt_store._leaves(got)]
    want_leaves = [v for _, v in ckpt_store._leaves(want)]
    assert len(got_leaves) == len(want_leaves) == len(jax.tree.leaves(ref))
    for a, b in zip(got_leaves, want_leaves):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_array_equal(_bits(a), _bits(b))
    if writer == "port":
        with np.load(p) as data:
            kinds = {data[k].dtype.str for k in data.files
                     if k.startswith("params//")}
        assert kinds == {"|V2"}        # bf16 as the reference writes it


@pytest.mark.parametrize("opt", ["nag", "adamw"])
def test_npz_keys_are_the_reference_bytes(tmp_path, opt):
    ref = _ref_tree(opt)
    jckpt.save_tree(tmp_path / "ref.npz", ref, {"step": 1})
    save_tree(tmp_path / "port.npz", _port_tree(ref), {"step": 1})
    names = [zipfile.ZipFile(tmp_path / f).namelist()
             for f in ("ref.npz", "port.npz")]
    assert names[0] == names[1]
    assert "params//layers//attn//wq.npy" in names[1]
    with np.load(tmp_path / "ref.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        for k in a.files:
            assert a[k].dtype.str == b[k].dtype.str, k


def _logistic():
    return dataclasses.replace(get_config("logistic-paper"), d_model=32)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_trainers_resume_from_each_others_snapshots(tmp_path, writer):
    """A trainer of one side resumes from the other's snapshot: the same
    step, cursor and parameters, and no seed or scheme warning (the scheme
    signatures' reprs agree)."""
    jcfg = dataclasses.replace(jget_config("logistic-paper"), d_model=32)
    cfg = _logistic()
    kw = dict(checkpoint_dir=str(tmp_path), checkpoint_every=2, seed=0)
    mesh = make_local_mesh(4, 1)
    rng = np.random.default_rng(9)
    batches = [make_synthetic_batch(rng, cfg, 8, 0) for _ in range(2)]

    def port():
        return Trainer(cfg, make_code(4, 3, 1, 2),
                       get_optimizer("nag", 1e-2), device="cpu", **kw)

    def reference():
        return JTrainer(jcfg, jcore.make_code(4, 3, 1, 2), mesh,
                        joptim.get_optimizer("nag", 1e-2), **kw)

    first, second = (reference, port) if writer == "reference" else \
        (port, reference)
    a = first()
    for b in batches:
        a.step(b)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        b = second()
    assert not [w for w in caught if issubclass(w.category, UserWarning)]
    assert b._step_count == 2 and b._data_cursor == 2
    assert repr(a._scheme_sig) == repr(b._scheme_sig)
    np.testing.assert_array_equal(_bits(np.asarray(a.params["beta"])),
                                  _bits(np.asarray(b.params["beta"])))
    np.testing.assert_array_equal(
        _bits(np.asarray(a.opt_state["x_prev"]["beta"])),
        _bits(np.asarray(b.opt_state["x_prev"]["beta"])))
    assert float(a.opt_state["lam"]) == float(b.opt_state["lam"])


@pytest.mark.parametrize("name", ["scheme_loads", "scheme_k"])
def test_scheme_accessors_are_the_reference_copies(name):
    assert inspect.getsource(getattr(ttelemetry, name)) == \
        inspect.getsource(getattr(jtelemetry, name))


@pytest.mark.parametrize("n,d,s,m", [(4, 3, 1, 2), (8, 4, 2, 2),
                                     (5, 2, 1, 1)])
def test_scheme_accessors_agree_with_the_reference(n, d, s, m):
    a, b = jcore.make_code(n, d, s, m), make_code(n, d, s, m)
    assert ttelemetry.scheme_loads(b) == jtelemetry.scheme_loads(a)
    assert ttelemetry.scheme_k(b) == jtelemetry.scheme_k(a)
    assert repr(Trainer._code_key(b)) == repr(JTrainer._code_key(a))
