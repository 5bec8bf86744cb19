"""Coded training of the dense LM (reduced ``qwen3-1.7b``, S = 64) through
the pipelined step and the packed wire:

- the pipelined ``Trainer`` with the fused decode + SGD-momentum, 3 steps
  and a drain, against the reference's (``lm_train_cases.py`` says how, and
  to what tolerance);
- inside the port, bitwise on the plain backend: fill + drain equals the
  synchronous step (params, optimizer state and loss; fused and not),
  chained over two batches with other stragglers, and the packed wire's
  decoded gradient equals the per-leaf one for both schedules.
"""
import jax
import numpy as np
import pytest
import torch

import lm_train_cases as cases
from repro_torch.coding import SchemeSpec
from repro_torch.configs import get_config
from repro_torch.core import make_code
from repro_torch.data import CodedBatcher, make_synthetic_batch
from repro_torch.models import api
from repro_torch.optim import sgd_momentum
from repro_torch.train import PipelineDriver, make_coded_train_step

torch.set_num_threads(1)

PATTERNS = ((2,), (0,))


def test_lm_pipelined_trajectory_matches_reference():
    if len(jax.devices()) < cases.CODE[0]:
        pytest.skip(f"needs {cases.CODE[0]} devices")
    cases.check_trajectory("gather", "sgd", True)


def _setup():
    cfg = get_config("qwen3-1.7b").reduced()
    code = make_code(*cases.CODE)
    params = api.init(cfg, "cpu", torch.Generator().manual_seed(4))
    rng = np.random.default_rng(8)
    batcher = CodedBatcher(code)
    placed = [batcher.place({k: torch.from_numpy(v) for k, v in
                             make_synthetic_batch(rng, cfg, 4, 64).items()})
              for _ in PATTERNS]
    return cfg, code, params, placed


def _assert_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_equal(a[k], b[k])
        else:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("fuse", [False, True])
def test_lm_fill_drain_equals_sync_bitwise(fuse):
    cfg, code, params, placed = _setup()
    opt = sgd_momentum(1e-2)
    sync = make_coded_train_step(cfg, code, opt, device="cpu")
    pipe = make_coded_train_step(
        cfg, code, opt, device="cpu",
        spec=SchemeSpec(pipelined=True, fuse_apply=fuse))
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
        if not fuse:
            assert torch.equal(ms["grad_norm"], mp["grad_norm"])


@pytest.mark.parametrize("schedule", ["gather", "a2a"])
def test_lm_packed_equals_per_leaf_bitwise(schedule):
    cfg, code, params, placed = _setup()
    grads = []
    for packed in (True, False):
        arts = make_coded_train_step(
            cfg, code, sgd_momentum(1e-2), device="cpu",
            spec=SchemeSpec(schedule=schedule, packed=packed))
        assert (arts.pack_plan is not None) == packed
        inp = arts.step_inputs(PATTERNS[0])
        g, m = arts.aggregate(params, placed[0], inp["W"], inp["mask"],
                              inp["rho"])
        assert np.isfinite(float(m["loss"]))
        grads.append(g)
    _assert_equal(*grads)


def test_unpacked_leaves_own_their_memory():
    """The fused apply's unpacked params and momentum (and a decoded
    gradient) never view the packed bucket: a 1-D leaf that would is
    copied, so the bucket dies with the step instead of living on with
    the leaf."""
    cfg, code, params, _ = _setup()
    arts = make_coded_train_step(cfg, code, sgd_momentum(1e-2), device="cpu")
    flat = list(params.values())
    bufs = arts.codec.pack_params(flat, arts.pack_plan)
    ptrs = {b.untyped_storage().data_ptr() for b in bufs}
    for out in (arts.codec.unpack_params(bufs, arts.pack_plan, flat),
                arts.codec.unpack(bufs, arts.pack_plan)):
        assert set(out) == set(range(len(flat)))
        assert all(torch.equal(out[i], flat[i]) for i in out)
        assert all(v.untyped_storage().data_ptr() not in ptrs
                   for v in out.values())
