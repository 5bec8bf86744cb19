"""Tests of the port that need the card (marker ``gpu``): they build the
CUDA kernels with nvcc and launch them.  Run them on a machine with an
NVIDIA GPU with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card each test skips.  This file imports nothing of JAX, so it
also runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.kernels import (coded_decode, coded_decode_apply,
                                 coded_decode_apply_plain, coded_decode_plain,
                                 coded_encode, coded_encode_acc,
                                 coded_encode_acc_plain, coded_encode_plain,
                                 ops)

torch.set_num_threads(1)


@pytest.mark.gpu
def test_kernels_match_plain_on_the_card():
    """Builds the CUDA kernels and holds each rank variant against its plain
    version; needs an NVIDIA GPU and nvcc (``chip_smoke.py`` runs the full
    sweep)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator().manual_seed(0)
    for shape in [(3, 96, 3), (2, 40, 5, 96)]:
        G = torch.randn(*shape, generator=g).cuda()
        C = torch.randn(shape[0], shape[2], generator=g).cuda()
        torch.testing.assert_close(coded_encode(G, C),
                                   coded_encode_plain(G, C),
                                   rtol=2e-5, atol=2e-5)
    for shape in [(16, 513), (4, 32, 128)]:
        F = torch.randn(*shape, generator=g).cuda()
        W = torch.randn(shape[0], 3, generator=g).cuda()
        torch.testing.assert_close(coded_decode(F, W),
                                   coded_decode_plain(F, W),
                                   rtol=2e-5, atol=2e-5)
    counts = ops.launch_counts()
    assert all(counts[k] >= 1 for k in ("coded_encode_2d", "coded_encode_3d",
                                        "coded_decode_2d", "coded_decode_3d")), \
        counts


@pytest.mark.gpu
def test_wrappers_never_fall_back_on_the_card():
    """A CUDA tensor the kernel does not take raises; nothing quietly runs
    the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    G = torch.randn(2, 64, 2).cuda()
    with pytest.raises(ValueError, match="contiguous"):
        coded_encode(G.transpose(1, 2).contiguous().transpose(1, 2), G[:, 0])
    with pytest.raises(TypeError):
        coded_encode(G.double(), G[:, 0])
    with pytest.raises(ValueError):
        coded_decode(G[0], torch.zeros(64, 2))      # W left on the CPU


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule,packed", [("gather", True), ("a2a", True),
                                             ("a2a", False)])
def test_step_on_the_card_matches_plain_backend(schedule, packed, wire):
    """Three coded steps with stragglers at a narrow width: the kernels and
    the plain backend, both on the card, end at the same parameters."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import dataclasses

    import numpy as np

    from repro_torch.coding import SchemeSpec
    from repro_torch.configs import get_config
    from repro_torch.core import make_code
    from repro_torch.data import make_synthetic_batch
    from repro_torch.optim import sgd_momentum
    from repro_torch.train import Trainer
    from repro_torch.tune import FixedStragglers
    cfg = dataclasses.replace(get_config("logistic-paper"), d_model=4096)
    batch = make_synthetic_batch(np.random.default_rng(0), cfg, 64)
    betas = {}
    for backend in ("hopper", "ref"):
        tr = Trainer(cfg, make_code(8, 4, 2, 2), sgd_momentum(1e-4),
                     spec=SchemeSpec(schedule=schedule, packed=packed,
                                     encode_dtype=wire, backend=backend),
                     straggler_source=FixedStragglers((2, 5)))
        assert tr.arts.coded_fraction == 1.0
        before = ops.launch_counts()
        logs = [tr.step(batch) for _ in range(3)]
        launched = sum(ops.launch_counts().values()) - sum(before.values())
        assert (launched > 0) == (backend == "hopper")
        assert logs[-1]["loss"] < logs[0]["loss"]
        betas[backend] = tr.params["beta"]
    tol = 1e-4 if wire == "float32" else 2e-2
    scale = betas["ref"].abs().max().item()
    torch.testing.assert_close(betas["hopper"], betas["ref"], rtol=tol,
                               atol=tol * scale)


HYPER = {"lr": 1e-2, "momentum": 0.9, "scale": 0.5}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_match_plain_on_the_card(dtype):
    """The pipelined step's kernels against their plain versions, and bit
    for bit against the two-step spellings of the synchronous step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(1)
    for shape in [(1, 1001, 2), (3, 96, 3), (2, 40, 5, 96)]:
        G = torch.randn(*shape, generator=g).to(dtype).cuda()
        C = torch.randn(shape[0], shape[2], generator=g).cuda()
        out = (shape[1], shape[3]) if len(shape) == 4 else (shape[1],)
        acc0 = torch.randn(*out, generator=g).cuda()
        acc = acc0.clone()
        assert coded_encode_acc(acc, G, C) is acc
        torch.testing.assert_close(acc, coded_encode_acc_plain(acc0, G, C),
                                   rtol=tol, atol=tol)
        assert torch.equal(acc, acc0 + coded_encode(G, C,
                                                    out_dtype=torch.float32))
    for n, L, m in [(8, 1001, 2), (5, 77, 11)]:
        F = torch.randn(n, L, generator=g).to(dtype).cuda()
        W = torch.randn(n, m, generator=g).cuda()
        P0 = torch.randn(L, m, generator=g).cuda()
        MU0 = torch.randn(L, m, generator=g).cuda()
        P, MU = P0.clone(), MU0.clone()
        pn, mun, ss = coded_decode_apply(F, W, P, MU, **HYPER)
        assert pn is P and mun is MU
        wp, wm, wss = coded_decode_apply_plain(F, W, P0, MU0, **HYPER)
        torch.testing.assert_close(pn, wp, rtol=tol, atol=tol)
        torch.testing.assert_close(mun, wm, rtol=tol, atol=tol)
        torch.testing.assert_close(ss, wss, rtol=1e-5, atol=0)
        gd = coded_decode(F, W, out_dtype=torch.float32) * HYPER["scale"]
        mu = HYPER["momentum"] * MU0 + gd
        assert torch.equal(mun, mu) and torch.equal(pn, P0 - HYPER["lr"] * mu)


@pytest.mark.gpu
def test_fused_wrappers_never_fall_back_on_the_card():
    """A CUDA operand the fused kernels do not take raises; a CPU one takes
    the plain version without a launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    G, C = torch.randn(1, 64, 2).cuda(), torch.randn(1, 2).cuda()
    with pytest.raises(TypeError):
        coded_encode_acc(torch.zeros(64, dtype=torch.bfloat16).cuda(), G, C)
    with pytest.raises(ValueError, match="contiguous"):
        coded_encode_acc(torch.zeros(128).cuda()[::2], G, C)
    with pytest.raises(ValueError):
        coded_encode_acc(torch.zeros(64), G, C)       # acc left on the CPU
    F, W = torch.randn(4, 128).cuda(), torch.randn(4, 2).cuda()
    shared = torch.zeros(4 * 128 + 256).cuda()
    with pytest.raises(AssertionError):
        coded_decode_apply(shared[:512].view(4, 128), W,
                           shared[256:512].view(128, 2),
                           torch.zeros(128, 2).cuda(), **HYPER)
    with pytest.raises(TypeError):
        coded_decode_apply(F, W, torch.zeros(128, 2).cuda().double(),
                           torch.zeros(128, 2).cuda(), **HYPER)
    before = ops.launch_counts()
    coded_encode_acc(torch.zeros(64), G.cpu(), C.cpu())
    coded_decode_apply(F.cpu(), W.cpu(), torch.zeros(128, 2),
                       torch.zeros(128, 2), **HYPER)
    assert ops.launch_counts() == before


@pytest.mark.gpu
def test_pipelined_fused_trainer_equals_sync_on_the_card():
    """Per batch, the pipelined fused Trainer's fill + drain equals the
    synchronous Trainer's step bit for bit, chained over 2 batches, with
    the kernels on both sides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import dataclasses

    import numpy as np

    from repro_torch.coding import SchemeSpec
    from repro_torch.configs import get_config
    from repro_torch.core import make_code
    from repro_torch.data import make_synthetic_batch
    from repro_torch.optim import sgd_momentum
    from repro_torch.train import Trainer
    from repro_torch.tune import FixedStragglers
    cfg = dataclasses.replace(get_config("logistic-paper"), d_model=4096)
    rng = np.random.default_rng(0)
    batches = [make_synthetic_batch(rng, cfg, 64) for _ in range(2)]

    def trainer(spec):
        return Trainer(cfg, make_code(8, 4, 2, 2), sgd_momentum(1e-4),
                       spec=spec, straggler_source=FixedStragglers((2, 5)))
    sync = trainer(SchemeSpec())
    pipe = trainer(SchemeSpec(pipelined=True, fuse_apply=True))
    before = ops.launch_counts()
    for b in batches:
        ms = sync.step(b)
        assert np.isnan(pipe.step(b)["loss"])
        mp = pipe.drain()
        assert torch.equal(sync.params["beta"], pipe.params["beta"])
        assert torch.equal(sync.opt_state["mu"]["beta"],
                           pipe.opt_state["mu"]["beta"])
        assert mp["loss"] == ms["loss"]
    after = ops.launch_counts()
    assert after["coded_decode_apply"] - before["coded_decode_apply"] == 2
    assert after["coded_encode_acc_2d"] - before["coded_encode_acc_2d"] == 64


@pytest.mark.gpu
def test_leaf_grouped_on_a_later_dim_on_the_card():
    """A leaf whose grouping dimension is not its first comes out of the
    leaf-to-groups reshape strided: the encode kernels still get a
    contiguous operand, and the pipelined fused update equals the
    synchronous one bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.coding import SchemeSpec
    from repro_torch.core import make_code
    from repro_torch.data import CodedBatcher
    from repro_torch.optim import sgd_momentum
    from repro_torch.train import PipelineDriver, make_coded_train_step
    g = torch.Generator().manual_seed(2)
    params = {"w": (0.1 * torch.randn(16, 128, generator=g)).cuda()}
    batch = {"x": torch.randn(32, 16, generator=g).cuda()}

    def loss_fn(p, b):
        return torch.sum(torch.tanh(b["x"] @ p["w"]) ** 2)

    code, opt = make_code(4, 3, 1, 2), sgd_momentum(1e-2)
    placed = CodedBatcher(code).place(batch)
    kw = dict(loss_fn=loss_fn, params_like=params, grad_scale=1.0)
    sync = make_coded_train_step(None, code, opt, **kw)
    assert sync.plans["w"].group_dim == 1
    pipe = make_coded_train_step(
        None, code, opt, spec=SchemeSpec(pipelined=True, fuse_apply=True), **kw)
    inp = sync.step_inputs((1,))
    a = (inp["W"], inp["mask"], inp["rho"])
    ps, ss, _ = sync.step(params, opt.init(params), placed, *a)
    drv = PipelineDriver(pipe)
    drv.step(params, opt.init(params), placed, *a)
    pp, sp, _ = drv.drain(params, opt.init(params))
    assert torch.equal(ps["w"], pp["w"])
    assert torch.equal(ss["mu"]["w"], sp["mu"]["w"])
