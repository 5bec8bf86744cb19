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


# the encode sweeps of chip_smoke.py (the serving path's encode shape too)
ENC2D = [(1, 8, 1), (3, 64, 2), (5, 640, 4), (8, 1024, 8), (31, 96, 3),
         (2, 1001, 7), (1, 171737, 2), (1, 75968, 2)]
ENC3D = [(3, 16, 2, 128), (4, 256, 2, 64), (2, 40, 5, 96), (2, 7, 3, 33),
         (1, 3072, 2, 2048)]
ACC2D = [(1, 8, 1), (3, 64, 2), (5, 640, 4), (2, 1001, 7), (1, 171737, 2)]
ACC3D = [(2, 7, 3, 33), (2, 40, 5, 96), (3, 16, 2, 128), (1, 3072, 2, 2048)]
# the edges of the vector path: R of 1-9 and 33 (a multiple of the vector
# or not), V tails of the 2D path, 2D G[j] slabs of V*m elements that are
# or are not whole vectors, and the register forms m = 1..4 beside the
# general one (d*m > 8, m > 4)
EDGE3D = [(1, 5, 2, r) for r in range(1, 10)] + [(2, 7, 2, 33), (2, 3, 4, 8),
                                                 (1, 9, 1, 16), (3, 4, 3, 8)]
EDGE2D = [(1, v, 2) for v in (1, 3, 4, 5, 7, 8, 9, 17)] + [
    (2, 37, 3), (2, 33, 4), (2, 36, 2), (8, 13, 1), (1, 1001, 1), (3, 64, 4),
    (1, 21, 5)]


def _offset_copy(x):
    """``x``'s values in a contiguous view whose base lies one element past
    an aligned allocation: the kernel's scalar path."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def _enc_inputs(g, shape, dtype):
    G = torch.randn(*shape, generator=g).to(dtype).cuda()
    C = torch.randn(shape[0], shape[2], generator=g).cuda()
    out = (shape[1], shape[3]) if len(shape) == 4 else (shape[1],)
    return G, C, torch.randn(*out, generator=g).cuda()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_kernels_match_plain_and_paths_agree_bitwise_on_the_card(dtype):
    """All four encode variants against their plain versions at the sweeps
    of chip_smoke.py; at every shape the scalar path (G, or acc, as a view
    one element off an aligned base) gives the aligned call's bits, and the
    fused fold equals ``acc + coded_encode(G, C, f32)`` bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.coded_encode import encode_path
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(3)
    ops.reset_launch_counts()
    for shape in ENC2D + ENC3D:
        G, C, _ = _enc_inputs(g, shape, dtype)
        G1 = _offset_copy(G)
        for out_dtype in (None, torch.float32):
            got = coded_encode(G, C, out_dtype=out_dtype)
            want = coded_encode_plain(G, C, out_dtype=out_dtype)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                       atol=tol)
            assert encode_path(G1, got) == "scalar"
            assert torch.equal(coded_encode(G1, C, out_dtype=out_dtype), got)
    for shape in ACC2D + ACC3D:
        G, C, acc0 = _enc_inputs(g, shape, dtype)
        acc = acc0.clone()
        assert coded_encode_acc(acc, G, C) is acc
        torch.testing.assert_close(acc, coded_encode_acc_plain(acc0, G, C),
                                   rtol=tol, atol=tol)
        assert torch.equal(acc, acc0 + coded_encode(G, C,
                                                    out_dtype=torch.float32))
        for G_, acc_ in ((_offset_copy(G), acc0.clone()), (G, _offset_copy(acc0))):
            assert encode_path(G_, acc_) == "scalar"
            assert torch.equal(coded_encode_acc(acc_, G_, C), acc)
    paths = {k: v for k, v in ops.path_counts().items()
             if k.startswith("coded_encode")}
    # the main path's shapes take the vector path where they are aligned
    assert all(paths[k]["vector"] > 0 and paths[k]["scalar"] > 0
               for k in paths), paths


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encode_edges_are_bitwise_on_the_card(dtype):
    """R of 1-9 and 33, 2D V tails, the register forms and the general
    one: each against the plain version, and the aligned call (vector where
    the shape allows it) bit for bit equal to the scalar path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.coded_encode import encode_path
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    per_vector = 16 // torch.empty((), dtype=dtype).element_size()
    g = torch.Generator().manual_seed(4)
    for shape in EDGE3D + EDGE2D:
        G, C, acc0 = _enc_inputs(g, shape, dtype)
        d, _, m = shape[:3]
        got = coded_encode(G, C, out_dtype=torch.float32)
        want = coded_encode_plain(G, C, out_dtype=torch.float32)
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        whole = (shape[3] % per_vector == 0 if len(shape) == 4
                 else d == 1 or shape[1] * m % per_vector == 0)
        vector = m <= 4 and d * m <= 8 and whole
        assert encode_path(G, got) == ("vector" if vector else "scalar")
        assert torch.equal(coded_encode(_offset_copy(G), C,
                                        out_dtype=torch.float32), got)
        assert torch.equal(coded_encode(G, C), got.to(dtype))
        acc = acc0.clone()
        coded_encode_acc(acc, G, C)
        assert torch.equal(acc, acc0 + got)
        assert torch.equal(coded_encode_acc(_offset_copy(acc0), G, C), acc)


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


# the edges of the 2D decode's vector path: n of 1 to 64 (W in registers
# for n*m <= 16, in shared memory above), every m of the vector path, and V
# with rows that are whole vectors (8, 64, 1000) or not (37, with n = 1 a
# ragged tail on the vector path)
DEC_N = (1, 3, 4, 8, 17, 64)
DEC_M = (1, 2, 3, 4, 8)
DEC_V = (8, 37, 64, 1000)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_paths_agree_bitwise_on_the_card(dtype):
    """Every (n, m, V) of the edges: the aligned call (vector path where the
    rule allows it) against the plain version, and bit for bit equal to the
    scalar path (F one element off an aligned base), in both output types."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.coded_decode import decode_path
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(6)
    ops.reset_launch_counts()
    for n in DEC_N:
        for m in DEC_M:
            for V in DEC_V:
                F = torch.randn(n, V, generator=g).to(dtype).cuda()
                W = torch.randn(n, m, generator=g).cuda()
                F1 = _offset_copy(F)
                for out_dtype in (None, torch.float32):
                    got = coded_decode(F, W, out_dtype=out_dtype)
                    want = coded_decode_plain(F, W, out_dtype=out_dtype)
                    torch.testing.assert_close(got.float(), want.float(),
                                               rtol=tol, atol=tol)
                    whole = n == 1 or V * F.element_size() % 16 == 0
                    assert decode_path(F, got) == ("vector" if whole else "scalar")
                    assert decode_path(F1, got) == "scalar"
                    assert torch.equal(coded_decode(F1, W, out_dtype=out_dtype),
                                       got), (n, m, V, out_dtype)
    paths = ops.path_counts()["coded_decode_2d"]
    assert paths["vector"] > 0 and paths["scalar"] > 0, paths


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_apply_is_decode_plus_sgd_bitwise_on_the_card(dtype):
    """p' and mu' equal coded_decode followed by the sgd_momentum
    expressions bit for bit on both paths; Σg² is within 1e-5 of the plain
    version's and the same over two calls; one kernel a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels.coded_decode import apply_path
    g = torch.Generator().manual_seed(7)
    for n, L, m in [(8, 171776, 2), (4, 1000, 1), (17, 64, 3), (64, 256, 8),
                    (1, 37, 4), (8, 1001, 2), (5, 77, 11)]:
        F = torch.randn(n, L, generator=g).to(dtype).cuda()
        W = torch.randn(n, m, generator=g).cuda()
        P0 = torch.randn(L, m, generator=g).cuda()
        MU0 = torch.randn(L, m, generator=g).cuda()
        gd = coded_decode(F, W, out_dtype=torch.float32) * HYPER["scale"]
        mu = HYPER["momentum"] * MU0 + gd
        p = P0 - HYPER["lr"] * mu
        _, _, wss = coded_decode_apply_plain(F, W, P0, MU0, **HYPER)
        for F_, P, MU in ((F, P0.clone(), MU0.clone()),
                          (_offset_copy(F), P0.clone(), MU0.clone()),
                          (F, _offset_copy(P0), _offset_copy(MU0))):
            n0 = ops.launch_counts()["coded_decode_apply"]
            pn, mun, ss = coded_decode_apply(F_, W, P, MU, **HYPER)
            assert ops.launch_counts()["coded_decode_apply"] == n0 + 1
            assert torch.equal(pn, p) and torch.equal(mun, mu), \
                (n, L, m, apply_path(F_, P, MU))
            torch.testing.assert_close(ss, wss, rtol=1e-5, atol=0)
            P.copy_(P0)
            MU.copy_(MU0)
            assert torch.equal(coded_decode_apply(F_, W, P, MU, **HYPER)[2], ss)


@pytest.mark.gpu
def test_decode_apply_on_two_streams_on_the_card():
    """Two streams launch the fused kernel at once, many times over (the
    pipelined step's side stream beside the current one): each has a
    counter of its own, so each call's p', mu' and Σg² equal those of the
    same call alone on one stream."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator().manual_seed(8)
    n, L, m = 8, 171776, 2
    inputs = [(torch.randn(n, L, generator=g).cuda(),
               torch.randn(n, m, generator=g).cuda(),
               torch.randn(L, m, generator=g).cuda(),
               torch.randn(L, m, generator=g).cuda()) for _ in range(2)]
    want = []
    for F, W, P0, MU0 in inputs:
        pn, mun, ss = coded_decode_apply(F, W, P0.clone(), MU0.clone(), **HYPER)
        want.append((pn.clone(), mun.clone(), ss.clone()))
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    state = [(P0.clone(), MU0.clone()) for _, _, P0, MU0 in inputs]
    torch.cuda.synchronize()
    for _ in range(20):
        got = []
        for st, (F, W, _, _), (P, MU) in zip(streams, inputs, state):
            with torch.cuda.stream(st):
                P.copy_(inputs[len(got)][2])
                MU.copy_(inputs[len(got)][3])
                got.append(coded_decode_apply(F, W, P, MU, **HYPER))
        torch.cuda.synchronize()
        for (pn, mun, ss), (wp, wmu, wss) in zip(got, want):
            assert torch.equal(pn, wp) and torch.equal(mun, wmu)
            assert torch.equal(ss, wss)


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


FLASH_SWEEP = [
    (2, 256, 4, 2, 64, "causal", 0, 0),
    (1, 128, 2, 2, 32, "full", 0, 0),
    (2, 256, 4, 4, 64, "window", 64, 0),
    (1, 192, 4, 1, 128, "causal", 0, 0),     # MQA, S not a tile multiple
    (1, 100, 4, 2, 128, "causal", 0, 60),    # query offset, ragged tiles
    (1, 96, 2, 1, 64, "window", 40, 70),
    (1, 200, 4, 2, 32, "causal", 0, 0),      # hd 32, ragged S
    (1, 256, 8, 2, 128, "causal", 0, 0),     # q_per_kv = 4
    (2, 300, 4, 2, 64, "window", 96, 40),    # B > 1, window, query offset
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain_on_the_card(dtype):
    """The flash attention kernel against its plain version (the
    reference's online_attention loop) on the sweep of tests/test_kernels.py
    plus query offsets, within 2e-5 (f32) / 2e-2 (bf16); each call
    launches the kernel once and never the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attn
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    g = torch.Generator().manual_seed(0)
    for B, Sq, H, Hkv, hd, kind, w, p0 in FLASH_SWEEP:
        q = torch.randn(B, Sq, H, hd, generator=g).to(dtype).cuda()
        k = torch.randn(B, Sq + p0, Hkv, hd, generator=g).to(dtype).cuda()
        v = torch.randn(B, Sq + p0, Hkv, hd, generator=g).to(dtype).cuda()
        n0 = flash_attn.LAUNCHES["flash_attention"]
        plain0 = flash_attn.PLAIN_CALLS["flash_attention"]
        got = flash_attn.flash_attention_gqa(q, k, v, H // Hkv, mask_kind=kind,
                                             window=w, kv_pos0=p0)
        assert flash_attn.LAUNCHES["flash_attention"] == n0 + 1
        assert flash_attn.PLAIN_CALLS["flash_attention"] == plain0
        want = flash_attn.flash_attention_gqa_plain(
            q, k, v, H // Hkv, mask_kind=kind, window=w, kv_pos0=p0)
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.zeros(1, 64, 2, 48, device="cuda")
        flash_attn.flash_attention_gqa(x, x, x, 1)
    with pytest.raises(TypeError):
        x = torch.zeros(1, 64, 2, 64, device="cuda")
        flash_attn.flash_attention_gqa(x, x.bfloat16(), x, 1)


@pytest.mark.gpu
def test_flash_kernel_refuses_what_it_cannot_take_on_the_card():
    """TMA's 16-byte alignment of strides and bases is refused, never
    copied round; under grad mode an input that requires grad goes through
    the backward kernel (its gradient matches the plain version's
    autograd), under no_grad the forward runs alone; views of one fused
    projection are read in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attn
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 64, 2, 64, generator=g).cuda()
    needs_grad = x.clone().requires_grad_()
    n0 = flash_attn.LAUNCHES["flash_attention"]
    with pytest.raises(ValueError, match="stride"):
        flash_attn.flash_attention_gqa(
            torch.zeros(1, 64, 2, 66, device="cuda")[..., :64], x, x, 1)
    with pytest.raises(ValueError, match="data_ptr"):
        flash_attn.flash_attention_gqa(
            x, torch.zeros(64 * 2 * 64 + 1, device="cuda")[1:].view(x.shape),
            x, 1)
    assert flash_attn.LAUNCHES["flash_attention"] == n0
    with torch.no_grad():
        out = flash_attn.flash_attention_gqa(needs_grad, x, x, 1)
    assert not out.requires_grad
    b0 = flash_attn.LAUNCHES["flash_attention_bwd"]
    out = flash_attn.flash_attention_gqa(needs_grad, x, x, 1)
    (gq,) = torch.autograd.grad(out, needs_grad, x)
    assert flash_attn.LAUNCHES["flash_attention_bwd"] == b0 + 1
    ref = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(
        flash_attn.flash_attention_gqa_plain(ref, x, x, 1), ref, x)
    torch.testing.assert_close(gq, want, rtol=1e-4, atol=1e-4)
    qkv = torch.randn(2, 128, 8 + 2 * 2, 128, generator=g).cuda()
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    got = flash_attn.flash_attention_gqa(q, k, v, 4)
    want = flash_attn.flash_attention_gqa_plain(q, k, v, 4)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


# the sweep above, then the backward's own edges: a key tile past every
# query (query offset 0, keys > queries), a window whose key tiles begin
# mid-sequence, hd 32 and 64 with ragged S; at the tensor-core tiles' edges
# (32 and 64 rows): an S that is no multiple of either at hd 128, q_per_kv
# = 4 with a window and a query offset, hd 32 (64-byte bf16 rows) with
# q_per_kv = 4 and a window
FLASH_BWD_SWEEP = FLASH_SWEEP + [
    (1, 200, 4, 2, 64, "causal", 0, 0),
    (1, 300, 4, 2, 128, "window", 70, 0),
    (2, 130, 4, 4, 32, "full", 0, 0),
    (1, 1000, 16, 8, 128, "causal", 0, 0),
    (2, 97, 8, 2, 64, "window", 33, 5),
    (1, 160, 8, 2, 32, "window", 48, 16),
]
FLASH_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}   # relative norm


def flash_grads(fn, q, k, v, dout, **kw):
    """(out, dq, dk, dv) of ``fn`` at fresh leaves with q, k, v's values."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = fn(*leaves, q.shape[2] // k.shape[2], **kw)
    return (out, *torch.autograd.grad(out, leaves, dout))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_matches_plain_autograd_on_the_card(dtype):
    """The backward kernel's dq, dk, dv against the plain version's autograd
    on the card (TF32 off): f32 within 1e-5 in relative error norm and
    1e-4 of the largest plain gradient elementwise, bf16 within 2e-2 in
    relative norm; one backward launch a call, no plain call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attn
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(2)
    for B, Sq, H, Hkv, hd, kind, w, p0 in FLASH_BWD_SWEEP:
        q = torch.randn(B, Sq, H, hd, generator=g).to(dtype).cuda()
        k = torch.randn(B, Sq + p0, Hkv, hd, generator=g).to(dtype).cuda()
        v = torch.randn(B, Sq + p0, Hkv, hd, generator=g).to(dtype).cuda()
        dout = torch.randn(B, Sq, H, hd, generator=g).to(dtype).cuda()
        kw = dict(mask_kind=kind, window=w, kv_pos0=p0)
        n0 = flash_attn.LAUNCHES["flash_attention_bwd"]
        plain0 = flash_attn.PLAIN_CALLS["flash_attention"]
        got = flash_grads(flash_attn.flash_attention_gqa, q, k, v, dout, **kw)
        assert flash_attn.LAUNCHES["flash_attention_bwd"] == n0 + 1
        assert flash_attn.PLAIN_CALLS["flash_attention"] == plain0
        want = flash_grads(flash_attn.flash_attention_gqa_plain, q, k, v,
                           dout, **kw)
        for name, a, b in zip(("dq", "dk", "dv"), got[1:], want[1:]):
            assert a.dtype == dtype and a.shape == b.shape
            a, b = a.float(), b.float()
            rel = ((a - b).norm() / b.norm()).item()
            assert rel <= FLASH_BWD_TOL[dtype], (name, B, Sq, kind, rel)
            if dtype == torch.float32:
                assert (a - b).abs().max() <= 1e-4 * b.abs().max(), name


@pytest.mark.gpu
def test_flash_backward_repeats_its_bits_and_lse_leaves_forward_alone():
    """Two backward calls on the same inputs give the same bits (no
    atomics), and the forward's output with the residual written is the
    output without it, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.kernels import flash_attn
    g = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        for B, Sq, H, Hkv, hd, kind, w, p0 in FLASH_BWD_SWEEP:
            q = torch.randn(B, Sq, H, hd, generator=g).to(dtype).cuda()
            k = torch.randn(B, Sq + p0, Hkv, hd, generator=g).to(dtype).cuda()
            v = torch.randn(B, Sq + p0, Hkv, hd, generator=g).to(dtype).cuda()
            dout = torch.randn(B, Sq, H, hd, generator=g).to(dtype).cuda()
            a = flash_attn._forward(q, k, v, kind, w, p0, residual=False)[0]
            b, lse = flash_attn._forward(q, k, v, kind, w, p0, residual=True)
            assert torch.equal(a, b)
            assert torch.isfinite(lse).all()
            one = flash_attn.flash_attention_bwd(q, k, v, b, lse, dout,
                                                 mask_kind=kind, window=w,
                                                 kv_pos0=p0)
            two = flash_attn.flash_attention_bwd(q, k, v, b, lse, dout,
                                                 mask_kind=kind, window=w,
                                                 kv_pos0=p0)
            for x, y in zip(one, two):
                assert torch.equal(x, y)


@pytest.mark.gpu
def test_flash_backward_launches_from_a_fresh_thread():
    """The backward's first CUDA call on a thread that has made none (as on
    the thread where autograd runs a backward): the tensor maps are encoded
    with the device's context bound, and the gradient is the one the main
    thread computes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import threading

    from repro_torch.kernels import flash_attn
    g = torch.Generator().manual_seed(4)
    q, k, v, dout = (torch.randn(1, 64, 2, 64, generator=g).cuda()
                     for _ in range(4))
    out, lse = flash_attn._forward(q, k, v, "causal", 0, 0, residual=True)
    want = flash_attn.flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    got = {}

    def run():
        try:
            got["grads"] = flash_attn.flash_attention_bwd(q, k, v, out, lse, dout)
        except Exception as e:          # reported on the test's thread
            got["error"] = e
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert "error" not in got, got.get("error")
    torch.cuda.synchronize()
    for a, b in zip(got["grads"], want):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_reduced_lm_coded_step_on_the_card_matches_the_cpu():
    """Reduced qwen3-1.7b at S = 2304 (the online-softmax branch, so the
    flash kernels forward and backward) through one synchronous coded NAG
    step, code (4, 3, 1, 2) with one straggler: the card's params, loss and
    grad_norm against the same step on the CPU (plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import make_code
    from repro_torch.data import CodedBatcher, make_synthetic_batch
    from repro_torch.kernels import flash_attn
    from repro_torch.models import api
    from repro_torch.optim import nag
    from repro_torch.train import make_coded_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-1.7b").reduced()
    code = make_code(4, 3, 1, 2)
    batch = make_synthetic_batch(np.random.default_rng(0), cfg, 4, 2304)
    params = api.init(cfg, "cpu", torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        arts = make_coded_train_step(cfg, code, nag(1e-2), device=dev)
        p = {k: v.to(dev) for k, v in params.items()}
        placed = CodedBatcher(code).place(
            {k: torch.as_tensor(v).to(dev) for k, v in batch.items()})
        inp = arts.step_inputs((1,))
        n0 = flash_attn.LAUNCHES["flash_attention_bwd"]
        newp, _, m = arts.step(p, nag(1e-2).init(p), placed, inp["W"],
                               inp["mask"], inp["rho"])
        out[dev] = ({k: v.cpu() for k, v in newp.items()},
                    {k: float(v) for k, v in m.items()})
        if dev == "cuda":
            bwd = flash_attn.LAUNCHES["flash_attention_bwd"] - n0
            assert bwd == code.n * code.d * cfg.n_layers
    (pc, mc), (pg, mg) = out["cpu"], out["cuda"]
    assert abs(mg["loss"] - mc["loss"]) <= 1e-5 * abs(mc["loss"])
    assert abs(mg["grad_norm"] - mc["grad_norm"]) <= 1e-4 * mc["grad_norm"]
    for k in pc:
        torch.testing.assert_close(pg[k], pc[k], rtol=1e-4, atol=1e-5)


@pytest.mark.gpu
def test_reduced_prefill_with_the_kernel_matches_plain_path():
    """Reduced qwen3-1.7b at S = 2304 (the online-softmax branch): the
    prefill on the card, which launches the flash kernel once per layer,
    against the same prefill on the CPU through the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-1.7b").reduced()
    params = api.init(cfg, "cpu", torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (1, 2304),
                         generator=torch.Generator().manual_seed(1))
    prefill = api.make_prefill(cfg, 2304)
    n0 = flash_attn.LAUNCHES["flash_attention"]
    got, cache = prefill({k: v.cuda() for k, v in params.items()},
                         {"tokens": toks.cuda()})
    assert flash_attn.LAUNCHES["flash_attention"] == n0 + cfg.n_layers
    want, want_cache = prefill(params, {"tokens": toks})
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cache["k"].cpu(), want_cache["k"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 16])
def test_reduced_decode_on_the_card_matches_the_cpu(window):
    """Reduced qwen3-1.7b: a 2304-token prefill (the flash kernel) and 4
    decode steps on the card against the same calls on the CPU, logits at
    2e-4; the decode launches no flash kernel, and its cache comes back
    the same tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen3-1.7b").reduced()
    params = api.init(cfg, "cpu", torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 2308),
                         generator=torch.Generator().manual_seed(1))
    prefill = api.make_prefill(cfg, 2308, window=window)
    decode = api.make_decode(cfg, window=window)
    logits = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        t = toks.to(dev)
        with torch.no_grad():
            _, cache = prefill(p, {"tokens": t[:, :2304]})
        n0 = flash_attn.LAUNCHES["flash_attention"]
        k = cache["k"]
        out = []
        for i in range(2304, 2308):
            lg, cache = decode(p, cache, t[:, i])
            out.append(lg.cpu())
        assert cache["k"] is k and int(cache["pos"]) == 2308
        assert flash_attn.LAUNCHES["flash_attention"] == n0
        logits[dev] = out
    for a, b in zip(logits["cuda"], logits["cpu"]):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_of_card_tensors(tmp_path, dtype):
    """A tree of tensors on the card saved and restored into a like on the
    card: the same bits, on the card, in the like's type."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.checkpoint import CheckpointManager
    g = torch.Generator(device="cuda").manual_seed(0)
    tree = {"params": {"w": torch.randn(64, 33, generator=g, device="cuda")
                       .to(dtype), "b": [torch.randn(7, generator=g,
                                                     device="cuda").to(dtype)]},
            "opt_state": {"t": torch.tensor(5, dtype=torch.int32,
                                            device="cuda")}}
    mgr = CheckpointManager(tmp_path, keep=1)
    mgr.save(3, tree, {"arch": "test"})
    like = {"params": {"w": torch.zeros(64, 33, dtype=dtype, device="cuda"),
                       "b": [torch.zeros(7, dtype=dtype, device="cuda")]},
            "opt_state": {"t": torch.zeros((), dtype=torch.int32,
                                           device="cuda")}}
    got, meta = mgr.restore_latest(like)
    assert meta == {"arch": "test", "step": 3}
    for a, b in ((got["params"]["w"], tree["params"]["w"]),
                 (got["params"]["b"][0], tree["params"]["b"][0]),
                 (got["opt_state"]["t"], tree["opt_state"]["t"])):
        assert a.device.type == "cuda" and a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            a, b = a.view(torch.int16), b.view(torch.int16)
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_moe_scatter_on_the_card_matches_the_cpu_and_repeats_its_bits():
    """``moe_ffn_scatter`` on a batch that forces drops (one row repeated:
    16 picks of each of 2 experts against ``C = 10``): the routing on the
    card equals the CPU's exactly, ``y`` and ``aux`` agree at f32
    tolerance, and two calls on the card, forward and backward, give the
    same bits (no atomics in the dispatch)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.models import common as cm
    from repro_torch.models import moe
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("olmoe-1b-7b").reduced()
    params = api.init(cfg, "cpu", torch.Generator().manual_seed(0))
    lp = cm.layer_list(params, "layers/", cfg.n_layers)[0]
    row = torch.randn(1, 1, cfg.d_model, generator=torch.Generator()
                      .manual_seed(1))
    x = row.expand(1, 16, cfg.d_model).contiguous()
    xt = x.reshape(16, cfg.d_model)
    C = moe.capacity(cfg, 16)
    routes = {}
    for dev in ("cpu", "cuda"):
        _, _, eidx = moe.route(lp["router"].to(dev), cfg.top_k, xt.to(dev))
        routes[dev] = moe.dispatch(eidx, cfg.n_experts, C)
    for a, b in zip(routes["cpu"], routes["cuda"]):
        assert torch.equal(a, b.cpu())
    assert int((~routes["cuda"].keep).sum()) == 12
    with torch.no_grad():
        want_y, want_aux = moe.moe_ffn_scatter(lp, cfg, x)
    lp_card = {k: ({kk: vv.cuda() for kk, vv in v.items()}
                   if isinstance(v, dict) else v.cuda())
               for k, v in lp.items()}
    runs = []
    for _ in range(2):
        leaves = {"x": x.cuda().requires_grad_(True),
                  "router": lp_card["router"].detach().requires_grad_(True),
                  **{k: v.detach().requires_grad_(True)
                     for k, v in lp_card["moe"].items()}}
        y, aux = moe.moe_ffn_scatter(
            {"router": leaves["router"],
             "moe": {k: leaves[k] for k in lp_card["moe"]}}, cfg, leaves["x"])
        dy = torch.linspace(-1, 1, y.numel(), device="cuda").reshape(y.shape)
        grads = torch.autograd.grad((y * dy).sum() + aux, list(leaves.values()))
        runs.append((y.detach(), aux.detach(), grads))
    torch.testing.assert_close(runs[0][0].cpu(), want_y, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(runs[0][1].cpu(), want_aux, rtol=2e-5,
                               atol=2e-5)
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))


@pytest.mark.gpu
def test_reduced_xlstm_prefill_and_decode_on_the_card_match_the_cpu():
    """Reduced xlstm-350m: a 40-token prefill (the chunked mLSTM, the sLSTM
    step loop) and 4 decode steps from its recurrent state on the card
    against the same calls on the CPU: logits and every state leaf at
    rtol = atol = 1e-4 of their scale; the decode updates the state in
    place; no flash launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-350m").reduced()
    params = api.init(cfg, "cpu", torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab, (2, 44),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    n0 = flash_attn.LAUNCHES["flash_attention"]
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        t = toks.to(dev)
        with torch.no_grad():
            lg, state = api.make_prefill(cfg, 0)(p, {"tokens": t[:, :40]})
        C = state["mlstm/C"]
        logits = [lg.cpu()]
        for i in range(40, 44):
            lg, state = api.make_decode(cfg)(p, state, t[:, i])
            logits.append(lg.cpu())
        assert state["mlstm/C"] is C and int(state["pos"]) == 44
        out[dev] = (logits, {k: v.cpu() for k, v in state.items()})
    assert flash_attn.LAUNCHES["flash_attention"] == n0
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for k, b in out["cpu"][1].items():
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(out["cuda"][1][k], b, rtol=1e-4,
                                   atol=1e-4 * scale)


@pytest.mark.gpu
def test_slstm_backward_on_the_card_matches_autograd_and_repeats_its_bits():
    """The sLSTM's hand-written backward through time on the card against
    autograd recording the cell's steps as plain operations there, and its
    bits twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import xlstm
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(2)
    H, B, hd, T = 4, 2, 128, 48
    x4 = torch.randn(T, H, B, 4 * hd, generator=g).cuda()
    R = (torch.randn(H, hd, 4 * hd, generator=g) / hd ** 0.5).cuda()
    st = [torch.zeros(H, B, hd, device="cuda") for _ in range(4)]
    wy = torch.randn(T, H, B, hd, generator=g).cuda()
    runs = []
    def plain(x4, R, h, c, n, m):
        hs = []
        for x in torch.unbind(x4):
            pz, pi, pf, po = torch.split(x + torch.bmm(h, R), hd, dim=-1)
            a = torch.nn.functional.logsigmoid(pf) + m
            m = torch.maximum(a, pi)
            c = torch.exp(a - m) * c + torch.exp(pi - m) * torch.tanh(pz)
            n = torch.exp(a - m) * n + torch.exp(pi - m)
            h = torch.sigmoid(po) * c / torch.maximum(n, torch.ones_like(n))
            hs.append(h)
        return torch.stack(hs), c, n, m

    for fn in (xlstm._SLSTMScan.apply, xlstm._SLSTMScan.apply, plain):
        leaves = [t.clone().requires_grad_() for t in (x4, R)]
        hs, *last = fn(*leaves, *st)
        lval = (hs * wy).sum() + last[0].sum()
        runs.append((hs.detach(), torch.autograd.grad(lval, leaves)))
    assert torch.equal(runs[0][0], runs[1][0])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    for a, b in zip(runs[0][1], runs[2][1]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-4 * float(b.abs().max()))


@pytest.mark.gpu
def test_reduced_xlstm_coded_step_kernels_match_plain_backend():
    """Reduced xlstm-350m at S = 64 through one synchronous coded NAG step
    on the card, code (4, 3, 1, 2) with one straggler: the kernel backend
    (every leaf encoded, one decode) against the plain backend on the
    card, params at rtol 1e-4 / atol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from repro_torch.coding import SchemeSpec
    from repro_torch.configs import get_config
    from repro_torch.core import make_code
    from repro_torch.data import CodedBatcher, make_synthetic_batch
    from repro_torch.models import api
    from repro_torch.optim import nag
    from repro_torch.train import make_coded_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-350m").reduced()
    code = make_code(4, 3, 1, 2)
    batch = {k: torch.as_tensor(v).cuda() for k, v in make_synthetic_batch(
        np.random.default_rng(0), cfg, 4, 64).items()}
    params = api.init(cfg, "cuda", torch.Generator().manual_seed(0))
    out = {}
    for backend in ("hopper", "ref"):
        arts = make_coded_train_step(cfg, code, nag(1e-2), device="cuda",
                                     spec=SchemeSpec(backend=backend))
        inp = arts.step_inputs((1,))
        n0 = dict(ops.launch_counts())
        newp, _, m = arts.step(params, nag(1e-2).init(params),
                               CodedBatcher(code).place(batch), inp["W"],
                               inp["mask"], inp["rho"])
        launched = {k: v - n0[k] for k, v in ops.launch_counts().items()
                    if v != n0[k]}
        if backend == "hopper":
            assert launched == {"coded_encode_2d": 12,
                                "coded_encode_3d": 12 * 24,
                                "coded_decode_2d": 1}, launched
        else:
            assert launched == {}, launched
        out[backend] = (newp, float(m["loss"]))
    assert abs(out["hopper"][1] - out["ref"][1]) <= 1e-6 * abs(out["ref"][1])
    for k, v in out["ref"][0].items():
        torch.testing.assert_close(out["hopper"][0][k], v, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.gpu
def test_reduced_hybrid_prefill_and_decode_on_the_card_match_the_cpu():
    """Reduced zamba2-1.2b in groups of 2 over 5 layers (3 applications of
    the shared block, the last group short): a 2112-token prefill, above
    ``CHUNK_THRESHOLD``, so the shared block's attention runs the flash
    kernel at head dim 64 on the card (3 launches), and 4 decode steps on
    the SSM states, conv rings and KV caches, against the same calls on the
    CPU (the plain flash version): logits and every state leaf at rtol =
    atol = 1e-4 of their scale; the decode updates the state in place and
    launches no flash."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("zamba2-1.2b").reduced(),
                              n_layers=5, attn_every=2)
    assert cfg.head_dim_ == 64
    params = api.init(cfg, "cpu", torch.Generator().manual_seed(0))
    S = 2112
    toks = torch.randint(0, cfg.vocab, (2, S + 4),
                         generator=torch.Generator().manual_seed(1))
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        t = toks.to(dev)
        n0 = flash_attn.LAUNCHES["flash_attention"]
        with torch.no_grad():
            lg, state = api.make_prefill(cfg, S + 4)(p, {"tokens": t[:, :S]})
        if dev == "cuda":
            assert flash_attn.LAUNCHES["flash_attention"] == n0 + 3
        held = {k: state[k] for k in ("ssm", "conv", "k", "v")}
        logits = [lg.cpu()]
        n1 = flash_attn.LAUNCHES["flash_attention"]
        for i in range(S, S + 4):
            lg, state = api.make_decode(cfg)(p, state, t[:, i])
            logits.append(lg.cpu())
        assert flash_attn.LAUNCHES["flash_attention"] == n1
        assert all(state[k] is v for k, v in held.items())
        assert int(state["pos"]) == S + 4
        out[dev] = (logits, {k: v.cpu() for k, v in state.items()})
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for k, b in out["cpu"][1].items():
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(out["cuda"][1][k], b, rtol=1e-4,
                                   atol=1e-4 * scale)


@pytest.mark.gpu
def test_reduced_hybrid_coded_step_kernels_match_plain_backend():
    """Reduced zamba2-1.2b (2 layers, 2 applications of the shared block)
    at S = 2304, above ``CHUNK_THRESHOLD``, through one synchronous coded
    NAG step on the card, code (4, 3, 1, 2) with one straggler: the kernel
    backend (36 2D encodes for ``ln_f`` and the shared block's norms, 216
    3D, one decode; flash forward twice and backward once an application
    and subset, at head dim 64) against the plain coding backend on the
    card, params at rtol 1e-4 / atol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from repro_torch.coding import SchemeSpec
    from repro_torch.configs import get_config
    from repro_torch.core import make_code
    from repro_torch.data import CodedBatcher, make_synthetic_batch
    from repro_torch.models import api
    from repro_torch.optim import nag
    from repro_torch.train import make_coded_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("zamba2-1.2b").reduced()
    code = make_code(4, 3, 1, 2)
    batch = {k: torch.as_tensor(v).cuda() for k, v in make_synthetic_batch(
        np.random.default_rng(0), cfg, 4, 2304).items()}
    params = api.init(cfg, "cuda", torch.Generator().manual_seed(0))
    out = {}
    for backend in ("hopper", "ref"):
        arts = make_coded_train_step(cfg, code, nag(1e-2), device="cuda",
                                     spec=SchemeSpec(backend=backend))
        inp = arts.step_inputs((1,))
        n0 = dict(ops.launch_counts())
        newp, _, m = arts.step(params, nag(1e-2).init(params),
                               CodedBatcher(code).place(batch), inp["W"],
                               inp["mask"], inp["rho"])
        launched = {k: v - n0[k] for k, v in ops.launch_counts().items()
                    if v != n0[k]}
        flash = {"flash_attention": 2 * 2 * 12, "flash_attention_bwd": 2 * 12}
        if backend == "hopper":
            assert launched == {"coded_encode_2d": 3 * 12,
                                "coded_encode_3d": 18 * 12,
                                "coded_decode_2d": 1, **flash}, launched
        else:
            assert launched == flash, launched
        out[backend] = (newp, float(m["loss"]))
    assert abs(out["hopper"][1] - out["ref"][1]) <= 1e-6 * abs(out["ref"][1])
    for k, v in out["ref"][0].items():
        torch.testing.assert_close(out["hopper"][0][k], v, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.gpu
def test_reduced_encdec_prefill_and_decode_on_the_card_match_the_cpu():
    """Reduced whisper-tiny (2 + 2 layers) on 2112 frames, above
    ``CHUNK_THRESHOLD``: the prefill runs the flash kernel in the encoder
    (2 launches, full mask) and in the cross-attention of its one decode
    step (2 launches at Sq = 1 against 2112 keys), each of 4 decode steps
    2 cross-attention launches; against the same calls on the CPU (the
    plain flash version): logits and every cache leaf at rtol = atol =
    1e-4 of their scale; the decode updates the self-KV ring in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attn
    from repro_torch.models import api
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("whisper-tiny").reduced()
    params = api.init(cfg, "cpu", torch.Generator().manual_seed(0))
    F = 2112
    frames = torch.randn(2, F, cfg.d_model,
                         generator=torch.Generator().manual_seed(1))
    toks = torch.randint(0, cfg.vocab, (2, 4),
                         generator=torch.Generator().manual_seed(2))
    out = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items()}
        n0 = flash_attn.LAUNCHES["flash_attention"]
        with torch.no_grad():
            lg, cache = api.make_prefill(cfg, F)(p, {"embeds": frames.to(dev)})
        if dev == "cuda":
            assert flash_attn.LAUNCHES["flash_attention"] == n0 + 4
        held = {k: cache[k] for k in ("k", "v", "xk", "xv")}
        logits = [lg.cpu()]
        n1 = flash_attn.LAUNCHES["flash_attention"]
        for i in range(4):
            lg, cache = api.make_decode(cfg)(p, cache, toks[:, i].to(dev))
            logits.append(lg.cpu())
        if dev == "cuda":
            assert flash_attn.LAUNCHES["flash_attention"] == n1 + 4 * 2
        assert all(cache[k] is v for k, v in held.items())
        assert int(cache["pos"]) == 5
        out[dev] = (logits, {k: v.cpu() for k, v in cache.items()})
    for a, b in zip(out["cuda"][0], out["cpu"][0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for k, b in out["cpu"][1].items():
        scale = max(1.0, float(b.abs().max()))
        torch.testing.assert_close(out["cuda"][1][k], b, rtol=1e-4,
                                   atol=1e-4 * scale)


@pytest.mark.gpu
def test_reduced_encdec_coded_step_kernels_match_plain_backend():
    """Reduced whisper-tiny on 2112 frames and 64 tokens, through one
    synchronous coded NAG step on the card, code (4, 3, 1, 2) with one
    straggler: the kernel backend (24 2D encodes for ``enc_ln_f`` and
    ``ln_f``, 324 3D for the 27 other leaves, one decode; the flash forward
    twice and its backward once for each of the 2 encoder self-attentions
    and 2 cross-attentions a subset, full mask, the cross-attention 64
    queries against 2112 keys) against the plain coding backend on the
    card, params at rtol 1e-4 / atol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import numpy as np

    from repro_torch.coding import SchemeSpec
    from repro_torch.configs import get_config
    from repro_torch.core import make_code
    from repro_torch.data import CodedBatcher, make_synthetic_batch
    from repro_torch.models import api
    from repro_torch.optim import nag
    from repro_torch.train import make_coded_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("whisper-tiny").reduced()
    code = make_code(4, 3, 1, 2)
    batch = make_synthetic_batch(np.random.default_rng(0), cfg, 4, 64)
    batch["embeds"] = np.random.default_rng(1).standard_normal(
        (4, 2112, cfg.d_model)).astype(np.float32)
    batch = {k: torch.as_tensor(v).cuda() for k, v in batch.items()}
    params = api.init(cfg, "cuda", torch.Generator().manual_seed(0))
    out = {}
    for backend in ("hopper", "ref"):
        arts = make_coded_train_step(cfg, code, nag(1e-2), device="cuda",
                                     spec=SchemeSpec(backend=backend))
        inp = arts.step_inputs((1,))
        n0 = dict(ops.launch_counts())
        newp, _, m = arts.step(params, nag(1e-2).init(params),
                               CodedBatcher(code).place(batch), inp["W"],
                               inp["mask"], inp["rho"])
        launched = {k: v - n0[k] for k, v in ops.launch_counts().items()
                    if v != n0[k]}
        flash = {"flash_attention": 2 * 4 * 12, "flash_attention_bwd": 4 * 12}
        if backend == "hopper":
            assert launched == {"coded_encode_2d": 2 * 12,
                                "coded_encode_3d": 27 * 12,
                                "coded_decode_2d": 1, **flash}, launched
        else:
            assert launched == flash, launched
        out[backend] = (newp, float(m["loss"]))
    assert abs(out["hopper"][1] - out["ref"][1]) <= 1e-6 * abs(out["ref"][1])
    for k, v in out["ref"][0].items():
        torch.testing.assert_close(out["hopper"][0][k], v, rtol=1e-4,
                                   atol=1e-5)


@pytest.mark.gpu
def test_time_callable_puts_an_in_place_kernel_on_the_clock():
    """``time_callable``'s default sync waits for the card even where the
    call returns nothing: the in-place ``coded_encode_acc`` at the main
    path's shape takes at least 0.9 x its device time (``time_ms``) a
    call; ``capture_env`` records the card's name and power limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from repro_torch.bench import TimerPolicy, capture_env, time_callable
    from repro_torch.bench.timing import time_ms
    g = torch.Generator(device="cuda").manual_seed(0)
    G = torch.randn(1, 171737, 2, generator=g, device="cuda")
    C = torch.randn(1, 2, generator=g, device="cuda")
    acc = torch.zeros(171737, device="cuda")

    def in_place():
        coded_encode_acc(acc, G, C)       # returns nothing to wait on

    stats = time_callable(in_place, policy=TimerPolicy(warmup=5, reps=25))
    device_ms = time_ms(lambda i: in_place())
    assert stats.mean_s * 1e3 >= 0.9 * device_ms, (stats, device_ms)
    env = capture_env(device="cuda")
    assert env["backend"] == "cuda" and env["device_count"] >= 1
    assert env["device_kind"] == torch.cuda.get_device_name(0)
    name, limit = (s.strip() for s in env["nvidia_smi"].split(","))
    assert name and limit.endswith("W"), env["nvidia_smi"]
