"""Tests of the port that need the card (marker ``gpu``): they build the
CUDA kernels with nvcc and launch them.  Run them on a machine with an
NVIDIA GPU with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card each test skips.  This file imports nothing of JAX, so it
also runs where only PyTorch is installed.
"""
import pytest
import torch

from repro_torch.kernels import (coded_decode, coded_decode_plain,
                                 coded_encode, coded_encode_plain, ops)

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
    assert all(counts[k] >= 1 for k in counts), counts


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
