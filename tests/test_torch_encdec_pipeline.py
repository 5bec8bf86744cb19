"""Coded training of the encoder-decoder (reduced ``whisper-tiny``, code
(4, 3, 1, 2)) in the port: the pipelined fused SGD-momentum ``Trainer``
(gather, worker 2 straggling) against the reference's, 3 steps and the
drain, at ``lm_train_cases.py``'s tolerance (the helpers of
``test_torch_encdec_train.py``); and on the plain backend the decoded
gradient with a straggler against the uncoded mean of the subsets'
gradients (rtol 1e-5), and a subset's gradient repeating its bits.
"""
import jax
import numpy as np
import pytest
import torch

import repro_torch.coding as tc
import repro_torch.core as tcore
import test_torch_encdec_train as sync
from repro_torch.configs import get_config as tget_config
from repro_torch.data import CodedBatcher, make_synthetic_batch
from repro_torch.models import api
from repro_torch.optim import sgd_momentum
from repro_torch.train import make_coded_train_step

torch.set_num_threads(1)


def test_encdec_pipelined_trajectory_matches_reference():
    if len(jax.devices()) < sync.cases.CODE[0]:
        pytest.skip(f"needs {sync.cases.CODE[0]} devices")
    sync.check_trajectory("gather", True)


def _setup():
    cfg = tget_config(sync.ARCH).reduced()
    code = tcore.make_code(*sync.cases.CODE)
    params = api.init(cfg, "cpu", torch.Generator().manual_seed(4))
    batch = {k: torch.from_numpy(v) for k, v in make_synthetic_batch(
        np.random.default_rng(8), cfg, 4, sync.cases.SEQ).items()}
    return cfg, code, params, batch


@pytest.mark.parametrize("schedule", ["gather", "a2a"])
def test_encdec_decoded_gradient_is_the_uncoded_mean(schedule):
    """With worker ``RUNS[schedule]`` straggling, the decoded gradient is
    the mean over the 4 sequences of each one's gradient (encoder and
    decoder), within f32 rounding of the decode's weights."""
    cfg, code, params, batch = _setup()
    arts = make_coded_train_step(cfg, code, sgd_momentum(1e-2), device="cpu",
                                 spec=tc.SchemeSpec(schedule=schedule))
    inp = arts.step_inputs(sync.RUNS[schedule, False])
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
        np.testing.assert_allclose(dec[k].numpy(), want[k].numpy(), rtol=1e-5,
                                   atol=1e-5 * max(scale, 1e-12), err_msg=k)
    for k in ("enc_pos", "enc_layers/attn/wq", "dec_layers/xattn/wv"):
        assert float(want[k].abs().max()) > 0, k


def test_encdec_subset_gradient_repeats_its_bits():
    cfg, _, params, batch = _setup()
    sub = {k: v[:1] for k, v in batch.items()}
    loss = api.make_loss(cfg)
    out = []
    for _ in range(2):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        lval = loss(p, sub)
        out.append((lval, torch.autograd.grad(lval, list(p.values()))))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
