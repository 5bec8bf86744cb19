"""Coded training of the dense LM (reduced ``qwen3-1.7b``, S = 64): 3-step
trajectories of the port's ``Trainer`` against the reference's, synchronous
gather with NAG and with SGD-momentum (``lm_train_cases.py`` says how, and
to what tolerance)."""
import jax
import numpy as np
import pytest
import torch

import lm_train_cases as cases
import repro_torch.data as tdata
from repro_torch.configs import get_config as tget_config

torch.set_num_threads(1)


@pytest.mark.parametrize("opt", ["nag", "sgd"])
def test_lm_trajectory_matches_reference(opt):
    if len(jax.devices()) < cases.CODE[0]:
        pytest.skip(f"needs {cases.CODE[0]} devices")
    cases.check_trajectory("gather", opt, False)


def test_lm_batches_are_the_reference_batches():
    """The port's synthetic LM batches are the reference's, draw for draw."""
    tcfg = tget_config("qwen3-1.7b").reduced()
    rng = np.random.default_rng(7)
    for want in cases.batches():
        got = tdata.make_synthetic_batch(rng, tcfg, 4, cases.SEQ)
        assert set(got) == set(want)
        assert all(np.array_equal(got[k], want[k]) for k in want)
