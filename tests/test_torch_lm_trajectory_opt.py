"""Coded training of the dense LM (reduced ``qwen3-1.7b``, S = 64): 3-step
trajectories of the port's ``Trainer`` against the reference's, gather
with AdamW and a2a with SGD-momentum (``lm_train_cases.py`` says how, and
to what tolerance)."""
import jax
import pytest
import torch

import lm_train_cases as cases

torch.set_num_threads(1)


@pytest.mark.parametrize("schedule,opt", [("gather", "adamw"), ("a2a", "sgd")])
def test_lm_trajectory_matches_reference(schedule, opt):
    if len(jax.devices()) < cases.CODE[0]:
        pytest.skip(f"needs {cases.CODE[0]} devices")
    cases.check_trajectory(schedule, opt, False)
