"""The port's synthetic batches and streams against the reference's: the
same numbers, draw for draw, from the same seed, for every branch of
``make_synthetic_batch`` (linear; the token families; the ``vlm`` and
``encdec`` extras)."""
import types

import numpy as np
import pytest

import repro.data as jdata
import repro_torch.data as tdata
from repro.configs import get_config as jget_config
from repro_torch.configs import get_config as tget_config
from repro_torch.data import pipeline as tpipeline


def _fields_only(name):
    """A small config object holding only what the branch reads, from the
    reference's reduced config of a family the port has no model for."""
    c = jget_config(name).reduced()
    return types.SimpleNamespace(family=c.family, vocab=c.vocab,
                                 d_model=c.d_model,
                                 n_frontend_tokens=c.n_frontend_tokens,
                                 dec_ctx=c.dec_ctx)


def _configs(family):
    if family == "linear":
        return jget_config("logistic-paper"), tget_config("logistic-paper")
    if family == "dense":
        return (jget_config("qwen3-1.7b").reduced(),
                tget_config("qwen3-1.7b").reduced())
    c = _fields_only({"vlm": "internvl2-26b", "encdec": "whisper-tiny"}[family])
    return c, c


# (family, seq_len): encdec's 96 tokens pass its dec_ctx of 64, so the
# decoder tokens and labels are cut
CASES = [("linear", 0), ("dense", 64), ("vlm", 32), ("encdec", 96)]


def _assert_same(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert a[key].shape == b[key].shape, key
        assert np.array_equal(a[key], b[key]), key


@pytest.mark.parametrize("family,seq_len", CASES)
def test_synthetic_batch_equals_reference(family, seq_len):
    jcfg, tcfg = _configs(family)
    for seed in (0, 3):
        _assert_same(
            jdata.make_synthetic_batch(np.random.default_rng(seed), jcfg, 8,
                                       seq_len),
            tdata.make_synthetic_batch(np.random.default_rng(seed), tcfg, 8,
                                       seq_len))


@pytest.mark.parametrize("family,seq_len", CASES)
def test_synthetic_lm_stream_equals_reference(family, seq_len):
    jcfg, tcfg = _configs(family)
    sa = jdata.synthetic_lm_stream(jcfg, 8, seq_len, seed=5)
    sb = tdata.synthetic_lm_stream(tcfg, 8, seq_len, seed=5)
    for _ in range(3):
        _assert_same(next(sa), next(sb))


def test_stream_keeps_the_reference_name_and_the_old_alias():
    assert tdata.synthetic_stream is tdata.synthetic_lm_stream
    assert tpipeline.synthetic_lm_stream.__name__ == "synthetic_lm_stream"
    assert "synthetic_lm_stream" in tdata.__all__
