"""The frozen counts against numbers worked by hand."""
from __future__ import annotations

import json
import math

import pytest

from counts import coding, lm, peaks
from harness import inputs
from harness.manifest import BENCH

L4 = json.loads((BENCH / "configs" / "olmoe-1b-7b-l4.json").read_text())
L16 = dict(L4, num_hidden_layers=16)


def test_olmoe_forward_a_token_at_4_layers():
    # 537.9 M in the 4 layers' active products, 206.0 M unembedding, 67.1 M
    # causal attention at 4096 tokens
    assert lm.forward_per_token(L4, 4096) == pytest.approx(811.0e6, rel=2e-4)
    assert lm.unembed(L4) == 2 * 2048 * 50304
    attn = 4 * 2 * 128 * 16 * 4096
    assert attn == pytest.approx(67.1e6, rel=1e-3)
    products = lm.forward_per_token(L4, 4096) - lm.unembed(L4) - attn
    assert products == pytest.approx(537.9e6, rel=1e-4)


def test_olmoe_training_step():
    # 12 subset passes of one 4096-token sequence
    assert lm.train_step(L4, 4096, 12) / 1e12 == pytest.approx(119.6, abs=0.05)


def test_flash_operations():
    # one causal head-layer product: 2 S S hd, halved
    one = 4096 * 4096 * 128 * 16
    assert lm.flash(L4, 4096, 1, backward=False) == 2 * one * 4
    assert lm.flash(L4, 4096, 12, backward=True) == 6 * one * 4 * 12


def test_coding_bytes():
    # code (8, 4, 2, 2) at l = 343474: a worker reads its 4 subset gradients
    # and writes one wire of 171737; the decode reads 6 wires, writes l
    assert coding.encode(343474, 4, 2) == 4 * (4 * 343474 + 8 + 171737)
    assert coding.decode(343474, 6, 2) == 4 * (6 * 171737 + 12 + 343474)
    assert coding.train_step(343474, 8, 4, 2, 2) == (
        8 * coding.encode(343474, 4, 2) + coding.decode(343474, 6, 2))
    # 4.5 l values a worker, 3 l read and 1 l written by the decode: 40 l
    # in all, 55.0 MB
    assert coding.train_step(343474, 8, 4, 2, 2) / 1e6 == pytest.approx(
        54.96, abs=0.01)
    # an odd P pads its wire up
    assert coding.wire(7, 2) == 4


def test_olmoe_parameter_count():
    total = sum(math.prod(s) for _, s, _ in inputs.lm_leaves(L16))
    assert total * 4 / 1e9 == pytest.approx(27.7, abs=0.05)
    assert sum(math.prod(s) for _, s, _ in inputs.lm_leaves(L4)) > 1.8e9


def test_peaks():
    assert peaks.HBM_BYTES_PER_S == 3.35e12 and peaks.F32_FLOPS == 495e12


def test_coding_roofline_reads_the_coding_kernels_time():
    from harness.manifest import ROOT, load_module
    from harness.trace import Trace
    read = load_module("metrics", "coding_roofline.train", ROOT).read
    work = {"code": [8, 4, 2, 2], "steps": 1, "params": 343474}
    need = coding.train_step(343474, 8, 4, 2, 2) / peaks.HBM_BYTES_PER_S
    ops = [("encode2d_kernel", 0.0, 2e6 * need), ("gemv_kernel", 0.0, 1e6)]
    t = Trace(window_s=1.0, busy_s=1.0, ops=ops, gaps={}, work=work)
    assert read(t) == pytest.approx(50.0)
    assert read(Trace(window_s=1.0, busy_s=1.0, ops=ops[1:], gaps={},
                      work=work)) is None
