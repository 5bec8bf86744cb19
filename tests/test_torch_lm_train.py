"""The dense LM's training loss in the port against the reference, on the
reference's own random weights of reduced ``qwen3-1.7b`` carried across
with ``convert.py``, and inputs made with numpy from a seed.

- ``softmax_xent`` with and without a mask: rtol 1e-6 (f32 on both sides,
  one log-sum-exp a row).
- ``dense.loss`` and its gradient against ``jax.value_and_grad`` of the
  reference's, at S = 64 (the materialized softmax) and S = 2304 (the
  online softmax, above ``CHUNK_THRESHOLD``): the loss to rtol 1e-5, every
  gradient leaf to rtol 1e-4 plus 1e-4 of the leaf's largest element (f32
  on both sides, summed in other orders through two layers and their
  backward).
- The per-layer checkpoint (the reference's remat) changes no bit of the
  loss or of its gradient.
- ``make_loss`` for the dense family, ``init`` on the meta device, and
  ``convert``'s default device.
"""
import resource

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import common as jcm
from repro.models import dense as jdense
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.models import api as tapi
from repro_torch.models import common as tcm
from repro_torch.models import dense as tdense

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = jconfigs.get_config("qwen3-1.7b").reduced()
    jp = jdense.init(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jp, tp


def _batch(seed, B, S, vocab):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S),
                                                dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _port_value_and_grad(tp, cfg, batch, remat=True):
    p = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    b = _torch_batch(batch)
    lval = (tdense.loss(p, cfg, b) if remat else tcm.softmax_xent(
        tdense.forward(p, cfg, b["tokens"]), b["labels"]))
    return lval, dict(zip(p, torch.autograd.grad(lval, list(p.values()))))


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches_reference(masked):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((2, 9, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    mask = (rng.random((2, 9)) < 0.6).astype(np.float32) if masked else None
    want = jcm.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    got = tcm.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                           None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_softmax_xent_of_an_empty_mask_is_zero():
    logits = torch.zeros(1, 3, 5)
    labels = torch.zeros(1, 3, dtype=torch.int32)
    assert float(tcm.softmax_xent(logits, labels, torch.zeros(1, 3))) == 0.0


@pytest.mark.parametrize("S", [64, 2304])
def test_dense_loss_and_grad_match_reference(model, S):
    cfg, jp, tp = model
    batch = _batch(S, 1, S, cfg.vocab)
    jl, jg = jax.value_and_grad(jdense.loss)(
        jp, cfg, jax.tree.map(jnp.asarray, batch))
    tl, tg = _port_value_and_grad(tp, cfg, batch)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    want = convert.flatten(jax.tree.map(np.asarray, jg))
    assert list(want) == list(tg)
    for k, w in want.items():
        np.testing.assert_allclose(tg[k].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * float(np.abs(w).max()),
                                   err_msg=k)


def test_checkpointed_loss_and_grad_are_bitwise_the_plain_ones(model):
    cfg, _, tp = model
    batch = _batch(5, 2, 64, cfg.vocab)
    la, ga = _port_value_and_grad(tp, cfg, batch, remat=True)
    lb, gb = _port_value_and_grad(tp, cfg, batch, remat=False)
    assert torch.equal(la, lb)
    assert all(torch.equal(ga[k], gb[k]) for k in ga)


def test_make_loss_works_for_dense(model):
    cfg, jp, tp = model
    batch = _batch(9, 2, 32, cfg.vocab)
    got = tapi.make_loss(tget_config("qwen3-1.7b").reduced())(
        tp, _torch_batch(batch))
    want = jdense.loss(jp, cfg, jax.tree.map(jnp.asarray, batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize()


def test_meta_init_has_the_shapes_and_draws_nothing():
    cfg = tget_config("qwen3-1.7b").reduced()
    real = tapi.init(cfg, "cpu")
    meta = tapi.init(cfg, "meta")
    assert list(meta) == list(real)
    for k in real:
        assert meta[k].device.type == "meta"
        assert (meta[k].shape, meta[k].dtype) == (real[k].shape, real[k].dtype)
    # init on a real device keeps its bits: the draws are the same as before
    # the meta device drew nothing
    again = tapi.init(cfg, "cpu")
    assert all(torch.equal(real[k], again[k]) for k in real)
    # full width: 2.03 B parameters, 8 GB in f32, and no memory on the host
    full = tget_config("qwen3-1.7b")
    before = _rss_bytes()
    big = tapi.init(full, "meta")
    assert _rss_bytes() - before < 64 << 20
    assert sum(v.numel() for v in big.values()) == 2_031_739_904


def test_convert_defaults_to_the_card():
    tree = {"w": np.ones(3, np.float32)}
    if torch.cuda.is_available():
        assert convert.params_from_jax(tree)["w"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax(tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.opt_state_from_jax({"mu": tree})
    assert convert.params_from_jax(tree, device="cpu")["w"].device.type == "cpu"


@pytest.mark.parametrize("name,module", [
    ("qwen3-8b", "qwen3_8b"), ("qwen2-72b", "qwen2_72b"),
    ("granite-34b", "granite_34b")])
def test_dense_configs_are_the_reference_configs(name, module):
    """Byte copies of the reference's dense configs; their meta init has
    the reference's parameter tree, shape for shape."""
    import dataclasses
    import pathlib

    from repro.models import api as japi
    ref = pathlib.Path(jconfigs.__file__).parent / f"{module}.py"
    port = pathlib.Path(tcm.__file__).parents[1] / "configs" / f"{module}.py"
    assert port.read_bytes() == ref.read_bytes()
    jcfg, tcfg = jconfigs.get_config(name), tget_config(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    shapes = jax.eval_shape(lambda: japi.init(jax.random.PRNGKey(0), jcfg))
    want = {k: tuple(v.shape) for k, v in convert.flatten(shapes).items()}
    got = {k: tuple(v.shape) for k, v in tapi.init(tcfg, "meta").items()}
    assert got == want
