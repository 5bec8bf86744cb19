"""The port's flash attention on the CPU (its plain version, the reference's
``online_attention`` loop) against the reference's Pallas ``flash_attention``
in interpret mode and against the reference's ``online_attention``, on the
shape / mask / type sweep of ``tests/test_kernels.py`` at its tolerances."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as jflash
from repro.models import common as jcm
from repro_torch.kernels import flash_attn as tflash
from repro_torch.kernels import ops

torch.set_num_threads(1)

SWEEP = [
    (2, 256, 4, 2, 64, "causal", 0),
    (1, 128, 2, 2, 32, "full", 0),
    (2, 256, 4, 4, 64, "window", 64),
    (1, 192, 4, 1, 128, "causal", 0),   # MQA, non-pow2 S
]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return (dict(rtol=2e-2, atol=2e-2) if name == "bfloat16"
            else dict(rtol=2e-5, atol=2e-5))


def _inputs(seed, q_shape, kv_shape, name):
    """The same numbers for both packages, rounded to the working type."""
    rng = np.random.default_rng(seed)
    jt, tt = DTYPES[name]
    out = []
    for shape in (q_shape, kv_shape, kv_shape):
        x = rng.standard_normal(shape).astype(np.float32)
        out.append((jnp.asarray(x, jt),
                    torch.from_numpy(x).to(tt)))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hkv,hd,kind,w", SWEEP)
def test_plain_flash_matches_reference_kernel_and_oracle(B, S, H, Hkv, hd,
                                                         kind, w, name):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(7, (B, S, H, hd), (B, S, Hkv, hd),
                                           name)
    before = ops.launch_counts()
    got = tflash.flash_attention_gqa(tq, tk, tv, H // Hkv, mask_kind=kind,
                                     window=w)
    assert ops.launch_counts() == before        # a CPU tensor launches nothing
    assert got.shape == (B, S, H, hd) and got.dtype == DTYPES[name][1]
    kernel = jflash.flash_attention_gqa(jq, jk, jv, H // Hkv, mask_kind=kind,
                                        window=w, interpret=True, block_q=64,
                                        block_k=64)
    oracle = jcm.online_attention(jq, jk, jv, H // Hkv, mask_kind=kind,
                                  window=w)
    np.testing.assert_allclose(_np(got), _np(kernel), **_tol(name))
    np.testing.assert_allclose(_np(got), _np(oracle), **_tol(name))


@pytest.mark.parametrize("name", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,w", [("causal", 0), ("window", 96)])
def test_query_offset_matches_online_attention(kind, w, name):
    """Queries at positions kv_pos0 + i against a longer key sequence (a
    prefix already in the cache), with chunks that do not divide evenly."""
    B, Sq, Sk, H, Hkv, hd = 1, 96, 320, 4, 2, 32
    (jq, tq), (jk, tk), (jv, tv) = _inputs(11, (B, Sq, H, hd),
                                           (B, Sk, Hkv, hd), name)
    got = tflash.flash_attention_gqa(tq, tk, tv, H // Hkv, mask_kind=kind,
                                     window=w, kv_pos0=Sk - Sq, chunk_q=64,
                                     chunk_kv=128)
    want = jcm.online_attention(jq, jk, jv, H // Hkv, mask_kind=kind,
                                window=w, kv_pos0=Sk - Sq, chunk_q=64,
                                chunk_kv=128)
    np.testing.assert_allclose(_np(got), _np(want), **_tol(name))


def test_plain_version_counts_its_calls_and_checks_shapes():
    q = torch.zeros(1, 64, 4, 32)
    kv = torch.zeros(1, 64, 2, 32)
    n0 = tflash.PLAIN_CALLS["flash_attention"]
    tflash.flash_attention_gqa(q, kv, kv, 2)
    assert tflash.PLAIN_CALLS["flash_attention"] == n0 + 1
    with pytest.raises(ValueError, match="do not fit"):
        tflash.flash_attention_gqa(q, kv, kv, 1)
    with pytest.raises(ValueError, match="mask_kind"):
        tflash.flash_attention_gqa(q, kv, kv, 2, mask_kind="sliding")
    with pytest.raises(ValueError, match="kv_pos0"):
        tflash.flash_attention_gqa(q, kv, kv, 2, kv_pos0=-1)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tflash.flash_attention_gqa(q.to("meta"), kv.to("meta"),
                                   kv.to("meta"), 2)
