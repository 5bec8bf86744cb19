"""The port's flash attention on the CPU (its plain version, the reference's
``online_attention`` loop) against the reference's Pallas ``flash_attention``
in interpret mode and against the reference's ``online_attention``, on the
shape / mask / type sweep of ``tests/test_kernels.py`` at its tolerances;
and its autograd against ``jax.grad`` of ``online_attention``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attn as jflash
from repro.models import common as jcm
from repro_torch.kernels import flash_attn as tflash
from repro_torch.kernels import ops
from repro_torch.models import common as tcm

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


def _view(shape, dtype=torch.float32, *, pad=0, offset=0):
    """A (B, S, heads, hd) view: rows padded by ``pad`` elements, the base
    ``offset`` elements into its storage."""
    B, S, Hx, hd = shape
    n = B * S * Hx * (hd + pad) + offset
    return torch.zeros(n, dtype=dtype)[offset:].view(B, S, Hx, hd + pad)[
        ..., :hd]


@pytest.mark.parametrize("make,refused", [
    (lambda: _view((2, 64, 4, 128)), None),                    # contiguous
    (lambda: torch.zeros(2, 64, 8, 128)[:, :, 2:6], None),     # fused view
    (lambda: _view((1, 64, 2, 64), pad=4), None),              # 272-byte rows
    (lambda: _view((1, 64, 2, 64), pad=2), "stride"),          # 264 bytes
    (lambda: _view((1, 64, 2, 64), offset=1), "data_ptr"),     # base + 4 B
    (lambda: _view((1, 64, 2, 64), torch.bfloat16, pad=4), "stride"),
    (lambda: _view((1, 1, 1, 64), pad=2), None),   # extent-1 dims never move
    (lambda: torch.zeros(1, 64, 1, 64).expand(1, 64, 4, 64), "stride"),
])
def test_tma_refusal_names_what_tma_cannot_read(make, refused):
    why = tflash.tma_refusal("k", make())
    if refused is None:
        assert why is None
    else:
        assert why.startswith("k: ") and refused in why


@pytest.mark.parametrize("kind,w", [("causal", 0), ("window", 24)])
def test_plain_version_stays_differentiable_on_the_cpu(kind, w):
    """On the CPU the wrapper is the plain version, an autograd graph: its
    gradients equal those of the materialized softmax (the reference's
    <= 2048-token branch) on the same inputs."""
    rng = np.random.default_rng(3)
    B, S, H, Hkv, hd = 1, 64, 4, 2, 32
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .requires_grad_() for s in ((B, S, H, hd), (B, S, Hkv, hd),
                                          (B, S, Hkv, hd))]
    twins = [x.detach().clone().requires_grad_() for x in leaves]
    got = tflash.flash_attention_gqa(*leaves, H // Hkv, mask_kind=kind,
                                     window=w, chunk_q=16, chunk_kv=32)
    pos = torch.arange(S)
    mask = pos[None, :] <= pos[:, None]
    if kind == "window":
        mask &= pos[None, :] > pos[:, None] - w
    want = tcm.gqa_scores_attend(*twins, mask, H // Hkv)
    cot = torch.from_numpy(rng.standard_normal(got.shape).astype(np.float32))
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    for a, b in zip(leaves, twins):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("S,H,Hkv,kind,w,p0", [
    (2304, 4, 2, "causal", 0, 0), (320, 4, 1, "window", 96, 0),
    (200, 4, 2, "causal", 0, 56), (97, 8, 2, "window", 33, 5),
    (1000, 4, 2, "causal", 0, 0)])
def test_plain_flash_grad_matches_reference_online_attention(S, H, Hkv, kind,
                                                             w, p0):
    """The plain version's autograd (the CPU's gradient; the card's backward
    kernel is held to it) against ``jax.grad`` of the reference's
    ``online_attention``, at S = 2304 (the LM's online branch), with a
    window and a query offset, with q_per_kv = 4, and at an S that is no
    multiple of the kernel's 32- and 64-row tiles: rtol 1e-4 plus 1e-5 of
    the largest element (f32 both sides, summed in other orders)."""
    rng = np.random.default_rng([S, H, p0])
    hd = 32
    q = rng.standard_normal((1, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((1, S + p0, Hkv, hd)).astype(np.float32)
    v = rng.standard_normal((1, S + p0, Hkv, hd)).astype(np.float32)
    dout = rng.standard_normal((1, S, H, hd)).astype(np.float32)
    kw = dict(mask_kind=kind, window=w, kv_pos0=p0)

    def jfn(q, k, v):
        return jnp.sum(jcm.online_attention(q, k, v, H // Hkv, **kw)
                       * jnp.asarray(dout))
    want = jax.grad(jfn, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tflash.flash_attention_gqa(*leaves, H // Hkv, **kw)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(b).max()),
                                   err_msg=name)
