"""The plain versions of the port's kernels against the reference's Pallas
kernels (interpret mode) and its jnp oracles, on the same numpy inputs.
The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there.

Tolerances are the reference's own (f32 2e-5, bf16 2e-2): the two sides add
the same f32 products in different orders, and bf16 outputs round once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import coded_decode as jax_decode
from repro.kernels import coded_encode as jax_encode
from repro.kernels import ref as jax_ref
from repro_torch.kernels import coded_decode, coded_encode, ops, ref

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _pair(arr, dtype):
    """The same values in both frameworks, rounded to ``dtype`` by jax."""
    j = jnp.asarray(arr, JDT[dtype])
    t = torch.from_numpy(np.array(j, np.float32)).to(TDT[dtype])
    return j, t


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _rng(*key):
    return np.random.default_rng([7, *key])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,V,m", [(1, 8, 1), (3, 64, 2), (5, 640, 4),
                                   (8, 1024, 8), (31, 96, 3)])
def test_encode_2d_sweep(d, V, m, dtype):
    rng = _rng(d, V, m)
    Gj, Gt = _pair(rng.standard_normal((d, V, m)), dtype)
    Cj, Ct = _pair(rng.standard_normal((d, m)), dtype)
    got = coded_encode(Gt, Ct)
    assert got.shape == (V,) and got.dtype == TDT[dtype]
    np.testing.assert_allclose(
        _np(got), _np(jax_encode(Gj, Cj, interpret=True)), **_tol(dtype))
    np.testing.assert_allclose(
        _np(got), _np(jax_ref.coded_encode_ref(Gj, Cj)), **_tol(dtype))
    assert torch.equal(got, ref.coded_encode_ref(Gt, Ct))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,V,m,R", [(3, 16, 2, 128), (4, 256, 2, 64),
                                     (2, 40, 5, 96)])
def test_encode_3d_sweep(d, V, m, R, dtype):
    rng = _rng(d, V, m, R)
    Gj, Gt = _pair(rng.standard_normal((d, V, m, R)), dtype)
    Cj, Ct = _pair(rng.standard_normal((d, m)), dtype)
    got = coded_encode(Gt, Ct)
    assert got.shape == (V, R) and got.dtype == TDT[dtype]
    np.testing.assert_allclose(
        _np(got), _np(jax_encode(Gj, Cj, interpret=True)), **_tol(dtype))
    np.testing.assert_allclose(
        _np(got), _np(jax_ref.coded_encode_batch_ref(Gj, Cj)), **_tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,V,m", [(4, 64, 2), (16, 512, 3), (32, 96, 8),
                                   (10, 1280, 1)])
def test_decode_2d_sweep(n, V, m, dtype):
    rng = _rng(n, V, m)
    Fj, Ft = _pair(rng.standard_normal((n, V)), dtype)
    Wj, Wt = _pair(rng.standard_normal((n, m)), dtype)
    got = coded_decode(Ft, Wt)
    assert got.shape == (V, m) and got.dtype == TDT[dtype]
    np.testing.assert_allclose(
        _np(got), _np(jax_decode(Fj, Wj, interpret=True)), **_tol(dtype))
    np.testing.assert_allclose(
        _np(got), _np(jax_ref.coded_decode_ref(Fj, Wj)), **_tol(dtype))
    assert torch.equal(got, ref.coded_decode_ref(Ft, Wt))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,V,m,R", [(4, 32, 2, 128), (16, 128, 4, 64)])
def test_decode_3d_sweep(n, V, m, R, dtype):
    rng = _rng(n, V, m, R)
    Fj, Ft = _pair(rng.standard_normal((n, V, R)), dtype)
    Wj, Wt = _pair(rng.standard_normal((n, m)), dtype)
    got = coded_decode(Ft, Wt)
    assert got.shape == (V, m, R)
    np.testing.assert_allclose(
        _np(got), _np(jax_decode(Fj, Wj, interpret=True)), **_tol(dtype))
    np.testing.assert_allclose(
        _np(got), _np(jax_ref.coded_decode_batch_ref(Fj, Wj)), **_tol(dtype))


@pytest.mark.parametrize("kernel", ["encode", "decode"])
def test_out_dtype_bf16_in_f32_out(kernel):
    """The wire case: bf16 operands, f32 accumulate, f32 result — equal to
    the reference's kernel asked for the same ``out_dtype``."""
    rng = _rng(99)
    if kernel == "encode":
        Gj, Gt = _pair(rng.standard_normal((3, 64, 2)), "bfloat16")
        Cj, Ct = _pair(rng.standard_normal((3, 2)), "float32")
        got = coded_encode(Gt, Ct, out_dtype=torch.float32)
        want = jax_encode(Gj, Cj, interpret=True, out_dtype=jnp.float32)
    else:
        Gj, Gt = _pair(rng.standard_normal((8, 256)), "bfloat16")
        Cj, Ct = _pair(rng.standard_normal((8, 2)), "float32")
        got = coded_decode(Gt, Ct, out_dtype=torch.float32)
        want = jax_decode(Gj, Cj, interpret=True, out_dtype=jnp.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_encode_decode_roundtrip_with_stragglers():
    """Encode with every worker's coefficients, decode from 6 of 8
    responders, compare to the plain sum of gradients: the exact-recovery
    property, at the reference's 1e-4."""
    from repro_torch.core import make_code
    code = make_code(8, d=4, s=2, m=2)
    l = 256
    Gfull = np.random.default_rng(3).standard_normal(
        (code.n, l)).astype(np.float32)
    V = l // code.m
    F = []
    for i in range(code.n):
        rows = [(i + j) % code.n for j in range(code.d)]
        G = torch.from_numpy(Gfull[rows].reshape(code.d, V, code.m))
        C = torch.from_numpy(code.C[i].astype(np.float32))
        F.append(coded_encode(G, C))
    F = torch.stack(F)
    F[2] = 1e12        # garbage from stragglers must not leak in
    F[6] = -1e12
    W = torch.from_numpy(
        code.decode_weights([0, 1, 3, 4, 5, 7]).astype(np.float32))
    got = coded_decode(F, W).reshape(-1).numpy()
    np.testing.assert_allclose(got, Gfull.sum(0), rtol=1e-4, atol=1e-4)


def test_plain_version_is_shape_independent_per_element():
    """An element of the plain decode does not depend on how long the
    buffer around it is (what packed == per-leaf rests on off the card)."""
    rng = _rng(5)
    F = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32))
    padded = torch.cat([F, torch.zeros(4, 96)], dim=1)
    assert torch.equal(coded_decode(F, W), coded_decode(padded, W)[:32])


def test_ops_modes_and_launch_counts():
    rng = _rng(11)
    G = torch.from_numpy(rng.standard_normal((3, 64, 2)).astype(np.float32))
    C = torch.from_numpy(rng.standard_normal((3, 2)).astype(np.float32))
    assert torch.equal(ops.encode(G, C, mode="ref"), ops.encode(G, C))
    F = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    W = torch.from_numpy(rng.standard_normal((4, 2)).astype(np.float32))
    assert torch.equal(ops.decode(F, W, mode="ref"), ops.decode(F, W))
    with pytest.raises(ValueError):
        ops.encode(G, C, mode="interpret")
    # a CPU tensor takes the plain version: no kernel launch is counted
    ops.reset_launch_counts()
    ops.encode(G, C)
    ops.decode(F, W)
    assert set(ops.launch_counts()) == {
        "coded_encode_2d", "coded_encode_3d", "coded_encode_acc_2d",
        "coded_encode_acc_3d", "coded_decode_2d", "coded_decode_3d",
        "coded_decode_apply"}
    assert all(v == 0 for v in ops.launch_counts().values())


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        coded_encode(torch.zeros(3, 8), torch.zeros(3, 2))
    with pytest.raises(ValueError):
        coded_encode(torch.zeros(3, 8, 2), torch.zeros(2, 2))
    with pytest.raises(ValueError):
        coded_decode(torch.zeros(4, 8), torch.zeros(3, 2))
