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
        "coded_decode_apply", "flash_attention", "flash_attention_bwd"}
    assert all(v == 0 for v in ops.launch_counts().values())


def _at(shape, dtype, offset=0):
    """A contiguous tensor of ``shape`` whose base lies ``offset`` elements
    past an aligned allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=TDT[dtype])[offset:].view(shape)


# (G shape, dtype, G offset, out offset, path): the register form needs
# d*m <= 8 and m <= 4, both bases 16-byte aligned and every vector too: in
# 3D R a multiple of 16 bytes' worth of G (4 f32, 8 bf16), in 2D with d > 1
# each G[j] of V*m elements; a 2D V tail stays on the vector path (the
# kernel's own scalar loop takes it)
ENCODE_PATHS = [
    ((1, 171737, 2), "float32", 0, 0, "vector"),
    ((1, 171737, 2), "bfloat16", 0, 0, "vector"),
    ((1, 75968, 2), "float32", 0, 0, "vector"),
    ((1, 3072, 2, 2048), "float32", 0, 0, "vector"),
    ((1, 3072, 2, 2048), "bfloat16", 0, 0, "vector"),
    ((1, 4, 2), "float32", 0, 0, "vector"),
    ((1, 3, 2), "float32", 0, 0, "vector"),
    ((1, 171737, 2), "float32", 1, 0, "scalar"),
    ((1, 171737, 2), "bfloat16", 0, 1, "scalar"),
    ((1, 3072, 2, 2048), "float32", 0, 3, "scalar"),
    ((1, 3072, 2, 2048), "float32", 4, 4, "vector"),
    ((1, 5, 2, 4), "float32", 0, 0, "vector"),
    ((1, 5, 2, 6), "float32", 0, 0, "scalar"),
    ((1, 5, 2, 4), "bfloat16", 0, 0, "scalar"),
    ((1, 5, 2, 8), "bfloat16", 0, 0, "vector"),
    ((2, 7, 3, 33), "float32", 0, 0, "scalar"),
    ((8, 64, 1), "float32", 0, 0, "vector"),
    ((9, 64, 1), "float32", 0, 0, "scalar"),
    ((2, 64, 4), "float32", 0, 0, "vector"),
    ((3, 64, 3), "float32", 0, 0, "scalar"),
    ((1, 64, 5), "float32", 0, 0, "scalar"),
    ((2, 36, 2), "float32", 0, 0, "vector"),
    ((2, 36, 2), "bfloat16", 0, 0, "vector"),
    ((2, 33, 4), "float32", 0, 0, "vector"),
    ((2, 33, 4), "bfloat16", 0, 0, "scalar"),
    ((2, 37, 3), "float32", 0, 0, "scalar"),
    ((8, 13, 1), "float32", 0, 0, "scalar"),
    ((1, 13, 1), "float32", 0, 0, "vector"),
]


@pytest.mark.parametrize("shape,dtype,g_off,o_off,path", ENCODE_PATHS)
def test_encode_path_choice(shape, dtype, g_off, o_off, path):
    from repro_torch.kernels.coded_encode import encode_path
    G = _at(shape, dtype, g_off)
    out = _at((shape[1], shape[3]) if len(shape) == 4 else (shape[1],),
              "float32", o_off)
    assert encode_path(G, out) == path


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        coded_encode(torch.zeros(3, 8), torch.zeros(3, 2))
    with pytest.raises(ValueError):
        coded_encode(torch.zeros(3, 8, 2), torch.zeros(2, 2))
    with pytest.raises(ValueError):
        coded_decode(torch.zeros(4, 8), torch.zeros(3, 2))


# (F shape, dtype, F offset, out offset, m, path): the vector path needs m
# in VEC_M, both bases 16-byte aligned and, for n > 1, every row F[i] too
# (V*sizeof(in) a multiple of 16); a V tail stays on the vector path (the
# kernel's own scalar loop takes it), which only n = 1 can have.  Both
# coefficient forms (W in registers for n*m <= REG_TERMS, in shared memory
# above) have both paths.
DECODE_PATHS = [
    ((8, 171776), "float32", 0, 0, 2, "vector"),     # the training bucket
    ((8, 171776), "bfloat16", 0, 0, 2, "vector"),
    ((4, 303872), "float32", 0, 0, 2, "vector"),     # serving
    ((64, 1024), "float32", 0, 0, 4, "vector"),      # W in shared memory
    ((17, 640), "bfloat16", 0, 0, 3, "vector"),
    ((3, 36), "float32", 0, 0, 8, "vector"),
    ((8, 171776), "float32", 1, 0, 2, "scalar"),     # F one element off
    ((8, 171776), "bfloat16", 1, 0, 2, "scalar"),
    ((8, 171776), "float32", 0, 1, 2, "scalar"),     # out one element off
    ((64, 1024), "float32", 0, 3, 4, "scalar"),
    ((8, 171776), "float32", 4, 4, 2, "vector"),     # 16 bytes off: aligned
    ((8, 1001), "float32", 0, 0, 2, "scalar"),       # rows F[i] misaligned
    ((8, 1002), "bfloat16", 0, 0, 2, "scalar"),
    ((8, 1012), "bfloat16", 0, 0, 1, "scalar"),
    ((8, 13), "float32", 0, 0, 1, "scalar"),
    ((64, 77), "float32", 0, 0, 2, "scalar"),
    ((8, 1004), "float32", 0, 0, 2, "vector"),
    ((8, 1000), "bfloat16", 0, 0, 2, "vector"),
    ((1, 1001), "float32", 0, 0, 2, "vector"),       # one row: a ragged V tail
    ((1, 13), "bfloat16", 0, 0, 1, "vector"),
    ((1, 3), "float32", 0, 0, 4, "vector"),          # V below one vector
    ((3, 36), "float32", 0, 0, 5, "scalar"),         # m outside VEC_M
    ((12, 1024), "float32", 0, 0, 19, "scalar"),
    ((2, 64), "float32", 0, 0, 6, "scalar"),
]


@pytest.mark.parametrize("shape,dtype,f_off,o_off,m,path", DECODE_PATHS)
def test_decode_path_choice(shape, dtype, f_off, o_off, m, path):
    from repro_torch.kernels.coded_decode import decode_path
    F = _at(shape, dtype, f_off)
    out = _at((shape[1], m), "float32", o_off)
    assert decode_path(F, out) == path


def test_decode_path_cases_cover_both_coefficient_forms():
    from repro_torch.kernels.coded_decode import REG_TERMS
    forms = {(s[0] * m <= REG_TERMS, path)
             for s, _, _, _, m, path in DECODE_PATHS}
    assert forms == {(True, "vector"), (False, "vector"), (True, "scalar"),
                     (False, "scalar")}
    # the training code (8, 4, 2, 2) and serving's (4, 3, 1, 2) hold W in
    # registers
    assert 8 * 2 <= REG_TERMS and 4 * 2 <= REG_TERMS


# (F shape, F offset, P offset, MU offset, path) of the fused decode-apply:
# the vector path needs it for both P and MU
APPLY_PATHS = [
    ((8, 171776), 0, 0, 0, "vector"),
    ((8, 171776), 1, 0, 0, "scalar"),
    ((8, 171776), 0, 1, 0, "scalar"),
    ((8, 171776), 0, 0, 1, "scalar"),
    ((8, 171776), 0, 4, 4, "vector"),
    ((8, 1001), 0, 0, 0, "scalar"),
    ((1, 1001), 0, 0, 0, "vector"),
]


@pytest.mark.parametrize("shape,f_off,p_off,mu_off,path", APPLY_PATHS)
def test_decode_apply_path_choice(shape, f_off, p_off, mu_off, path):
    from repro_torch.kernels.coded_decode import apply_path
    L = shape[1]
    assert apply_path(_at(shape, "float32", f_off), _at((L, 2), "float32", p_off),
                      _at((L, 2), "float32", mu_off)) == path


@pytest.mark.parametrize("L", [1, 3, 7, 255, 256, 257, 1001, 171776,
                               303872, 4194311])
def test_decode_apply_partials_bound_any_grid(L):
    """The Σg² scratch has a slot for every block the kernel can launch: at
    most one block per THREADS of its items, L on the scalar path and L / 4
    (f32) or L / 8 (bf16) on the vector path, and never fewer than one."""
    from repro_torch.kernels.coded_decode import THREADS, partial_slots
    for items in (L, L // 4, L // 8):
        assert partial_slots(L) >= max(1, -(-items // THREADS))
    assert partial_slots(L) == -(-L // THREADS)
