"""The port's numpy core against the reference's: the copied modules are
pinned to their sources, and every host artifact (``C``, placement, decode
weights, partial decode weights) is equal exactly."""
import itertools
import pathlib

import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as port_core

torch.set_num_threads(1)

COPIED = ["schemes", "polynomial", "cyclic", "random_code", "tradeoff",
          "hetero"]

CONFIGS = [(5, 3, 1, 2), (5, 3, 2, 1), (5, 5, 2, 3), (8, 4, 1, 3),
           (8, 2, 0, 2), (10, 4, 1, 3), (16, 6, 2, 4), (8, 4, 2, 2),
           (4, 3, 1, 2)]


def _body(path):
    """Source lines apart from import lines."""
    return [ln for ln in pathlib.Path(path).read_text().splitlines()
            if not ln.lstrip().startswith(("import ", "from "))]


@pytest.mark.parametrize("name", COPIED)
def test_copied_module_equals_source(name):
    ref = pathlib.Path(ref_core.__file__).parent / f"{name}.py"
    port = pathlib.Path(port_core.__file__).parent / f"{name}.py"
    assert _body(ref) == _body(port)


@pytest.mark.parametrize("kind", ["poly", "random"])
@pytest.mark.parametrize("n,d,s,m", CONFIGS)
def test_code_artifacts_equal_exactly(kind, n, d, s, m):
    a = ref_core.GradCode(n=n, d=d, s=s, m=m, kind=kind)
    b = port_core.GradCode(n=n, d=d, s=s, m=m, kind=kind)
    assert np.array_equal(a.C, b.C)
    assert np.array_equal(a.P, b.P)
    assert np.array_equal(a.placement(), b.placement())
    assert np.array_equal(a.slot_mask(), b.slot_mask())
    assert np.array_equal(a.assignment, b.assignment)
    assert a.loads == b.loads and a.num_subsets == b.num_subsets


@pytest.mark.parametrize("kind", ["poly", "random"])
@pytest.mark.parametrize("n,d,s,m", CONFIGS)
def test_decode_weights_equal_exactly(kind, n, d, s, m):
    a = ref_core.GradCode(n=n, d=d, s=s, m=m, kind=kind)
    b = port_core.GradCode(n=n, d=d, s=s, m=m, kind=kind)
    sets = list(itertools.combinations(range(n), s))[:12]
    for st in sets:
        resp = np.setdiff1d(np.arange(n), st)
        assert np.array_equal(a.decode_weights(resp), b.decode_weights(resp))


@pytest.mark.parametrize("n,d,s,m", [(5, 3, 1, 2), (8, 4, 2, 2),
                                     (10, 4, 1, 3)])
def test_partial_decode_weights_equal_exactly(n, d, s, m):
    a = ref_core.make_code(n, d, s, m)
    b = port_core.make_code(n, d, s, m)
    for drop in range(0, s + 3):
        resp = np.arange(n)[drop:]
        Wa, ea = a.partial_decode_weights(resp)
        Wb, eb = b.partial_decode_weights(resp)
        assert np.array_equal(Wa, Wb) and ea == eb


def test_make_code_default_kind_and_oracle():
    assert port_core.make_code(16, 5, 1, 4).kind == "poly"
    assert port_core.make_code(32, 12, 4, 8).kind == "random"
    a, b = ref_core.make_code(8, 4, 2, 2), port_core.make_code(8, 4, 2, 2)
    G = np.random.default_rng(0).standard_normal((8, 12))
    assert np.array_equal(a.encode(G), b.encode(G))
    resp = [0, 1, 3, 4, 5, 7]
    assert np.array_equal(a.decode(a.encode(G), resp),
                          b.decode(b.encode(G), resp))


def test_hetero_code_equal_exactly():
    speeds = (1.0, 1.0, 2.0, 2.0, 4.0, 4.0)
    a = ref_core.make_hetero_code(speeds, s=1, m=2, k=6)
    b = port_core.make_hetero_code(speeds, s=1, m=2, k=6)
    assert np.array_equal(a.C, b.C)
    assert np.array_equal(a.placement(), b.placement())
    assert np.array_equal(a.slot_mask(), b.slot_mask())
    resp = np.arange(1, 6)
    assert np.array_equal(a.decode_weights(resp), b.decode_weights(resp))


def test_stable_kinds_wait_for_their_port():
    """The chebyshev and rotation kinds (``core.stable``, ported since the
    code families' slice) give the reference's coefficients exactly."""
    for kind in ("chebyshev", "rotation"):
        a = ref_core.GradCode(n=8, d=4, s=2, m=2, kind=kind)
        b = port_core.GradCode(n=8, d=4, s=2, m=2, kind=kind)
        assert np.array_equal(a.C, b.C)
