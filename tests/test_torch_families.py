"""The remaining code families in the port (``approx``, ``stable``,
``stability``, ``runtime_model``) against the reference's: the copied modules
are pinned to their sources, every host artifact and certificate is equal
exactly, and each family (rotation, chebyshev, block, frc, expander, hetero)
goes through the port's coded step on the same parameters, batch and
straggler pattern as through the reference's.

Step tolerance: rtol=1e-4, atol=1e-5, as the trajectories of
``test_torch_step.py`` (f32 on both sides, terms added in other orders).
Inside the port, packed ≡ per-leaf and fill + drain ≡ sync hold bitwise.
"""
import ast
import dataclasses
import functools
import itertools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.coding as jc
import repro.core as jcore
import repro.data as jdata
import repro.optim as joptim
import repro_torch.coding as tc
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.optim as toptim
from repro.configs import get_config as jget_config
from repro.core import approx as japprox, stability as jstability
from repro.core import runtime_model as jrm, stable as jstable
from repro.launch.mesh import make_local_mesh
from repro.train.coded_step import make_coded_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs import get_config as tget_config
from repro_torch.core import approx as tapprox, stability as tstability
from repro_torch.core import runtime_model as trm, stable as tstable
from repro_torch.train import PipelineDriver
from repro_torch.train import make_coded_train_step as tmake_step

torch.set_num_threads(1)

N = 4
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
SPEEDS = (0.5, 1.0, 1.0, 1.5)


def ast_without_imports(path) -> str:
    """A module's syntax tree with every import statement removed, so a
    relative import that replaces an absolute one (and re-aligns its
    continuation lines) does not count as a difference."""
    class _Strip(ast.NodeTransformer):
        def visit_Import(self, node):
            return None

        def visit_ImportFrom(self, node):
            return None

    tree = _Strip().visit(ast.parse(pathlib.Path(path).read_text()))
    return ast.dump(tree, include_attributes=False)


@pytest.mark.parametrize("name", ["approx", "stable", "stability",
                                  "runtime_model"])
def test_copied_module_equals_source(name):
    ref = pathlib.Path(jcore.__file__).parent / f"{name}.py"
    port = pathlib.Path(tcore.__file__).parent / f"{name}.py"
    assert ast_without_imports(port) == ast_without_imports(ref)


def test_core_exports_the_references_names():
    assert tcore.__all__ == jcore.__all__


# ------------------------------------------------------ host artifacts
def _codes(mod_core, mod_approx, mod_stable):
    """The fixtures of the reference's ``test_stable.py``,
    ``test_approx.py`` and ``test_hetero.py``, built by one side."""
    return {
        "rotation-4": mod_stable.make_stable("rotation", N, 3, 1, 2),
        "chebyshev-4": mod_stable.make_stable("chebyshev", N, 3, 1, 2),
        "block-4": mod_stable.make_stable("block", N, 2, 1, 1, n0=2),
        "rotation-8": mod_stable.make_stable("rotation", 8, 5, 3, 2),
        "chebyshev-8": mod_stable.make_stable("chebyshev", 8, 3, 1, 2),
        "block-8": mod_stable.make_stable("block", 8, 3, 1, 2, n0=4),
        "rotation-16": mod_stable.make_stable("rotation", 16, 6, 4, 2),
        "block-16": mod_stable.make_stable("block", 16, 3, 1, 2, n0=8),
        "frc-r2-m1": mod_approx.make_frc(N, 1, 1),
        "frc-r1-m2": mod_approx.make_frc(N, 0, 2),
        "exp-c2-m1": mod_approx.make_expander(N, 2, 1),
        "exp-c1-m2": mod_approx.make_expander(N, 1, 2),
        "frc-8": mod_approx.make_frc(8, 3, 1),
        "exp-8": mod_approx.make_expander(8, 3, 1, seed=5),
        "hetero": mod_core.make_hetero_code(SPEEDS, s=1, m=2),
        "hetero-random": mod_core.make_hetero_code(SPEEDS, s=1, m=2,
                                                   kind="random"),
    }


@functools.lru_cache(maxsize=None)
def _both():
    return (_codes(jcore, japprox, jstable), _codes(tcore, tapprox, tstable))


CODE_IDS = list(_codes(jcore, japprox, jstable))


@pytest.mark.parametrize("cid", CODE_IDS)
def test_code_artifacts_equal_exactly(cid):
    a, b = _both()[0][cid], _both()[1][cid]
    assert type(a).__name__ == type(b).__name__
    assert (a.n, a.d, a.s, a.m) == (b.n, b.d, b.s, b.m)
    assert a.num_subsets == b.num_subsets and a.loads == b.loads
    assert np.array_equal(a.C, b.C)
    assert np.array_equal(a.P, b.P)
    assert np.array_equal(a.placement(), b.placement())
    assert np.array_equal(a.slot_mask(), b.slot_mask())
    assert a.describe() == b.describe()


@pytest.mark.parametrize("cid", CODE_IDS)
def test_decode_weights_equal_exactly(cid):
    """Exact decode on patterns within the structural budget, the partial
    decode and its certificate on every pattern up to s + 2 stragglers."""
    a, b = _both()[0][cid], _both()[1][cid]
    n = a.n
    for t in range(min(a.s + 2, n - 1) + 1):
        for st in list(itertools.combinations(range(n), t))[:8]:
            resp = np.setdiff1d(np.arange(n), st)
            if t <= a.s:
                try:
                    want = a.decode_weights(resp)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)[:20]):
                        b.decode_weights(resp)
                else:
                    assert np.array_equal(want, b.decode_weights(resp))
            Wa, ea = a.partial_decode_weights(resp)
            Wb, eb = b.partial_decode_weights(resp)
            assert np.array_equal(Wa, Wb) and ea == eb


@pytest.mark.parametrize("cid", [c for c in CODE_IDS
                                 if c.startswith(("frc", "exp"))])
def test_approx_certificates_equal_exactly(cid):
    a, b = _both()[0][cid], _both()[1][cid]
    for t in range(a.n):
        assert a.worst_err_bound(t) == b.worst_err_bound(t)
    if cid.startswith("exp"):
        assert a.spectral_gaps == b.spectral_gaps
    assert a.comm_fraction == b.comm_fraction


@pytest.mark.parametrize("cid", [c for c in CODE_IDS
                                 if c.startswith(("rot", "cheb", "block"))])
def test_stable_certificates_equal_exactly(cid):
    a, b = _both()[0][cid], _both()[1][cid]
    assert jstable.certified_cond_of(a) == tstable.certified_cond_of(b)
    assert (jstable.certified_decode_err_bound(a)
            == tstable.certified_decode_err_bound(b))
    assert (jstability.worst_decode_relative_error(a, trials=8, seed=2)
            == tstability.worst_decode_relative_error(b, trials=8, seed=2))


def test_certificate_functions_equal_exactly():
    for fam in ("chebyshev", "rotation"):
        for n, s in [(8, 2), (10, 3), (16, 4)]:
            assert (jstable.certified_cond(fam, n, s)
                    == tstable.certified_cond(fam, n, s))
            ra, rb = (jstable.dropped_rows(fam, n, s),
                      tstable.dropped_rows(fam, n, s))
            assert np.array_equal(ra, rb)
            assert (jstable.certified_max_cond(ra, s)
                    == tstable.certified_max_cond(rb, s))
    for n, s in [(8, 2), (12, 3), (64, 3)]:
        assert (jstable.classic_certified_cond(n, s)
                == tstable.classic_certified_cond(n, s))
    assert (jstable.block_certified_cond(4, 3, 1, 2)
            == tstable.block_certified_cond(4, 3, 1, 2))
    assert np.array_equal(jstable.chebyshev_basis(9),
                          tstable.chebyshev_basis(9))
    assert np.array_equal(jstable.rotation_basis(9, 3),
                          tstable.rotation_basis(9, 3))


@pytest.mark.parametrize("family", ["chebyshev", "rotation", "block"])
def test_stable_candidates_equal_exactly(family):
    a = list(jstable.stable_candidates(family, 8))
    b = list(tstable.stable_candidates(family, 8))
    assert a == b and a
    for d, s, m, n0, _ in a:
        ca = jstable.make_stable(family, 8, d, s, m, n0=n0)
        cb = tstable.make_stable(family, 8, d, s, m, n0=n0)
        assert np.array_equal(ca.C, cb.C)


@pytest.mark.parametrize("family", ["frc", "expander"])
def test_approx_candidates_equal_exactly(family):
    a = list(japprox.approx_candidates(family, 8))
    b = list(tapprox.approx_candidates(family, 8))
    assert [(r, m) for r, m, _ in a] == [(r, m) for r, m, _ in b] and a
    for (_, _, ca), (_, _, cb) in zip(a, b):
        assert np.array_equal(ca.C, cb.C)
        assert np.array_equal(ca.placement(), cb.placement())
    for rep, m in [(2, 1), (1, 2), (4, 1)]:
        ca = japprox.make_approx(family, 8, rep, m)
        cb = tapprox.make_approx(family, 8, rep, m)
        assert np.array_equal(ca.C, cb.C)


def test_chebyshev_and_rotation_kinds_equal_exactly():
    for kind in ("chebyshev", "rotation"):
        for n, d, s, m in [(8, 4, 2, 2), (10, 4, 1, 3), (5, 3, 1, 2)]:
            a = jcore.GradCode(n=n, d=d, s=s, m=m, kind=kind, seed=1)
            b = tcore.GradCode(n=n, d=d, s=s, m=m, kind=kind, seed=1)
            assert np.array_equal(a.C, b.C)
            resp = np.arange(s, n)
            assert np.array_equal(a.decode_weights(resp),
                                  b.decode_weights(resp))


def test_stability_functions_equal_exactly():
    V = jcore.GradCode(n=10, d=4, s=2, m=2).V
    assert (jstability.max_condition_number(V, 7, seed=3)
            == tstability.max_condition_number(V, 7, seed=3))
    assert (jstability.empirical_gamma(V, 6, 1e3)
            == tstability.empirical_gamma(V, 6, 1e3))
    for n, n1, kappa in [(10, 8, 1e3), (20, 15, 1e6), (64, 60, 1e4)]:
        assert (jstability.gamma_upper_bound(n, n1, kappa)
                == tstability.gamma_upper_bound(n, n1, kappa))
        assert jstability.f_n_n1(n, n1, 2.0) == tstability.f_n_n1(n, n1, 2.0)
    for size in (2, (0, 3)):
        assert (list(jstability.sample_straggler_sets(8, size, 12, seed=4))
                == list(tstability.sample_straggler_sets(8, size, 12,
                                                         seed=4)))


def test_runtime_model_equal_exactly():
    pa = jrm.RuntimeParams(n=8, lambda1=0.8, lambda2=0.1, t1=1.6, t2=6.0)
    pb = trm.RuntimeParams(n=8, lambda1=0.8, lambda2=0.1, t1=1.6, t2=6.0)
    for d, s, m in [(4, 1, 3), (8, 4, 4), (1, 0, 1)]:
        assert (jrm.expected_total_runtime(pa, d, s, m, npts=8000)
                == trm.expected_total_runtime(pb, d, s, m, npts=8000))
        assert (jrm.expected_total_runtime_overlapped(pa, d, s, m,
                                                      npts=8000)
                == trm.expected_total_runtime_overlapped(pb, d, s, m,
                                                         npts=8000))
        assert np.array_equal(jrm.simulate_runtimes(pa, d, s, m, 50, seed=1),
                              trm.simulate_runtimes(pb, d, s, m, 50, seed=1))
    assert (jrm.optimal_triple(pa, npts=8000)
            == trm.optimal_triple(pb, npts=8000))
    assert np.array_equal(jrm.runtime_table(pa, npts=4000),
                          trm.runtime_table(pb, npts=4000), equal_nan=True)
    assert jrm.proposition1_optimal_d(pa) == trm.proposition1_optimal_d(pb)


# ------------------------------------------------------- the coded step
STEP_IDS = ["rotation-4", "chebyshev-4", "block-4", "frc-r2-m1",
            "exp-c2-m1", "hetero"]


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = dataclasses.replace(jget_config("logistic-paper"), d_model=64)
    tcfg = dataclasses.replace(tget_config("logistic-paper"), d_model=64)
    batch = tdata.make_synthetic_batch(np.random.default_rng(0), tcfg, 16, 0)
    beta = (0.1 * np.random.default_rng(11).standard_normal(64)).astype(
        np.float32)
    return jcfg, tcfg, batch, beta


def _stragglers(code):
    """A pattern past the structural budget for the approx families (they
    decode partially), one straggler within it for the exact ones."""
    partial = isinstance(code, (japprox.FractionalRepetitionCode,
                                japprox.ExpanderCode,
                                tapprox.FractionalRepetitionCode,
                                tapprox.ExpanderCode))
    return ((0, 1) if partial else (2,)), partial


def _ref_step(cid, schedule):
    jcfg, _, batch, beta = _setup()
    code = _both()[0][cid]
    stragglers, partial = _stragglers(code)
    opt = joptim.get_optimizer("sgd", 1e-2)
    arts = jmake_step(jcfg, code, make_local_mesh(N, 1), opt,
                      spec=jc.SchemeSpec(schedule=schedule, partial=partial,
                                         backend="ref"))
    placed = jax.tree.map(jnp.asarray, jdata.CodedBatcher(code).place(batch))
    inp = arts.step_inputs(stragglers)
    args = [inp["W"], inp["mask"], inp["rho"]]
    if partial:
        args.append(inp["err_factor"])
    params = {"beta": jnp.asarray(beta)}
    p2, _, metrics = arts.compiled(placed)(params, opt.init(params), placed,
                                           *args)
    return (np.asarray(p2["beta"]),
            {k: float(np.asarray(v).ravel()[0]) for k, v in metrics.items()})


def _port_step(cid, schedule, packed=True, stragglers=None):
    _, tcfg, batch, beta = _setup()
    code = _both()[1][cid]
    st, partial = _stragglers(code)
    opt = toptim.get_optimizer("sgd", 1e-2)
    arts = tmake_step(tcfg, code, opt, device="cpu",
                      spec=tc.SchemeSpec(schedule=schedule, partial=partial,
                                         packed=packed))
    placed = tdata.CodedBatcher(code).place(
        {k: torch.as_tensor(v) for k, v in batch.items()})
    inp = arts.step_inputs(st if stragglers is None else stragglers)
    args = [inp["W"], inp["mask"], inp["rho"]]
    if partial:
        args.append(inp["err_factor"])
    params = convert.params_from_jax({"beta": beta}, device="cpu")
    p2, o2, metrics = arts.step(params, opt.init(params), placed, *args)
    return p2["beta"], o2, metrics


@pytest.mark.parametrize("schedule", ["gather", "a2a"])
@pytest.mark.parametrize("cid", STEP_IDS)
def test_family_step_matches_reference(cid, schedule):
    want, mj = _ref_step(cid, schedule)
    got, _, mt = _port_step(cid, schedule)
    np.testing.assert_allclose(got.numpy(), want, **TRAJ_TOL)
    assert set(mt) == set(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), mj[k], err_msg=k,
                                   **TRAJ_TOL)


@pytest.mark.parametrize("cid", ["frc-r2-m1", "exp-c2-m1"])
def test_approx_step_past_s_reports_the_references_bound(cid):
    """Two stragglers against an approx code (structural s of 1 and 0):
    the partial step's ``decode_err_bound`` is the reference's."""
    _, mj = _ref_step(cid, "gather")
    _, _, mt = _port_step(cid, "gather")
    assert mj["decode_err_bound"] > 0
    np.testing.assert_allclose(float(mt["decode_err_bound"]),
                               mj["decode_err_bound"], **TRAJ_TOL)


@pytest.mark.parametrize("schedule", ["gather", "a2a"])
@pytest.mark.parametrize("cid", STEP_IDS)
def test_family_packed_equals_per_leaf_bitwise(cid, schedule):
    a, oa, ma = _port_step(cid, schedule, packed=True)
    b, ob, mb = _port_step(cid, schedule, packed=False)
    assert torch.equal(a, b)
    assert all(torch.equal(oa[k]["beta"], ob[k]["beta"])
               for k in oa if isinstance(oa[k], dict))
    assert set(ma) == set(mb)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)


@pytest.mark.parametrize("cid", ["rotation-4", "chebyshev-4", "block-4"])
def test_stable_fill_drain_equals_sync_bitwise(cid):
    """fill + drain of the pipelined step reproduces the synchronous step
    bit for bit for every stable family, chained over two patterns."""
    _, tcfg, batch, beta = _setup()
    code = _both()[1][cid]
    opt = toptim.get_optimizer("sgd", 1e-2)
    arts_s = tmake_step(tcfg, code, opt, device="cpu",
                        spec=tc.SchemeSpec())
    arts_p = tmake_step(tcfg, code, opt, device="cpu",
                        spec=tc.SchemeSpec(pipelined=True))
    placed = tdata.CodedBatcher(code).place(
        {k: torch.as_tensor(v) for k, v in batch.items()})
    ps = pp = convert.params_from_jax({"beta": beta}, device="cpu")
    os_ = op = opt.init(ps)
    drv = PipelineDriver(arts_p)
    for strag in ((2,), ()):
        inp = arts_s.step_inputs(strag)
        args = (inp["W"], inp["mask"], inp["rho"])
        ps, os_, ms = arts_s.step(ps, os_, placed, *args)
        pp, op, mp = drv.step(pp, op, placed, *args)
        assert mp is None
        pp, op, mp = drv.drain(pp, op)
        assert torch.equal(ps["beta"], pp["beta"])
        assert torch.equal(os_["mu"]["beta"], op["mu"]["beta"])
        assert all(torch.equal(ms[k], mp[k]) for k in ms)


def test_block_and_hetero_layouts_reach_the_step():
    """A block composite has k = blocks * k0 subsets and a hetero code
    padded zero slots; both give the uncoded update with a straggler."""
    want, _, _ = _port_step("block-4", "gather", stragglers=())
    for cid, st in [("block-4", (1,)), ("hetero", (0,)), ("hetero", (3,))]:
        got, _, _ = _port_step(cid, "gather", stragglers=st)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    blk, het = _both()[1]["block-4"], _both()[1]["hetero"]
    assert blk.num_subsets == 2 * 2 and not het.slot_mask().all()
