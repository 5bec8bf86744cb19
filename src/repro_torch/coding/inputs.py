"""Host-side per-step inputs for the coded aggregation.

Every straggler pattern maps to one set of small inputs
(``make_step_inputs``) fed to the same step function.  The float64
decode-weight solve runs on the host in numpy, matching the paper's remark
that master-side reconstruction is off the hot path.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np

if TYPE_CHECKING:
    from ..core.schemes import GradCode


def make_step_inputs(code: "GradCode",
                     stragglers: Sequence[int] | np.ndarray = (),
                     dtype=np.float32, partial: bool = False,
                     ) -> dict[str, np.ndarray]:
    """Host-side (float64 solve) per-straggler-pattern inputs to the step.

    Works for both the uniform ``GradCode`` and the heterogeneous
    ``HeteroCode`` (whose placement carries zero-weight padded slots).

    partial: with ``False`` (default, the paper's regime) more than ``s``
    stragglers raise — the code cannot decode exactly.  With ``True`` the
    decode degrades gracefully: least-squares weights are returned together
    with their error certificate (key ``err_factor``), and subsets whose
    every holder straggled are dropped from the rho weights instead of
    raising.

    Returns:
      mask : (n,)   1.0 at responders, 0.0 at stragglers
      W    : (n, m) decode weights, zero rows at stragglers
      rho  : (n, d) small-leaf weights: each subset counted once across its
             responding holders (equal split); zero at padded slots
      err_factor : () float scalar, only when ``partial=True`` — multiply by
             ``sqrt(sum_j ||g_j||^2)`` for the L2 decode-error bound
    """
    n, d = code.n, code.d
    idx = np.asarray(list(stragglers), dtype=int)
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(
            f"straggler indices {sorted(int(i) for i in idx)} out of range "
            f"for n={n} workers; restrict the draw to the active code "
            f"(StragglerDraw.restrict) after a cluster resize")
    st = np.zeros(n, dtype=bool)
    st[idx] = True
    if not partial and st.sum() > code.s:
        raise ValueError(
            f"more stragglers ({st.sum()}) than design s={code.s}; pass "
            f"partial=True to decode a least-squares approximation instead")
    resp = np.nonzero(~st)[0]
    if partial:
        W, err_factor = code.partial_decode_weights(resp)
        W = W.astype(dtype)
    else:
        W = code.decode_weights(resp).astype(dtype)
    # rho: for subset j, responding holders split weight equally
    rho = np.zeros((n, d), dtype=dtype)
    placement = code.placement()          # (n, d) subset ids
    valid = code.slot_mask()              # (n, d) False at padded slots
    holders: dict[int, list[int]] = {}
    for i in range(n):
        for slot, j in enumerate(placement[i]):
            if valid[i, slot]:
                holders.setdefault(int(j), []).append((i, slot))
    for j, lst in holders.items():
        live = [(i, slot) for (i, slot) in lst if not st[i]]
        if not live:
            if partial:
                continue  # uncovered subset: dropped from the approximation
            raise ValueError(f"subset {j} has no responding holder")
        for (i, slot) in live:
            rho[i, slot] = 1.0 / len(live)
    out = {"mask": (~st).astype(dtype), "W": W, "rho": rho}
    if partial:
        out["err_factor"] = np.asarray(err_factor, dtype=dtype)
    return out


def admit_code(code: "GradCode", n_data: int | None = None,
               max_cond: float | None = None) -> "GradCode":
    """Admission check for a scheme object entering the coded runtime.

    Validates the ``GradCode`` duck contract the train step relies on —
    coefficient/placement shape consistency and a worker-count match when
    ``n_data`` is given.  ``max_cond`` is a ceiling on the construction's
    certified decode conditioning (``core.stable.certified_cond_of``).
    Returns ``code`` unchanged on success.
    """
    n, d, m = code.n, code.d, code.m
    C = np.asarray(code.C)
    placement = np.asarray(code.placement())
    valid = np.asarray(code.slot_mask())
    if C.shape != (n, d, m):
        raise ValueError(
            f"code.C has shape {C.shape}, expected (n, d, m) = {(n, d, m)}")
    if placement.shape != (n, d) or valid.shape != (n, d):
        raise ValueError(
            f"placement/slot_mask shapes {placement.shape}/{valid.shape} "
            f"do not match (n, d) = {(n, d)}")
    k = int(getattr(code, "num_subsets", n))
    if placement[valid].size and (placement[valid].min() < 0
                                  or placement[valid].max() >= k):
        raise ValueError(
            f"placement references subsets outside 0..{k - 1}")
    if n_data is not None and n != n_data:
        raise ValueError(
            f"code has n={n} workers but the worker group provides "
            f"n_data={n_data} data-parallel slots")
    if max_cond is not None:
        from ..core.stable import certified_cond_of
        cond = certified_cond_of(code)
        if not cond <= float(max_cond):
            raise ValueError(
                f"certified decode conditioning {cond:.3g} exceeds the "
                f"admission ceiling max_cond={float(max_cond):.3g} for "
                f"{code.describe()}")
    return code


def uncovered_subsets(code: "GradCode",
                      stragglers: Sequence[int] | np.ndarray = ()) -> int:
    """Number of data subsets whose every holder straggled (their
    contribution is unrecoverable; only relevant in partial mode)."""
    st = np.zeros(code.n, dtype=bool)
    st[np.asarray(list(stragglers), dtype=int)] = True
    placement, valid = code.placement(), code.slot_mask()
    covered: set[int] = set()
    for i in range(code.n):
        if st[i]:
            continue
        covered.update(int(j) for slot, j in enumerate(placement[i])
                       if valid[i, slot])
    return code.num_subsets - len(covered)
