"""Double-double dense linear algebra: Cholesky and Jacobi eigensolver.

Why this exists: the dd2 precision tier (dd-stored iterates, ipm/state.py)
measured a total-DIMACS floor of 9.4e-14 pinned by the *f64 NT scaling* —
past mu ~ 1e-14 the congruent spectrum eig(L_x' S L_x) = eig(XS) sinks
below the f64 formation noise u64*||M|| and the scaling basis is noise
(docs/precision.md "the f64 NT wall"). The reference does not have this
wall because its whole pipeline, including `prepare_W`'s Cholesky/SVD, is
type-generic over MultiFloats (Loraine.jl `src/Solvers.jl:18`,
`src/prepare_W.jl:41-45`: generic `svd` for `T != Float64`). The batched
equivalent is this module: the NT factorizations themselves in dd pairs.

Design notes:
- dd scalars are (hi, lo) f64 pairs (ops/dd.py); every kernel here is
  branch-free, vectorized over the batch, and jit-safe.
- `dd_matmul` keeps the heavy FLOPs GEMM-shaped: the hi x hi product
  uses the Ozaki error-free slicing (ops/ozaki.py), the cross terms are
  plain f64 GEMMs (their own rounding is ~u64^2 of the total).
- `dd_chol` is a column-recurrence (m sequential rounds of O(m^2)
  vectorized dd work) — the same shape as the f64 blocked factorization's
  panel step, at sizes where NT blocks live (m <= a few hundred).
- `dd_eigh_jacobi` is the round-robin parallel cyclic Jacobi of
  ops/eigh.py re-based on dd arithmetic, warm-startable from an f64
  eigenbasis. Jacobi is the right algorithm twice over here: it computes
  tiny eigenvalues of graded SPD matrices to high *relative* accuracy
  (exactly the eig(XS) ~ mu regime), and its rotations are elementwise —
  no inner factorizations to re-derive in dd.

No data-dependent Python control flow: regularization/fallback decisions
are jnp.where selects on an `ok` flag computed alongside (the caller falls
back to the f64 NT path per block group when the dd factorization reports
failure). Denominators are sanitized before every divide, so the
not-taken branch of a where() never holds an inf.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .dd import DD, dd_add, dd_mul_f64, dd_neg, dd_sum, two_prod, two_sum
from .ozaki import acc_matmul

__all__ = [
    "dd_mul",
    "dd_sqr",
    "dd_const",
    "dd_div",
    "dd_sqrt",
    "dd_abs",
    "dd_transpose",
    "dd_sym",
    "dd_matmul",
    "dd_chol",
    "dd_eigh_jacobi",
]


def _renorm(hi: jax.Array, lo: jax.Array) -> DD:
    s = hi + lo
    # fold-blocker: see ops/dd.py two_sum
    t = (s - hi) + 0.0 * lo
    return DD(s, lo - t)


def dd_mul(x: DD, y: DD) -> DD:
    """Full dd * dd (error ~2^-104 relative)."""
    p = two_prod(x.hi, y.hi)
    t = x.hi * y.lo + x.lo * y.hi
    return _renorm(p.hi, p.lo + t)


def _dealias(x: DD) -> DD:
    """Break graph-node identity without changing values. MEASURED XLA:CPU
    behavior (tests/test_dd_linalg.py::test_dd_sqr_alias_safety): when both
    operands of a dd product are the SAME traced node (x*x), the compiler's
    simplifier folds the error-free-transform identities and the result
    degrades to plain-f64 accuracy (8.6e-17 relative); with value-equal but
    distinct nodes the dd accuracy (3.9e-33) is preserved. ``0.0 * x`` is
    not folded by XLA (unsafe under NaN/inf), so ``x + 0.0 * x`` yields a
    distinct node with an identical value."""
    return DD(x.hi + 0.0 * x.lo, x.lo + 0.0 * x.hi)


def dd_sqr(x: DD) -> DD:
    """Alias-safe dd square: use THIS, never dd_mul(x, x)."""
    return dd_mul(x, _dealias(x))


def dd_const(c: float, like: jax.Array) -> DD:
    """An opaque dd constant shaped like ``like``. MEASURED XLA:CPU
    behavior: a LITERAL constant operand in two_sum lets the simplifier
    fold ``s - (s - c) -> c``, silently degrading two_sum to fast-two-sum
    (only valid when the constant dominates) — dd_add(one, t2) lost to
    f64-class error whenever |t2| > 1. ``0.0 * like + c`` is a data-
    dependent node the simplifier will not fold."""
    z = 0.0 * like
    return DD(z + c, z)


def dd_div(x: DD, y: DD) -> DD:
    """dd / dd via two corrected f64 quotients. ``y.hi`` must be nonzero
    (callers sanitize); no inf is produced for sane inputs."""
    yh = jnp.where(y.hi != 0.0, y.hi, 1.0)
    q1 = x.hi / yh
    r = dd_add(x, dd_neg(dd_mul_f64(y, q1)))
    q2 = r.hi / yh
    r2 = dd_add(r, dd_neg(dd_mul_f64(y, q2)))
    q3 = r2.hi / yh
    q = two_sum(q1, q2)
    return _renorm(q.hi, q.lo + q3)


def dd_sqrt(x: DD) -> DD:
    """sqrt of a nonnegative dd (one dd-corrected Newton step: the f64 seed
    carries u64 error, the correction brings it to ~u64^2). x.hi <= 0 maps
    to exactly 0 (callers clamp/flag separately)."""
    pos = x.hi > 0.0
    xh = jnp.where(pos, x.hi, 1.0)
    s = jnp.sqrt(xh)
    s2 = two_prod(s, s + 0.0 * s)  # alias-safe square (see _dealias)
    r = dd_add(DD(xh, jnp.where(pos, x.lo, 0.0)), DD(-s2.hi, -s2.lo))
    d = r.hi / (2.0 * s)
    out = two_sum(s, d)
    return DD(jnp.where(pos, out.hi, 0.0), jnp.where(pos, out.lo, 0.0))


def dd_abs(x: DD) -> DD:
    neg = x.hi < 0.0
    return DD(jnp.where(neg, -x.hi, x.hi), jnp.where(neg, -x.lo, x.lo))


def dd_transpose(x: DD) -> DD:
    return DD(jnp.swapaxes(x.hi, -1, -2), jnp.swapaxes(x.lo, -1, -2))


def dd_sym(x: DD) -> DD:
    xt = dd_transpose(x)
    s = dd_add(x, xt)
    return DD(0.5 * s.hi, 0.5 * s.lo)  # exact halving


def dd_matmul(A: DD, B: DD, bits: int = 106) -> DD:
    """(A.hi + A.lo) @ (B.hi + B.lo) in dd. The hi x hi product is the
    Ozaki-sliced exact GEMM stack; the cross terms are plain f64 GEMMs
    (relative error u64 on terms that are already u64-small). GEMM-shaped
    throughout."""
    r = acc_matmul(A.hi, B.hi, bits=bits)
    cross = A.hi @ B.lo + A.lo @ B.hi
    s = two_sum(r.hi, cross)
    return _renorm(s.hi, s.lo + r.lo)


# ---------------------------------------------------------------------------
# Cholesky
# ---------------------------------------------------------------------------


@jax.jit
def dd_chol(A: DD) -> Tuple[DD, jax.Array]:
    """Batched dd Cholesky of SPD [nb, m, m] dd matrices.

    Returns (L, ok) with A = L L^T to ~2^-104 relative and ``ok`` a [nb]
    bool — False where a pivot was nonpositive at dd resolution (the
    factorization value is garbage there; callers select the f64 fallback).

    Left-looking column recurrence: at step j every inner product
    sum_k L[i,k] L[j,k] (k < j) is a vectorized dd dot over the already-
    computed columns (uncomputed columns are exactly zero, so no masking of
    the contraction is needed). m sequential rounds of O(nb * m^2)
    elementwise dd work — the same O(m^3) total as the f64 factorization.
    """
    nb, m, _ = A.hi.shape
    dtype = A.hi.dtype
    Lh0 = jnp.zeros((nb, m, m), dtype=dtype)
    Ll0 = jnp.zeros((nb, m, m), dtype=dtype)
    ok0 = jnp.ones((nb,), dtype=bool)
    rows = jnp.arange(m)

    def body(j, carry):
        Lh, Ll, ok = carry
        # row j of L (zero beyond column j-1): [nb, 1, m]
        rjh = jax.lax.dynamic_slice_in_dim(Lh, j, 1, axis=1)
        rjl = jax.lax.dynamic_slice_in_dim(Ll, j, 1, axis=1)
        # t[i] = sum_k L[i, k] * L[j, k] in dd
        p = dd_mul(DD(Lh, Ll), DD(rjh, rjl))  # [nb, m, m] elementwise
        t = dd_sum(p, axis=-1)  # [nb, m]
        # c[i] = A[i, j] - t[i]
        ajh = jax.lax.dynamic_slice_in_dim(A.hi, j, 1, axis=2)[..., 0]
        ajl = jax.lax.dynamic_slice_in_dim(A.lo, j, 1, axis=2)[..., 0]
        c = dd_add(DD(ajh, ajl), dd_neg(t))
        # pivot d = c[j]
        dh = jax.lax.dynamic_slice_in_dim(c.hi, j, 1, axis=1)  # [nb, 1]
        dl = jax.lax.dynamic_slice_in_dim(c.lo, j, 1, axis=1)
        pos = dh > 0.0
        ok = jnp.logical_and(ok, pos[:, 0])
        d = DD(jnp.where(pos, dh, 1.0), jnp.where(pos, dl, 0.0))
        piv = dd_sqrt(d)  # [nb, 1]
        col = dd_div(c, DD(jnp.broadcast_to(piv.hi, c.hi.shape),
                           jnp.broadcast_to(piv.lo, c.lo.shape)))
        below = (rows > j)[None, :]
        at_j = (rows == j)[None, :]
        colh = jnp.where(below, col.hi, 0.0) + jnp.where(at_j, piv.hi, 0.0)
        coll = jnp.where(below, col.lo, 0.0) + jnp.where(at_j, piv.lo, 0.0)
        Lh = jax.lax.dynamic_update_slice_in_dim(Lh, colh[..., None], j, axis=2)
        Ll = jax.lax.dynamic_update_slice_in_dim(Ll, coll[..., None], j, axis=2)
        return Lh, Ll, ok

    Lh, Ll, ok = jax.lax.fori_loop(0, m, body, (Lh0, Ll0, ok0))
    return DD(Lh, Ll), ok


# ---------------------------------------------------------------------------
# Jacobi eigensolver
# ---------------------------------------------------------------------------


def _rotation(app: DD, aqq: DD, apq: DD) -> Tuple[DD, DD]:
    """dd Givens rotation (c, s) zeroing the (p, q) entries, vectorized
    over [nb, npairs]. Inactive pairs (|apq| below the dd threshold
    relative to the geometric diagonal scale — the Demmel-Veselic relative
    criterion, right for graded spectra) get the identity rotation."""
    # relative threshold against sqrt(|app*aqq|): rotations stop once the
    # off-diagonal is dd-negligible *relative to its own eigenvalue scale*
    scale = jnp.sqrt(jnp.abs(app.hi * aqq.hi)) + 1e-300
    active = jnp.abs(apq.hi) > 2.0**-100 * scale
    apq_s = DD(jnp.where(active, apq.hi, 1.0), jnp.where(active, apq.lo, 0.0))

    num = dd_add(aqq, dd_neg(app))
    den = dd_mul_f64(apq_s, jnp.asarray(2.0, app.hi.dtype))
    tau = dd_div(num, den)
    # guard tau^2 overflow: past |tau| ~ 1e150 use the asymptotic
    # t = 1/(2 tau) (error < 1e-300, far below dd resolution)
    big = jnp.abs(tau.hi) > 1e150
    tau_c = DD(jnp.where(big, 1.0, tau.hi), jnp.where(big, 0.0, tau.lo))
    sgn = jnp.where(tau.hi >= 0.0, 1.0, -1.0)
    tau2 = dd_sqr(tau_c)
    one = dd_const(1.0, tau.hi)
    root = dd_sqrt(dd_add(one, tau2))
    den_t = dd_add(dd_abs(tau_c), root)
    t_small = dd_div(one, den_t)
    t_small = DD(sgn * t_small.hi, sgn * t_small.lo)
    t_big = dd_div(one, dd_mul_f64(tau, jnp.asarray(2.0, tau.hi.dtype)))
    t = DD(jnp.where(big, t_big.hi, t_small.hi),
           jnp.where(big, t_big.lo, t_small.lo))
    t = DD(jnp.where(active, t.hi, 0.0), jnp.where(active, t.lo, 0.0))

    c = dd_div(one, dd_sqrt(dd_add(one, dd_sqr(t))))
    s = dd_mul(t, c)
    return c, s


def _perm_table(pairs: "jnp.ndarray | None", m: int):
    """From the round-robin pair schedule (numpy, trace-time constants):
    perm [nrounds, m] partner index per round, eye_tab / hot_tab
    [nrounds, m, m] 0/1 masks with hot_tab[r][perm[j], j] = 1 (the J-matrix
    scaffolds for the GEMM-anchored rotation application)."""
    import numpy as np

    pr = np.asarray(pairs)
    nrounds = pr.shape[0]
    perm = np.empty((nrounds, m), dtype=np.int32)
    for r in range(nrounds):
        p, q = pr[r, 0], pr[r, 1]
        perm[r, p] = q
        perm[r, q] = p
    eye = np.broadcast_to(np.eye(m), (nrounds, m, m)).copy()
    hot = np.zeros((nrounds, m, m))
    for r in range(nrounds):
        hot[r, perm[r], np.arange(m)] = 1.0
    return perm, eye, hot


def _dd_take(x: DD, idx: jax.Array, axis: int) -> DD:
    return DD(jnp.take(x.hi, idx, axis=axis), jnp.take(x.lo, idx, axis=axis))


@partial(jax.jit, static_argnames=("sweeps",))
def _dd_jacobi_impl(M: DD, V0: DD, perm_tab: jax.Array, eye_tab: jax.Array,
                    hot_tab: jax.Array, sweeps: int):
    """GEMM-anchored formulation: every round builds the full rotation
    matrix J (identity pattern with the m/2 Givens 2x2 blocks) from 0/1
    one-hot masks and applies

        A <- J^T A J,   V <- V J        (dd_matmul: Ozaki exact GEMMs)

    Why matmuls and not elementwise row/col updates: the elementwise
    formulation is ~25x cheaper in FLOPs, but XLA:CPU's loop-fusion
    emitter was MEASURED (eager-vs-jit comparisons, 2026-08) to contract
    the error-free transforms inside the fused rotation updates down to
    f64-class accuracy — across scatter, gather+broadcast, and unrolled
    variants alike — while products lowered through dot_general (the
    Ozaki slices inside dd_matmul, and dd_add on GEMM outputs) keep full
    dd accuracy under jit on every backend. J entries are exact (0/1 masks scale c, s
    by multiplication), so the transform inherits dd_matmul's ~2^-104
    accuracy.

    ``eye_tab``/``hot_tab``: [nrounds, m, m] 0/1 f64 masks with
    eye_tab[r] = I and hot_tab[r][k, j] = 1 iff k == perm[j] (built
    host-side from the static schedule).
    """
    nb, m, _ = M.hi.shape
    nrounds = perm_tab.shape[0]
    idx = jnp.arange(m)

    def round_body(r, carry):
        Ah, Al, Vh, Vl = carry
        A = DD(Ah, Al)
        V = DD(Vh, Vl)
        perm = perm_tab[r]  # [m]
        is_p = idx < perm

        diag = DD(
            jnp.diagonal(Ah, axis1=-2, axis2=-1),
            jnp.diagonal(Al, axis1=-2, axis2=-1),
        )  # [nb, m]
        ajj = _dd_take(diag, perm, axis=1)
        # off-diagonal entry A[i, perm[i]] per index i
        offh = jnp.take_along_axis(Ah, perm[None, :, None], axis=2)[..., 0]
        offl = jnp.take_along_axis(Al, perm[None, :, None], axis=2)[..., 0]
        off = DD(offh, offl)

        c_all, s_all = _rotation(diag, ajj, off)  # per-index; q-role is the
        # p-role's mirror: gather the partner's values so both indices use
        # BIT-IDENTICAL c and exactly-negated s (keeps the two-sided update
        # symmetric to the last bit)
        c_part = _dd_take(c_all, perm, axis=1)
        s_part = _dd_take(s_all, perm, axis=1)
        c = DD(jnp.where(is_p, c_all.hi, c_part.hi),
               jnp.where(is_p, c_all.lo, c_part.lo))
        # column-update convention (A J)[i, j] = c_j A[i, j] + s_j
        # A[i, perm[j]] with s_p = -s, s_q = +s
        s = DD(jnp.where(is_p, -s_all.hi, s_part.hi),
               jnp.where(is_p, -s_all.lo, s_part.lo))

        E = eye_tab[r]  # [m, m] 0/1
        P = hot_tab[r]
        # J[k, j] = c_j E[k, j] + s_j P[k, j]; 0/1 scaling is exact
        J = DD(
            c.hi[:, None, :] * E + s.hi[:, None, :] * P,
            c.lo[:, None, :] * E + s.lo[:, None, :] * P,
        )
        A = dd_matmul(dd_transpose(J), dd_matmul(A, J))
        V = dd_matmul(V, J)
        return A.hi, A.lo, V.hi, V.lo

    def sweep_body(_, carry):
        Ah, Al, Vh, Vl = jax.lax.fori_loop(0, nrounds, round_body, carry)
        # exact-resymmetrization once per sweep: the two-sided update is
        # symmetric to rounding; halving the (i,j)/(j,i) drift keeps the
        # per-index rotation parameters of later rounds consistent
        A = dd_sym(DD(Ah, Al))
        return A.hi, A.lo, Vh, Vl

    Ah, Al, Vh, Vl = jax.lax.fori_loop(
        0, sweeps, sweep_body, (M.hi, M.lo, V0.hi, V0.lo)
    )

    lam = DD(
        jnp.diagonal(Ah, axis1=-2, axis2=-1),
        jnp.diagonal(Al, axis1=-2, axis2=-1),
    )
    order = jnp.argsort(lam.hi, axis=-1)
    lam = DD(
        jnp.take_along_axis(lam.hi, order, axis=-1),
        jnp.take_along_axis(lam.lo, order, axis=-1),
    )
    V = DD(
        jnp.take_along_axis(Vh, order[:, None, :], axis=-1),
        jnp.take_along_axis(Vl, order[:, None, :], axis=-1),
    )
    return lam, V


def dd_eigh_jacobi(
    M: DD,
    sweeps: Optional[int] = None,
    V0: Optional[jax.Array] = None,
) -> Tuple[DD, DD]:
    """Eigendecomposition of a batch of symmetric dd matrices [nb, m, m]:
    M = V diag(lam) V^T with eigenvalues ascending, everything in dd.

    ``V0``: optional f64 eigenbasis warm start (e.g. from the f64 Jacobi on
    M.hi). The matrix is pre-rotated B = V0^T M V0 in dd — B is then
    diagonal up to the f64 basis error (~u64 * ||M|| off-diagonal mass) and
    the dd sweeps only have to clean that up, roughly halving the sweep
    count. Warm-started default is 6 sweeps; cold default matches the f64
    solver's schedule + 2.
    """
    nb, m, _ = M.hi.shape
    from .eigh import round_robin_pairs, _default_sweeps

    if sweeps is None:
        sweeps = 6 if V0 is not None else _default_sweeps(m) + 2

    if V0 is not None:
        V0h = V0.astype(M.hi.dtype)
        zero = jnp.zeros_like(V0h)
        Vdd = DD(V0h, zero)
        # one dd Newton-Schulz pass: V0 is only f64-orthogonal, and the
        # congruence V0^T M V0 perturbs every eigenvalue RELATIVELY by the
        # orthogonality defect (Ostrowski) — u64-class, i.e. the warm start
        # would cap eigenvalue accuracy at plain-f64 level (measured
        # 3.9e-16 absolute on a ||M|| ~ 1 test). One quadratic NS step in
        # dd drops the defect to ~u64^2, below dd resolution.
        VtV = dd_matmul(dd_transpose(Vdd), Vdd)
        # C = 1.5 I - 0.5 V'V in dd (the diagonal cancellation 1.5 - 0.5 *
        # (1 + d) must be error-free or it re-injects u64 defect)
        eye15 = 1.5 * jnp.broadcast_to(jnp.eye(m, dtype=M.hi.dtype), VtV.hi.shape)
        C = dd_add(DD(eye15, 0.0 * eye15),
                   DD(-0.5 * VtV.hi, -0.5 * VtV.lo))
        Vdd = dd_matmul(Vdd, C)
        B = dd_sym(dd_matmul(dd_transpose(Vdd), dd_matmul(M, Vdd)))
        Vstart = Vdd
    else:
        eye = jnp.broadcast_to(jnp.eye(m, dtype=M.hi.dtype), M.hi.shape)
        B = M
        Vstart = DD(eye, jnp.zeros_like(eye))

    if m % 2 != 0:
        big = jnp.max(jnp.sum(jnp.abs(B.hi), axis=-1)) + 1.0
        Bp = DD(
            jnp.zeros((nb, m + 1, m + 1), dtype=M.hi.dtype),
            jnp.zeros((nb, m + 1, m + 1), dtype=M.hi.dtype),
        )
        Bp = DD(
            Bp.hi.at[:, :m, :m].set(B.hi).at[:, m, m].set(big),
            Bp.lo.at[:, :m, :m].set(B.lo),
        )
        Vp = DD(
            jnp.zeros((nb, m + 1, m + 1), dtype=M.hi.dtype)
            .at[:, :m, :m].set(Vstart.hi).at[:, m, m].set(1.0),
            jnp.zeros((nb, m + 1, m + 1), dtype=M.hi.dtype)
            .at[:, :m, :m].set(Vstart.lo),
        )
        perm, eye_t, hot_t = _perm_table(round_robin_pairs(m + 1), m + 1)
        lam, V = _dd_jacobi_impl(
            Bp, Vp, jnp.asarray(perm), jnp.asarray(eye_t), jnp.asarray(hot_t),
            sweeps,
        )
        return (
            DD(lam.hi[:, :m], lam.lo[:, :m]),
            DD(V.hi[:, :m, :m], V.lo[:, :m, :m]),
        )
    perm, eye_t, hot_t = _perm_table(round_robin_pairs(m), m)
    return _dd_jacobi_impl(
        B, Vstart, jnp.asarray(perm), jnp.asarray(eye_t), jnp.asarray(hot_t),
        sweeps,
    )
