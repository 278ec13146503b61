"""Low-rank preconditioners H_alpha / H_beta for the iterative (CG) path.

Math (reference `docs/src/low-rank_solutions.md`, code `src/Solvers.jl:
616-904`): with the NT scaling point split W = W_0 + U U^T (U spanning the
top-``erank`` eigenspace), the Schur operator is approximated by

    H_alpha = AAAATtau + V V^T,     V = A^T (U (x) Z),  Z Z^T = 2 W_0 + U U^T
    H_beta  = AAAATtau              (diagonal part only)

where AAAATtau = (sum_i ttau_i^2) I + C_lin diag(x_lin/s_lin) C_lin^T and
ttau_i is a scalar surrogate for the tail spectrum of W_i (selected by
``aamat``). H_alpha^{-1} is applied with Sherman-Morrison-Woodbury through
the small Schur matrix S = V^T AAAATtau^{-1} V (+ I).

Implementation notes: the per-block eigendecompositions are one
batched ``eigh`` per block group; 2 W_0 + U U^T shares W's eigenbasis
(eigenvalues [2 lam_tail, lam_top + ttau]) so Z is a Cholesky of a
reconstructed congruence, and all SMW pieces are batched GEMMs. For rank-one
data the V-matrix columns factor as sgn * (U^T b)(Z^T b) without touching a
dense A (the reference's `prec_alpha_S!` fast formula, `src/Solvers.jl:
819-864`, falls out as a pair of GEMMs).
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..problem import SDPProblem
from .eigh import eigh_by_backend as _eigh
from .linalg import chol_reg, cho_solve, sym, tri_inv
from .nt_scaling import NTScaling
from .schur import Aadj, Aop


__all__ = [
    "BetaPrecond", "AlphaPrecond", "AlphaPrecondDense", "prep_beta",
    "prep_alpha",
]


def _ttau(lam_s: jax.Array, aamat: int) -> jax.Array:
    """Tail-spectrum surrogate per block: min or (min+mean)/2 of the tail
    eigenvalues (`src/Solvers.jl:646-650,715-719`). lam_s: [nb, m-k]
    ascending."""
    lam_min = lam_s[:, 0]
    if aamat == 0:
        return lam_min
    return (lam_min + jnp.mean(lam_s, axis=1)) / 2.0 - 1.0e-14


class BetaPrecond(NamedTuple):
    diag: jax.Array  # [n]

    def apply(self, x: jax.Array) -> jax.Array:
        return x / self.diag


def prep_beta(
    problem: SDPProblem,
    nts: Tuple[NTScaling, ...],
    lpw: Optional[jax.Array],
    erank: int,
    aamat: int,
    eigh_backend: str = "jacobi",
) -> BetaPrecond:
    dtype = problem.b.dtype
    s = jnp.zeros((), dtype=dtype)
    for g, nt in zip(problem.groups, nts):
        k = min(erank, g.m - 1)
        lam, _ = _eigh(nt.W, eigh_backend)  # [nb, m] ascending
        tt = _ttau(lam[:, : g.m - k], aamat)
        s = s + jnp.sum(tt**2)
    diag = jnp.full((problem.n,), 1.0, dtype=dtype) * s
    if problem.nlin > 0:
        diag = diag + jnp.einsum("jl,l->j", problem.C_lin**2, lpw)
    return BetaPrecond(diag=diag)


class AlphaPrecond(NamedTuple):
    U: Tuple[jax.Array, ...]  # per group [nb, m, k]
    Z: Tuple[jax.Array, ...]  # per group [nb, m, m] lower Cholesky of 2W0+UU^T
    cholS: jax.Array  # [sizeS, sizeS] lower factor of SMW Schur + I
    diag_scalar: jax.Array  # sum_i ttau_i^2
    lp_chol: Optional[jax.Array]  # chol of dense AAAATtau when nlin > 0
    groups_meta: Tuple[Tuple[int, int, int], ...]  # (nb, k, m) per group

    def _solve_tau(self, x: jax.Array) -> jax.Array:
        if self.lp_chol is not None:
            return cho_solve(self.lp_chol, x)
        return x / self.diag_scalar

    def apply_with(self, problem: SDPProblem, x: jax.Array) -> jax.Array:
        """SMW apply: AAAATtau^{-1} x minus the low-rank correction
        (`src/Solvers.jl:866-904`)."""
        v = self._solve_tau(x)
        segs: List[jax.Array] = []
        for g, U, Z in zip(problem.groups, self.U, self.Z):
            M22 = Aadj(g, v)  # [nb, m, m], symmetric
            y33 = jnp.einsum("bpq,bpr,brl->blq", Z, M22, U)  # (Z^T M U)[q,l] at [b,l,q]
            segs.append(y33.reshape(-1))
        y = jnp.concatenate(segs) if segs else jnp.zeros((0,), x.dtype)
        y = cho_solve(self.cholS, y)
        yy2 = jnp.zeros_like(x)
        off = 0
        for g, U, Z, (nb, k, m) in zip(problem.groups, self.U, self.Z, self.groups_meta):
            seg = y[off : off + nb * k * m].reshape(nb, k, m)
            off += nb * k * m
            Mrec = jnp.einsum("bpq,blq,brl->bpr", Z, seg, U)  # Z Y U^T
            yy2 = yy2 + Aop(g, sym(Mrec))
        return v - self._solve_tau(yy2)


class AlphaPrecondDense(NamedTuple):
    """H_alpha materialized as an n x n matrix: M = AAAATtau + t t^T with the
    same t = A^T (U (x) Z) columns the SMW route builds. The apply is two
    GEMVs against the inverse Cholesky factor — on latency-bound small-n
    problems this replaces the SMW pipeline's ~10 per-block kernels per CG
    iteration with 2. Identical operator to `AlphaPrecond` up to rounding."""

    Mli: jax.Array  # inv(L) for M = L L^T

    def apply(self, x: jax.Array) -> jax.Array:
        return self.Mli.T @ (self.Mli @ x)


def prep_alpha(
    problem: SDPProblem,
    nts: Tuple[NTScaling, ...],
    lpw: Optional[jax.Array],
    erank: int,
    aamat: int,
    eigh_backend: str = "jacobi",
    materialize: bool = False,
) -> AlphaPrecond:
    dtype = problem.b.dtype
    Us: List[jax.Array] = []
    Zs: List[jax.Array] = []
    meta: List[Tuple[int, int, int]] = []
    s = jnp.zeros((), dtype=dtype)

    for g, nt in zip(problem.groups, nts):
        m = g.m
        k = min(erank, m - 1)
        lam, V = _eigh(nt.W, eigh_backend)  # ascending
        lam_s, lam_l = lam[:, : m - k], lam[:, m - k :]
        V_l = V[:, :, m - k :]
        tt = _ttau(lam_s, aamat)  # [nb]
        U = V_l * jnp.sqrt(jnp.maximum(lam_l - tt[:, None], 0.0))[:, None, :]
        # 2 W_0 + U U^T = V diag([2 lam_s, lam_l + ttau]) V^T
        dz = jnp.concatenate([2.0 * lam_s, lam_l + tt[:, None]], axis=1)
        Mz = (V * dz[:, None, :]) @ jnp.swapaxes(V, -1, -2)
        Z = chol_reg(sym(Mz), 1e-10, 50).L
        Us.append(U)
        Zs.append(Z)
        meta.append((g.nb, k, m))
        s = s + jnp.sum(tt**2)

    lp_chol = None
    if problem.nlin > 0:
        Ad = s * jnp.eye(problem.n, dtype=dtype) + (problem.C_lin * lpw[None, :]) @ problem.C_lin.T
        lp_chol = chol_reg(Ad, 1e-10, 50).L

    def solve_tau_mat(T):
        if lp_chol is not None:
            return cho_solve(lp_chol, T)
        return T / s

    # V = A^T (U (x) Z) as t[j, (b, l, q)] = (Z_b^T A_j^{(b)} U_b)[q, l]
    tcols: List[jax.Array] = []
    for g, U, Z in zip(problem.groups, Us, Zs):
        if g.is_rank1:
            ZB = jnp.einsum("bpq,bjp->bjq", Z, g.B)  # Z^T b_j
            UB = jnp.einsum("bpl,bjp->bjl", U, g.B)  # U^T b_j
            t_g = jnp.einsum("bj,bjl,bjq->jblq", g.Bsgn, UB, ZB)
        elif g.is_sparse:
            # (Z^T A_j U)[q,l] = sum_t v_t Z[r_t, q] U[c_t, l]
            Zr = jax.vmap(lambda Zb, idx: Zb[idx])(Z, g.Arows)  # [nb, n, s, m]
            Uc = jax.vmap(lambda Ub, idx: Ub[idx])(U, g.Acols)  # [nb, n, s, k]
            t_g = jnp.einsum("bjt,bjtq,bjtl->jblq", g.Avals, Zr, Uc)
        else:
            AU = jnp.einsum("bjpr,brl->bjpl", g.A, U)
            t_g = jnp.einsum("bpq,bjpl->jblq", Z, AU)
        tcols.append(t_g.reshape(problem.n, -1))
    if materialize:
        n = problem.n
        M = s * jnp.eye(n, dtype=dtype)
        if problem.nlin > 0:
            M = M + (problem.C_lin * lpw[None, :]) @ problem.C_lin.T
        if tcols:
            t = jnp.concatenate(tcols, axis=1)  # [n, sizeS]
            M = M + t @ t.T
        cholM = chol_reg(sym(M), 1e-10, 50).L
        return AlphaPrecondDense(Mli=tri_inv(cholM))

    if tcols:
        t = jnp.concatenate(tcols, axis=1)  # [n, sizeS]
        Ssmw = t.T @ solve_tau_mat(t)
        Ssmw = sym(Ssmw) + jnp.eye(Ssmw.shape[0], dtype=dtype)
        cholS = chol_reg(Ssmw, 1e-10, 50).L
    else:
        cholS = jnp.zeros((0, 0), dtype=dtype)

    return AlphaPrecond(
        U=tuple(Us),
        Z=tuple(Zs),
        cholS=cholS,
        diag_scalar=s,
        lp_chol=lp_chol,
        groups_meta=tuple(meta),
    )
