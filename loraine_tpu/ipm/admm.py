"""ADMM (boundary-point) SDP solver.

Implementation of the alternating-direction augmented-Lagrangian
method of Wen, Goldfarb, Yin (Math. Prog. Comp. 2010), the reference's
unshipped extra (`TBD/admm_sdp.jl:6-316`): same update scheme (y linear
solve against a fixed A A^T Cholesky factor, S by eigenvalue projection onto
the PSD cone, relaxed multiplier update for X, adaptive penalty mu) on this
framework's batched block groups. The iteration runs in chunks of jitted
``lax.while_loop`` steps (hundreds of cheap iterations per device call);
the PSD projection is one batched eigendecomposition per block group.

Solves the same problem as the IPM:  max b'y  s.t.  sum_j y_j A_j <= C,
C_lin' y <= d_lin. Useful when a moderate-accuracy solution is enough or as
a warm-start generator for the IPM.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Options
from ..ops.eigh import eigh_backend_for, eigh_jacobi
from ..ops.linalg import chol_reg, cho_solve, sym
from ..ops.schur import Aadj, Aop, schur_group, schur_lp
from ..problem import SDPProblem
from .solver import STATUS_NAMES

__all__ = ["solve_admm", "ADMMResult"]

# reference parameter block (`TBD/admm_sdp.jl:31-42`)
_MU0 = 10.01
_RHO = (1.0 + np.sqrt(5.0)) / 2.0 - 0.5
_GAMMA = 0.5
_MU_MIN, _MU_MAX = 1e-4, 1e4
_ETA1, _ETA2 = 10000.0, 100.0
_H4 = 100


@dataclasses.dataclass
class ADMMResult:
    status: int
    status_name: str
    objective: float  # -b'y + b_const (same reporting as the IPM)
    y: np.ndarray
    X: List[np.ndarray]
    S: List[np.ndarray]
    X_lin: Optional[np.ndarray]
    iterations: int
    err: float
    solve_time: float


def _proj_psd(V: jax.Array, backend: str) -> jax.Array:
    if eigh_backend_for(backend, V.shape[-1]) == "jacobi":
        lam, Q = eigh_jacobi(V)
    else:
        lam, Q = jnp.linalg.eigh(V)
    lam = jnp.maximum(lam, 0.0)
    return sym((Q * lam[:, None, :]) @ jnp.swapaxes(Q, -1, -2))


def solve_admm(
    problem: SDPProblem,
    eps: float = 1e-5,
    maxiter: int = 20000,
    verb: int = 1,
    chunk: int = 100,
    eigh_backend: str = "auto",
) -> ADMMResult:
    eigh_backend = Options(eigh_backend=eigh_backend).validated().eigh_backend
    dtype = problem.b.dtype
    n = problem.n
    nlin = problem.nlin
    # empirically pinned sign convention (see tests): the reference's update
    # scheme with b as-is and y = -AAT^{-1} rhs converges to the same y as
    # the IPM (objective reported as -b'y + b_const, no final flip needed)
    b = problem.b

    # fixed normal matrix A A^T = sum <A_j, A_k> (+ C_lin C_lin'):
    # exactly the Schur assembly with W = G = I
    eyeW = [
        jnp.broadcast_to(jnp.eye(g.m, dtype=dtype), (g.nb, g.m, g.m))
        for g in problem.groups
    ]
    AAT = jnp.zeros((n, n), dtype=dtype)
    for g, I_ in zip(problem.groups, eyeW):
        AAT = AAT + schur_group(g, I_, I_)
    if nlin:
        AAT = AAT + schur_lp(problem.C_lin, jnp.ones((nlin,), dtype=dtype))
    Lchol = chol_reg(sym(AAT), 1e-10, 50).L

    norm_b = jnp.linalg.norm(b)
    normC1 = [jnp.sum(jnp.abs(g.C), axis=(-1, -2)) for g in problem.groups]  # [nb]
    normd1 = jnp.sum(jnp.abs(problem.d_lin)) if nlin else None

    X0 = tuple(
        jnp.broadcast_to(jnp.eye(g.m, dtype=dtype), (g.nb, g.m, g.m))
        for g in problem.groups
    )
    S0 = X0
    Xl0 = jnp.ones((nlin,), dtype=dtype) if nlin else jnp.zeros((0,), dtype=dtype)
    Sl0 = Xl0
    y0 = jnp.ones((n,), dtype=dtype)

    def one_iter(carry):
        y, X, S, Xl, Sl, mu, itp, itd, err, count = carry

        Axb = jnp.zeros((n,), dtype=dtype)
        ASC = jnp.zeros((n,), dtype=dtype)
        for g, Xg, Sg in zip(problem.groups, X, S):
            Axb = Axb + Aop(g, Xg)
            ASC = ASC + Aop(g, Sg - g.C)
        if nlin:
            Axb = Axb + problem.C_lin @ Xl
            ASC = ASC + problem.C_lin @ (Sl - problem.d_lin)

        rhs = mu * (Axb - b) + ASC
        y = -cho_solve(Lchol, rhs)

        newX, newS = [], []
        dinf = jnp.zeros((), dtype=dtype)
        dinfs = jnp.zeros((), dtype=dtype)
        dgap = jnp.zeros((), dtype=dtype)
        dgaps = jnp.zeros((), dtype=dtype)
        for g, Xg, nC1 in zip(problem.groups, X, normC1):
            Vp = g.C - Aadj(g, y)
            V = Vp - mu * Xg
            Sg = _proj_psd(V, eigh_backend)
            Xp = (Sg - V) / mu
            Xg_new = (1.0 - _RHO) * Xg + _RHO * Xp
            newX.append(Xg_new)
            newS.append(Sg)
            di = jnp.sqrt(jnp.sum((Vp - Sg) ** 2, axis=(-1, -2)))  # [nb]
            dinf = dinf + jnp.sum(di)
            dinfs = dinfs + jnp.sum(di / (1.0 + nC1))
            dg = jnp.einsum("bpq,bpq->b", g.C, Xg_new)
            dgap = dgap + jnp.sum(dg)
            dgaps = dgaps + jnp.sum(jnp.abs(dg))
        if nlin:
            Vpl = problem.d_lin - problem.C_lin.T @ y
            Vl = Vpl - mu * Xl
            Sl = jnp.maximum(Vl, 0.0)
            Xl = (1.0 - _RHO) * Xl + _RHO * (Sl - Vl) / mu
            di = jnp.linalg.norm(Vpl - Sl)
            dinf = dinf + di
            dinfs = dinfs + di / (1.0 + normd1)
            dg = jnp.dot(problem.d_lin, Xl)
            dgap = dgap + dg
            dgaps = dgaps + jnp.abs(dg)

        pinf = jnp.linalg.norm(Axb - b)
        pinfs = pinf / (1.0 + norm_b)
        by = jnp.dot(b, y)
        dgap_t = jnp.abs(by - dgap)
        dgaps_t = dgap_t / (1.0 + jnp.abs(by) + dgaps)
        err = jnp.maximum(pinfs, jnp.maximum(dinfs, dgaps_t))

        # penalty adaptation (`TBD/admm_sdp.jl:266-282`)
        cond = pinf + dinf > 2.0
        ratio = pinf / jnp.maximum(dinf, 1e-300)
        primal_slow = jnp.logical_and(cond, ratio < _ETA1)
        dual_slow = jnp.logical_and(cond, ratio > _ETA2)
        itp = jnp.where(primal_slow, itp + 1, jnp.where(dual_slow, 0, itp))
        itd = jnp.where(dual_slow, itd + 1, jnp.where(primal_slow, 0, itd))
        shrink = itp > _H4
        grow = itd > _H4
        mu = jnp.where(shrink, jnp.maximum(_GAMMA * mu, _MU_MIN), mu)
        mu = jnp.where(grow, jnp.minimum(mu / _GAMMA, _MU_MAX), mu)
        itp = jnp.where(shrink, 0, itp)
        itd = jnp.where(grow, 0, itd)

        return (y, tuple(newX), tuple(newS), Xl, Sl, mu, itp, itd, err, count + 1)

    @jax.jit
    def run_chunk(carry):
        def cond(c):
            return jnp.logical_and(c[-2] > eps, c[-1] < carry[-1] + chunk)

        return jax.lax.while_loop(cond, one_iter, carry)

    carry = (
        y0, X0, S0, Xl0, Sl0,
        jnp.asarray(_MU0, dtype=dtype),
        jnp.int32(0), jnp.int32(0),
        jnp.asarray(1.0, dtype=dtype), jnp.int32(0),
    )
    t0 = time.time()
    if verb > 0:
        print(" *** ADMM (boundary point) STARTS")
        print("  iter      error          mu       objective")
    while True:
        carry = run_chunk(carry)
        err = float(carry[-2])
        count = int(carry[-1])
        if verb > 0:
            obj = -float(jnp.dot(b, carry[0])) + problem.b_const
            print(f"{count:6d}   {err:.3e}   {float(carry[5]):9.4f}   {obj:.8f}")
        if err <= eps or count >= maxiter or not np.isfinite(err):
            break
    solve_time = time.time() - t0

    y, X, S, Xl, Sl = carry[0], carry[1], carry[2], carry[3], carry[4]
    status = 1 if err <= eps else 4
    Xb: List[Optional[np.ndarray]] = [None] * problem.nlmi
    Sb: List[Optional[np.ndarray]] = [None] * problem.nlmi
    for g, Xg, Sg in zip(problem.groups, X, S):
        Xh, Sh = np.asarray(jax.device_get(Xg)), np.asarray(jax.device_get(Sg))
        for bpos, (oidx, osize) in enumerate(zip(g.orig_indices, g.orig_sizes)):
            Xb[oidx] = Xh[bpos, :osize, :osize]
            Sb[oidx] = Sh[bpos, :osize, :osize]
    yh = np.asarray(jax.device_get(y))
    by = float(np.dot(np.asarray(jax.device_get(b)), yh))
    return ADMMResult(
        status=status,
        status_name=STATUS_NAMES.get(status, "UNKNOWN"),
        objective=-by + problem.b_const,
        y=yh,
        X=Xb,
        S=Sb,
        X_lin=None if nlin == 0 else np.asarray(jax.device_get(Xl)),
        iterations=int(carry[-1]),
        err=err,
        solve_time=solve_time,
    )
