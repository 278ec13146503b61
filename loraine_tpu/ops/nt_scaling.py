"""Nesterov-Todd scaling point, batched over a block group.

Reference math (`src/prepare_W.jl:28-94`): per block,

    L_x = chol(X),  L_s = chol(S)
    U Sigma V^T = svd(L_s^T L_x)
    D   = Sigma                       (so eig(X S) = D^2)
    G   = L_x V D^{-1/2}              (then G^T S G = D,  G G^T = W)
    Gi  = D^{1/2} V^T L_x^{-1}
    W   = G G^T                       (NT scaling point: W S W = X)
    Si  = S^{-1}
    DDsi = diag(G^T S G)^{-1/2}

Default 'eigh' method: a Cholesky is a sequential panel recursion, so it
factors ONLY X — V and D^2 come from eigh(L_x^T S L_x) (the same V
as svd(L_s^T L_x), since L_x^T S L_x = (L_s^T L_x)^T (L_s^T L_x)), S's
positive-definiteness is read off the congruent eigenvalues (lam > 0 <=>
S PD, Sylvester), and S^{-1} = G D^{-1} G^T exactly by the NT identities —
one GEMM instead of chol(S) + two multi-RHS triangular solves. Cholesky
failures on X are handled by the bounded 1e-5*I shift loop (reference
`try_cholesky`); a congruent spectrum below -1e-2 (the reference's maximum
total S shift, 1000 * 1e-5) marks the scaling not-ok, mirroring its give-up.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .eigh import eigh_by_backend as _eigh
from .linalg import chol_reg, tri_solve, sym

__all__ = ["NTScaling", "nt_scale", "lin_scale"]


class NTScaling(NamedTuple):
    D: jax.Array  # [nb, m]
    G: jax.Array  # [nb, m, m]
    Gi: jax.Array  # [nb, m, m]
    W: jax.Array  # [nb, m, m]
    Si: jax.Array  # [nb, m, m]
    DDsi: jax.Array  # [nb, m]
    ok: jax.Array  # bool scalar
    shifted: jax.Array  # bool scalar: Cholesky regularization was applied
    s_indef: jax.Array  # bool scalar: congruent spectrum of S dipped <= 0


def nt_scale(
    X: jax.Array,
    S: jax.Array,
    reg_eps: float = 1e-5,
    max_reg: int = 1000,
    method: str = "eigh",
    eigh_backend: str = "jacobi",
    chol_backend: str = "f64",
) -> NTScaling:
    """Compute the NT scaling for a stacked group of blocks [nb, m, m].

    method:
      'eigh' (default): V and D^2 from eigh(L_x^T S L_x); only X is
        factorized (see module docstring).
      'svd': the reference formulation (`src/prepare_W.jl:37-47`) —
        chol(X) and chol(S), then svd(L_s^T L_x); S^{-1} by triangular
        solves. Kept as the parity path.
    """
    nb, m = X.shape[0], X.shape[-1]

    if method == "svd":
        cboth = chol_reg(
            jnp.concatenate([X, S], axis=0), reg_eps, max_reg,
            backend=chol_backend,
        )
        Lx, Ls = cboth.L[:nb], cboth.L[nb:]
        CC = jnp.swapaxes(Ls, -1, -2) @ Lx  # L_s^T L_x
        _, D, Vt = jnp.linalg.svd(CC)
        V = jnp.swapaxes(Vt, -1, -2)
        ok = cboth.ok
        shifted = cboth.shifts > 0
        s_indef = jnp.zeros((), dtype=bool)

        d_isqrt = 1.0 / jnp.sqrt(D)
        G = (Lx @ V) * d_isqrt[..., None, :]
        Gi = jnp.sqrt(D)[..., :, None] * jnp.swapaxes(
            tri_solve(Lx, V, trans=True), -1, -2
        )
        W = G @ jnp.swapaxes(G, -1, -2)
        eye = jnp.broadcast_to(jnp.eye(m, dtype=X.dtype), X.shape)
        Si = sym(tri_solve(Ls, tri_solve(Ls, eye), trans=True))
    else:
        cx = chol_reg(X, reg_eps, max_reg, backend=chol_backend)
        Lx = cx.L
        # eig(L_x^T S L_x) = V D^2 V^T with the same V as svd(L_s^T L_x)
        M = jnp.swapaxes(Lx, -1, -2) @ S @ Lx
        lam, V = _eigh(sym(M), eigh_backend)
        # Sylvester: S is PD iff every congruent eigenvalue is positive.
        # Below -1e-2 (= the reference's maximum cumulative S shift,
        # 1000 * 1e-5, `src/prepare_W.jl:5-26`) the scaling is declared
        # failed; small negatives are clamped relative to the spectrum top,
        # which acts like the reference's graduated +eps*I shifts.
        lam_max = jnp.maximum(lam[..., -1:], 1e-300)
        s_indef = (lam[..., 0] <= 0.0).any()
        ok = jnp.logical_and(cx.ok, jnp.logical_not((lam[..., 0] < -1e-2).any()))
        shifted = cx.shifts > 0
        lam = jnp.maximum(lam, 1e-14 * lam_max)
        D = jnp.sqrt(lam)

        d_isqrt = 1.0 / jnp.sqrt(D)
        G = (Lx @ V) * d_isqrt[..., None, :]
        # Gi = D^{1/2} V^T Lx^{-1};  (Lx^{-T} V)^T = V^T Lx^{-1}
        Gi = jnp.sqrt(D)[..., :, None] * jnp.swapaxes(
            tri_solve(Lx, V, trans=True), -1, -2
        )
        W = G @ jnp.swapaxes(G, -1, -2)
        # S^{-1} = G D^{-1} G^T (exact NT identity; error tracks the
        # eigenbasis accuracy, same order as the triangular-solve inverse)
        Si = sym((G / D[..., None, :]) @ jnp.swapaxes(G, -1, -2))

    # diag(G^T S G) without forming the full product
    SG = S @ G
    dd = jnp.einsum("...ma,...ma->...a", G, SG)
    DDsi = 1.0 / jnp.sqrt(dd)

    return NTScaling(
        D=D, G=G, Gi=Gi, W=W, Si=Si, DDsi=DDsi, ok=ok,
        shifted=shifted, s_indef=s_indef,
    )


def lin_scale(S_lin: jax.Array) -> jax.Array:
    """Elementwise inverse for the LP cone (`src/prepare_W.jl:85-89`)."""
    return 1.0 / S_lin


class NTTails(NamedTuple):
    """dd low words of the NT quantities (native dd NT scaling, the dd2
    tier's answer to the reference's fully `T`-generic `prepare_W`,
    `src/prepare_W.jl:41-45` at `T = Float64x4`). The hi words live in the
    sibling NTScaling; consumers fold these in as first-order corrections
    (sandwiches, Schur assembly, corrector targets)."""

    D_lo: jax.Array  # [nb, m]
    G_lo: jax.Array  # [nb, m, m]
    W_lo: jax.Array  # [nb, m, m]
    dd_ok: jax.Array  # bool scalar: dd factorizations succeeded everywhere


def nt_scale_dd(
    X: "DD",
    S: "DD",
    reg_eps: float = 1e-5,
    max_reg: int = 1000,
    eigh_backend: str = "jacobi",
    sweeps: int | None = None,
) -> tuple[NTScaling, NTTails]:
    """NT scaling computed natively in double-double from dd-stored
    iterates (the dd2 tier).

    Why: the f64 path forms M = L_x' S L_x with absolute noise u64 * ||M||;
    once mu (the scale of M's small eigenvalues) sinks below that, D and
    the scaling basis are noise — the measured 9.4e-14 dd2 DIMACS wall
    (docs/precision.md "the f64 NT wall"). Here chol(X), the congruence,
    and the Jacobi eigendecomposition all run on (hi, lo) pairs
    (ops/dd_linalg.py), pushing the formation noise to ~2^-106 * ||M|| —
    the congruent spectrum survives down to mu ~ 1e-25 with >= 7 correct
    digits. Reference: `src/prepare_W.jl:28-94` with `T = Float64x4`
    (`src/Solvers.jl:18`).

    Fallback: if the dd Cholesky reports a nonpositive pivot (iterate not
    PD at dd resolution — the same breakdown regime where the f64 path
    regularizes), every output selects the f64 `nt_scale` result with zero
    tails, and ``tails.dd_ok`` is False. jit-safe (jnp.where select)."""
    from .dd import DD
    from .dd_linalg import (
        dd_chol, dd_const, dd_div, dd_eigh_jacobi, dd_matmul, dd_mul,
        dd_sqrt, dd_sym, dd_transpose,
    )

    nb, m = X.hi.shape[0], X.hi.shape[-1]
    dtype = X.hi.dtype

    # f64 baseline: breakdown flags + the fallback values
    base = nt_scale(
        X.hi, S.hi, reg_eps=reg_eps, max_reg=max_reg, method="eigh",
        eigh_backend=eigh_backend,
    )

    Lx, chol_ok = dd_chol(X)
    # M = L_x^T S L_x in dd
    M = dd_sym(dd_matmul(dd_transpose(Lx), dd_matmul(S, Lx)))
    # warm start from the f64 eigenbasis of M.hi (the dd sweeps then only
    # clean up the ~u64 off-diagonal mass)
    _, V0 = _eigh(sym(M.hi), eigh_backend)
    lam, V = dd_eigh_jacobi(M, sweeps=sweeps, V0=V0)

    lam_max = jnp.maximum(lam.hi[..., -1:], 1e-300)
    s_indef = (lam.hi[..., 0] <= 0.0).any()
    dd_ok = jnp.logical_and(chol_ok.all(), jnp.logical_not(s_indef))
    ok = jnp.logical_and(base.ok, jnp.logical_not((lam.hi[..., 0] < -1e-2).any()))
    # dd clamp: 2^-100 relative (vs the f64 path's 1e-14) — keeps sqrt/
    # divides finite in the not-taken branch without distorting live spectra
    clamp = 2.0**-100 * lam_max
    needs = lam.hi < clamp
    lam = DD(jnp.where(needs, clamp, lam.hi), jnp.where(needs, 0.0, lam.lo))

    D = dd_sqrt(lam)
    one = dd_const(1.0, D.hi)
    d_isqrt = dd_div(one, dd_sqrt(D))  # D^{-1/2}

    LxV = dd_matmul(Lx, V)
    G = dd_mul(LxV, DD(d_isqrt.hi[..., None, :], d_isqrt.lo[..., None, :]))
    W = dd_sym(dd_matmul(G, dd_transpose(G)))

    # Gi (f64 consumer only: RNT, scaled directions): D^{1/2} V' Lx^{-1}
    Gi = jnp.sqrt(D.hi)[..., :, None] * jnp.swapaxes(
        tri_solve(Lx.hi, V.hi, trans=True), -1, -2
    )
    # Si = G D^{-1} G^T (exact NT identity), f64 consumers only
    Si = sym((G.hi / D.hi[..., None, :]) @ jnp.swapaxes(G.hi, -1, -2))
    # DDsi = diag(G^T S G)^{-1/2} = D^{-1/2} by the dd-exact identity
    DDsi = d_isqrt.hi

    def pick(dd_val, f64_val):
        return jnp.where(dd_ok, dd_val, f64_val)

    nts = NTScaling(
        D=pick(D.hi, base.D),
        G=pick(G.hi, base.G),
        Gi=pick(Gi, base.Gi),
        W=pick(W.hi, base.W),
        Si=pick(Si, base.Si),
        DDsi=pick(DDsi, base.DDsi),
        ok=jnp.where(dd_ok, ok, base.ok),
        shifted=jnp.where(dd_ok, jnp.zeros((), bool), base.shifted),
        s_indef=jnp.where(dd_ok, jnp.zeros((), bool), base.s_indef),
    )
    zero_m = jnp.zeros_like(base.D)
    zero_mm = jnp.zeros_like(base.W)
    tails = NTTails(
        D_lo=pick(D.lo, zero_m),
        G_lo=pick(G.lo, zero_mm),
        W_lo=pick(W.lo, zero_mm),
        dd_ok=dd_ok,
    )
    return nts, tails
