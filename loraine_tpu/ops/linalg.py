"""Small batched linear-algebra building blocks.

All ops are jit-safe (static shapes, bounded control flow) and batched over a
leading block axis where relevant. Regularized Cholesky reproduces the
reference's retry loops (`src/prepare_W.jl:5-26` for X/S with 1e-5 shifts;
`src/predictor_corrector.jl:55-97` for the Schur matrix with 1e-4 shifts) as
bounded ``lax.while_loop``s keyed on NaN detection: JAX's Cholesky (LAPACK
potrf on the CPU, cuSOLVER potrf on GPUs) returns an all-NaN factor for a
batch element whose factorization reports failure, rather than raising,
which is exactly the signal we need.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "sym",
    "chol_blocked",
    "chol_reg",
    "cho_solve",
    "tri_solve",
    "tri_inv",
    "cho_solve_inv",
    "eigmin",
    "eigmin_chol",
    "btrace",
]


def sym(M: jax.Array) -> jax.Array:
    """Symmetrize on the last two axes (the reference's `mat`,
    `src/kron_etc.jl:13-18`)."""
    return (M + jnp.swapaxes(M, -1, -2)) / 2


def chol_blocked(M: jax.Array, base: int = 128, shard=None) -> jax.Array:
    """Batched lower Cholesky via right-looking blocked elimination.

    Why: the factorization's sequential panel recursion is latency-bound,
    while GEMMs run at the device's full rate. This version keeps the
    sequential part at `base` size and casts all O(n^3) work as f64 GEMMs /
    multi-RHS triangular solves; the same panel loop is also the
    distributed factorization (``shard`` below):

        for each panel k:   D = T[:b,:b],  R = T[b:,:b]
            L_kk = chol(D)
            L_rk = R L_kk^{-T}            (one multi-RHS triangular solve)
            T    = T[b:,b:] - L_rk L_rk^T (GEMM, the flop bulk)

    NaN semantics match `jnp.linalg.cholesky`: an indefinite leading block
    yields NaNs that propagate through every later panel, so `chol_reg`'s
    NaN-keyed retry loop works unchanged. Backward error is the classical
    blocked-Cholesky bound (same order as the unblocked factorization).

    ``shard``: optional callable applying a row-sharding constraint to
    matrices whose axis -2 spans (a suffix of) the factored dimension.
    With it, the SAME panel loop is the distributed factorization: the
    b x b panel chol replicates (tiny), the multi-RHS solve and the
    rank-b trailing update run shard-local on each device's rows, and
    GSPMD inserts one [*, b] panel broadcast per step — H is never
    gathered whole (the replicated-Cholesky fallback this replaces,
    SURVEY section 7 "Distributed Cholesky vs CG").
    """
    n = M.shape[-1]
    if n <= base:
        return jnp.linalg.cholesky(M)
    if shard is None:
        shard = lambda x: x
    batch = M.shape[:-2]
    cols = []
    T = shard(M)
    k = 0
    while k < n:
        b = min(base, n - k)
        D = T[..., :b, :b]
        Ld = jnp.linalg.cholesky(D)
        if k + b < n:
            R = T[..., b:, :b]
            Lr_t = jax.scipy.linalg.solve_triangular(
                Ld, jnp.swapaxes(R, -1, -2), lower=True
            )  # [..., b, n-k-b] = L_rk^T
            Lr = jnp.swapaxes(Lr_t, -1, -2)
            col = jnp.concatenate([Ld, Lr], axis=-2)  # [..., n-k, b]
            T = shard(T[..., b:, b:] - Lr @ Lr_t)
        else:
            col = Ld
        if k:
            col = jnp.concatenate(
                [jnp.zeros(batch + (k, b), dtype=M.dtype), col], axis=-2
            )
        cols.append(shard(col))
        k += b
    return shard(jnp.concatenate(cols, axis=-1))


class CholResult(NamedTuple):
    L: jax.Array  # lower factor(s), NaN-free iff ok
    shifts: jax.Array  # int32, number of eps*I shifts applied (per batch elem)
    ok: jax.Array  # bool scalar: all factorizations succeeded


def chol_reg(
    M: jax.Array, eps, max_tries: int = 1000, backend: str = "f64",
    shard=None,
) -> CholResult:
    """Cholesky with bounded diagonal-shift regularization.

    Failing batch elements get ``eps * I`` added repeatedly (up to
    ``max_tries``) until positive definite. Matches the reference semantics
    of `try_cholesky` / the Schur regularization loop, vectorized over the
    batch so only failing blocks are shifted. ``eps`` may be a Python float
    or a traced scalar (used for the relative H shift in the IPM step).

    ``backend``: 'f64' (blocked f64 factorization) or 'mixed' (f32 panels
    + f64 Newton refinement, ops/mixed_chol.py; options resolve 'auto' in
    config.py). The mixed path falls back to f64 per panel on
    ill-conditioning, so NaN/shift semantics are identical.
    """
    m = M.shape[-1]
    eye = jnp.eye(m, dtype=M.dtype)
    if shard is not None:
        # distributed factorization (Schur rows sharded): the blocked f64
        # elimination with per-panel sharding constraints; the mixed-panel
        # variant is not plumbed for sharding (its panels are replicated
        # anyway, so the f64 path is the conservative choice here)
        _chol = lambda Mc: chol_blocked(Mc, shard=shard)
    elif backend == "mixed":
        from .mixed_chol import chol_mixed_blocked as _chol
    elif backend == "f64":
        _chol = chol_blocked
    else:
        raise ValueError(f"chol_reg backend must be 'f64' or 'mixed', got {backend!r}")

    def attempt(Mc):
        L = _chol(Mc)
        bad = jnp.isnan(L).any(axis=(-1, -2))
        return L, bad

    L0, bad0 = attempt(M)

    def cond(carry):
        _, _, bad, i = carry
        return jnp.logical_and(bad.any(), i < max_tries)

    def body(carry):
        Mc, L, bad, i = carry
        Mc = Mc + eps * eye * bad[..., None, None].astype(M.dtype)
        L, bad = attempt(Mc)
        return Mc, L, bad, i + 1

    _, L, bad, shifts = lax.while_loop(cond, body, (M, L0, bad0, jnp.int32(0)))
    return CholResult(L=L, shifts=shifts, ok=jnp.logical_not(bad.any()))


def tri_solve(L: jax.Array, B: jax.Array, *, trans: bool = False) -> jax.Array:
    """Solve L X = B (or L^T X = B) with lower-triangular L; batched."""
    return jax.scipy.linalg.solve_triangular(L, B, lower=True, trans=1 if trans else 0)


def cho_solve(L: jax.Array, b: jax.Array) -> jax.Array:
    """Solve (L L^T) x = b given the lower Cholesky factor; batched."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    x = tri_solve(L, b)
    x = tri_solve(L, x, trans=True)
    return x[..., 0] if vec else x


def tri_inv(L: jax.Array, base: int = 128, shard=None) -> jax.Array:
    """Explicit inverse of a lower-triangular matrix by blocked doubling.

    Why: a triangular solve with a single RHS is a sequential blocked
    algorithm, and the IPM's direct path does FOUR of them per iteration
    against the same factor (predictor + corrector, each with one
    iterative-refinement pass). Inverting L once turns every solve into two
    GEMVs. The inversion
    itself is one batched multi-RHS triangular solve on the diagonal blocks
    plus log2(n/base) levels of batched GEMMs:

        inv([[A, 0], [B, C]]) = [[inv(A), 0], [-inv(C) B inv(A), inv(C)]]

    Numerics: ||I - Li L|| ~ u * cond(L); downstream users run iterative
    refinement on the solve (step.py solve2), which absorbs exactly this
    class of error — same contract as the triangular-solve path.

    ``shard``: optional row-sharding constraint callable (see chol_blocked).
    The doubling GEMMs then run distributed; GSPMD moves at most one
    half-size block per level (bounded transient, vs gathering L whole).
    """
    n = L.shape[-1]
    if n <= base:
        eye = jnp.broadcast_to(jnp.eye(n, dtype=L.dtype), L.shape)
        return jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    if shard is None:
        shard = lambda x: x

    # pad to base * 2^k with an identity tail (inverse of the pad is itself)
    k = 0
    np_ = base
    while np_ < n:
        np_ *= 2
        k += 1
    batch = L.shape[:-2]
    if np_ != n:
        pad = np_ - n
        eye_tail = jnp.eye(pad, dtype=L.dtype)
        Lp = jnp.zeros(batch + (np_, np_), dtype=L.dtype)
        Lp = Lp.at[..., :n, :n].set(L).at[..., n:, n:].set(eye_tail)
    else:
        Lp = L

    # invert all diagonal base blocks in ONE batched triangular solve
    nblk = np_ // base
    blocks = Lp.reshape(batch + (nblk, base, nblk, base))
    idx = jnp.arange(nblk)
    diag = jnp.moveaxis(blocks, -2, -3)[..., idx, idx, :, :]  # [..., nblk, b, b]
    eye_b = jnp.broadcast_to(jnp.eye(base, dtype=L.dtype), diag.shape)
    dinv = jax.scipy.linalg.solve_triangular(diag, eye_b, lower=True)

    # scatter inverted diagonal blocks into the working matrix; off-diagonal
    # blocks of the INVERSE are built up by doubling
    Li = jnp.zeros_like(Lp)
    for i in range(nblk):  # static unroll, nblk is small (<= 16 typical)
        s = slice(i * base, (i + 1) * base)
        Li = Li.at[..., s, s].set(dinv[..., i, :, :])

    Lp = shard(Lp)
    Li = shard(Li)
    size = base
    while size < np_:
        for i in range(0, np_, 2 * size):  # static unroll
            a = slice(i, i + size)
            c = slice(i + size, i + 2 * size)
            # -inv(C) @ B @ inv(A)
            BA = Lp[..., c, a] @ Li[..., a, a]
            Li = Li.at[..., c, a].set(-(Li[..., c, c] @ BA))
        Li = shard(Li)
        size *= 2

    return shard(Li[..., :n, :n])


def cho_solve_inv(Li: jax.Array, b: jax.Array) -> jax.Array:
    """Solve (L L^T) x = b given Li = inv(L): two GEMVs/GEMMs."""
    y = jnp.einsum("...ij,...j->...i", Li, b) if b.ndim == Li.ndim - 1 else Li @ b
    if b.ndim == Li.ndim - 1:
        return jnp.einsum("...ji,...j->...i", Li, y)
    return jnp.swapaxes(Li, -1, -2) @ y


def eigmin(M: jax.Array) -> jax.Array:
    """Smallest eigenvalue(s) of symmetric M; batched over leading axes."""
    return jnp.linalg.eigvalsh(M)[..., 0]


def eigmin_chol(M: jax.Array, iters: int = 45) -> jax.Array:
    """Guaranteed lower bound on the smallest eigenvalue via Cholesky
    bisection: chol(M - t*I) succeeds iff lambda_min > t. Returns the
    bracket's lower end, so steplengths derived from it are always safe
    (never longer than the exact ones).

    Rationale: needs no eigensolver at all — ~45 batched Cholesky
    factorizations instead. Precision after k steps: ||M||_inf * 2^-k.
    """
    m = M.shape[-1]
    eye = jnp.eye(m, dtype=M.dtype)
    B = jnp.max(jnp.sum(jnp.abs(M), axis=-1), axis=-1)  # Gershgorin outer radius
    lo = -B
    hi = B

    def body(_, carry):
        lo, hi = carry
        mid = (lo + hi) / 2.0
        L = jnp.linalg.cholesky(M - mid[..., None, None] * eye)
        ok = jnp.logical_not(jnp.isnan(L).any(axis=(-1, -2)))  # PD: lambda_min > mid
        lo = jnp.where(ok, mid, lo)
        hi = jnp.where(ok, hi, mid)
        return lo, hi

    lo, hi = lax.fori_loop(0, iters, body, (lo, hi))
    return lo


def btrace(X, S) -> jax.Array:
    """sum_b <X_b, S_b> over the leading batch axis (`src/kron_etc.jl:21-28`)."""
    return jnp.sum(X * S)
