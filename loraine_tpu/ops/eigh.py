"""Batched symmetric eigendecomposition via parallel cyclic Jacobi, plus
the mixed-precision (f32 seed + f64 refinement) eigensolver and a Lanczos
lower bound on lambda_min.

The IPM needs one eigendecomposition per block group per iteration (NT
scaling, preconditioner prep) and the steplength spectra of the scaled
directions. Which solver runs is the ``eigh_backend`` option, resolved per
platform in config.py (AUTO_BACKENDS); `eigh_backend_for` only maps the
resolved value to a solver for a given block size.

This implementation is a classical one-sided-free *two-sided* Jacobi with a
round-robin parallel ordering: every round applies m/2 independent Givens
rotations, vectorized over pairs and over the batch; a sweep is m-1 rounds.
The program is a pair of nested fori_loops over gathers/rotations/scatters —
it compiles in seconds at any size, with O(m^3) work per sweep. Jacobi is
also the most accurate dense symmetric eigensolver (small relative error even for tiny eigenvalues of graded SPD
matrices), which suits the late-IPM regime where eig(XS) spreads as mu -> 0.

Convergence: quadratic once nearly diagonal; a fixed sweep count (default
chosen per m) reaches f64 machine precision for the sizes used here.
"""
from __future__ import annotations

from functools import lru_cache, partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .linalg import eigmin_chol

__all__ = [
    "eigh_jacobi",
    "eigh_mixed",
    "eigmin_lanczos",
    "round_robin_pairs",
    "eigh_backend_for",
    "eigh_by_backend",
    "EIGH_SOLVERS",
]

EIGH_SOLVERS = ("xla", "jacobi", "mixed")


def eigh_backend_for(backend, m: int) -> str:
    """Concrete eigensolver ('xla', 'jacobi' or 'mixed') for a resolved
    ``eigh_backend`` value at block size ``m``. The value is a solver name
    or a size rule ((max_m, solver), ..., (None, solver)): the first entry
    with m < max_m applies, None matches any m (config.AUTO_BACKENDS)."""
    if isinstance(backend, tuple):
        for max_m, solver in backend:
            if max_m is None or m < max_m:
                return solver
    if backend not in EIGH_SOLVERS:
        raise ValueError(
            f"eigh_backend {backend!r} is not a resolved choice; resolve "
            "'auto' with Options.validated() / config.resolve_backends"
        )
    return backend


def eigh_by_backend(M: jax.Array, backend: str) -> Tuple[jax.Array, jax.Array]:
    """(eigenvalues ascending, eigenvectors) of a batch [nb, m, m] with the
    solver ``backend`` selects for this block size."""
    resolved = eigh_backend_for(backend, M.shape[-1])
    if resolved == "jacobi":
        return eigh_jacobi(M)
    if resolved == "mixed":
        return eigh_mixed(M)
    return jnp.linalg.eigh(M)


@lru_cache(maxsize=None)
def round_robin_pairs(m: int) -> np.ndarray:
    """Static round-robin schedule: pairs[r] lists m/2 disjoint (p, q) pairs
    covering all indices, over m-1 rounds every unordered pair appears once.
    m must be even (odd sizes are padded by the caller).
    Returns int32 [m-1, 2, m/2]."""
    assert m % 2 == 0
    others = list(range(1, m))
    rounds = []
    for _ in range(m - 1):
        lineup = [0] + others
        top = lineup[: m // 2]
        bot = lineup[m // 2 :][::-1]
        rounds.append((top, bot))
        others = others[1:] + others[:1]
    arr = np.array(rounds, dtype=np.int32)  # [m-1, 2, m/2]
    return arr


def _default_sweeps(m: int) -> int:
    # quadratic convergence: ~log2(m) + margin sweeps reach f64 precision
    return int(np.clip(np.ceil(np.log2(max(m, 4))) + 6, 8, 16))


@partial(jax.jit, static_argnames=("sweeps",))
def _eigh_jacobi_impl(M: jax.Array, pairs: jax.Array, sweeps: int):
    nb, m, _ = M.shape
    dtype = M.dtype
    V0 = jnp.broadcast_to(jnp.eye(m, dtype=dtype), (nb, m, m))

    nrounds = pairs.shape[0]

    def round_body(r, carry):
        A, V = carry
        p = pairs[r, 0]
        q = pairs[r, 1]

        app = A[:, p, p]  # [nb, m/2]
        aqq = A[:, q, q]
        apq = A[:, p, q]

        # Givens rotation zeroing A[p,q]: tan via the stable formula.
        # The rotate-or-not decision is made FIRST and the denominator is
        # sanitized, so no inf/NaN is ever produced (an inf in the
        # not-taken branch of where() would still poison gradients and
        # debugging checks).
        eps = jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype)
        active = jnp.abs(apq) > eps * 1e-3 * (jnp.abs(app) + jnp.abs(aqq) + 1.0)
        apq_safe = jnp.where(active, apq, 1.0)
        tau = (aqq - app) / (2.0 * apq_safe)
        sgn = jnp.where(tau >= 0, 1.0, -1.0)
        t = sgn / (jnp.abs(tau) + jnp.sqrt(1.0 + tau * tau))
        t = jnp.where(active, t, 0.0)
        c = 1.0 / jnp.sqrt(1.0 + t * t)
        s = t * c  # [nb, m/2]

        # rows p, q:  A <- J^T A  with J acting on (p, q)
        P = A[:, p, :]
        Q = A[:, q, :]
        cP = c[..., None]
        sP = s[..., None]
        A = A.at[:, p, :].set(cP * P - sP * Q)
        A = A.at[:, q, :].set(sP * P + cP * Q)
        # cols p, q:  A <- A J
        P = A[:, :, p]
        Q = A[:, :, q]
        cC = c[:, None, :]
        sC = s[:, None, :]
        A = A.at[:, :, p].set(cC * P - sC * Q)
        A = A.at[:, :, q].set(sC * P + cC * Q)
        # eigenvector accumulation: V <- V J
        P = V[:, :, p]
        Q = V[:, :, q]
        V = V.at[:, :, p].set(cC * P - sC * Q)
        V = V.at[:, :, q].set(sC * P + cC * Q)
        return A, V

    def sweep_body(_, carry):
        return jax.lax.fori_loop(0, nrounds, round_body, carry)

    A, V = jax.lax.fori_loop(0, sweeps, sweep_body, (M, V0))

    lam = jnp.diagonal(A, axis1=-2, axis2=-1)
    order = jnp.argsort(lam, axis=-1)
    lam = jnp.take_along_axis(lam, order, axis=-1)
    V = jnp.take_along_axis(V, order[:, None, :], axis=-1)
    return lam, V


def eigh_mixed(
    M: jax.Array,
    gap_rel: float = 1e-6,
    refine_iters: int = 2,
) -> Tuple[jax.Array, jax.Array]:
    """Mixed-precision symmetric eigendecomposition: f32 seed
    (jnp.linalg.eigh) + f64 GEMM-only refinement.

    Why: an f32 eigendecomposition is cheaper than an f64 one, and the
    refinement is all GEMMs. The f64 polish is classical first-order
    eigenvector perturbation: with Rayleigh matrix M2 = V^T M V (nearly
    diagonal),

        v_j <- v_j + sum_{i != j} M2[i,j] / (d_j - d_i) * v_i

    applied for all pairs at once (one elementwise divide + one GEMM),
    followed by a Newton-Schulz re-orthonormalization. Pairs closer than
    ``gap_rel * ||M||`` are skipped: within such clusters any orthonormal
    basis of the (f32-accurate) invariant subspace is a valid eigenbasis,
    and the residual coupling is O(cluster width), i.e. already at the
    eigenvalue's own scale. Two refinement rounds push eigenvector error
    from ~1e-7 (f32) to ~1e-13; eigenvalues come from f64 Rayleigh
    quotients, matching full-f64 eigh's ~eps*||M|| absolute accuracy.
    """
    nb, m, _ = M.shape
    dtype = M.dtype
    eye = jnp.eye(m, dtype=dtype)

    # Shift by the diagonal mean BEFORE casting: IPM scaling matrices have
    # tightly clustered spectra (eig(XS) -> mu near the central path), and
    # f32 resolves the residual's spread to 1e-7 * ||Delta|| instead of
    # 1e-7 * ||M|| — orders of magnitude better eigenvector seeds.
    c = jnp.mean(jnp.diagonal(M, axis1=-2, axis2=-1), axis=-1)  # [nb]
    D_ = M - c[:, None, None] * eye
    scale = jnp.max(jnp.sum(jnp.abs(D_), axis=-1), axis=-1)  # >= ||Delta||_2
    scale = jnp.maximum(scale, 1e-300)

    _, V32 = jnp.linalg.eigh(D_.astype(jnp.float32))
    V = V32.astype(dtype)
    M = D_  # refine against the shifted matrix; shift restored at the end

    def orth(V):
        # two Newton-Schulz steps: the correction V(I+C) with antisymmetric
        # C deviates from orthogonality by ||C||^2 (can be ~1e-2 for
        # near-guard pairs); two quadratic steps bring that to ~1e-8 -> 1e-16
        for _ in range(2):
            VtV = jnp.swapaxes(V, -1, -2) @ V
            V = V @ (1.5 * eye - 0.5 * VtV)
        return V

    V = orth(V)
    for _ in range(refine_iters):
        MV = M @ V
        M2 = jnp.swapaxes(V, -1, -2) @ MV
        d = jnp.diagonal(M2, axis1=-2, axis2=-1)  # [nb, m]
        E = M2 - d[:, None, :] * eye
        den = d[:, None, :] - d[:, :, None]  # den[i, j] = d_j - d_i
        ok = jnp.abs(den) > gap_rel * scale[:, None, None]
        C = jnp.where(ok, E / jnp.where(ok, den, 1.0), 0.0)
        # trust region: perturbation theory is only valid for small C; a
        # clamp keeps occasional guard-boundary pairs from exploding
        C = jnp.clip(C, -0.3, 0.3)
        V = orth(V + V @ C)

    MV = M @ V
    lam = c[:, None] + jnp.einsum("bmj,bmj->bj", V, MV)
    order = jnp.argsort(lam, axis=-1)
    lam = jnp.take_along_axis(lam, order, axis=-1)
    V = jnp.take_along_axis(V, order[:, None, :], axis=-1)
    return lam, V


def eigmin_lanczos(M: jax.Array, iters: int = 48) -> jax.Array:
    """Certified LOWER bound on the smallest eigenvalue of each symmetric
    matrix in a batch [nb, m, m], via Lanczos with full reorthogonalization.

    Why: the IPM steplength (`find_step`, reference
    `src/predictor_corrector.jl:274-291`) needs only lambda_min of the
    scaled directions, not eigenvectors; a full (even mixed-precision)
    eigendecomposition per predictor/corrector phase is the dominant
    per-iteration cost at large m. Lanczos needs ``iters`` matvecs
    (O(iters * m^2) flops — negligible next to an O(m^3) eigensolver) plus
    one tiny [iters, iters] Jacobi eigensolve.

    Safety: a Ritz value theta only bounds lambda_min from ABOVE, so the
    candidate is ``theta_min - |beta_k * s_k|`` (the classical residual
    bound ||M v - theta v|| = |beta_k| |last component of tridiag
    eigenvector|, Parlett SEP thm) minus a Cholesky rounding margin. The
    residual bound only places SOME eigenvalue near theta: when the Krylov
    space missed the bottom of the spectrum (an unconverged run at large
    m), the candidate can lie above lambda_min. So every candidate is
    certified by one Cholesky of M - candidate*I (it succeeds iff the
    candidate is below lambda_min, up to the margin); batches with an
    uncertified element fall back to the Cholesky bisection
    (linalg.eigmin_chol). Steplengths derived from the result can be
    conservative but never overstep the cone.
    """
    nb, m, _ = M.shape
    dtype = M.dtype
    k = int(min(iters, m))

    # deterministic full-support start vector (never orthogonal to the
    # minimal eigenvector in exact arithmetic for generic M; rounding
    # reintroduces components regardless)
    i = jnp.arange(m, dtype=dtype)
    v0 = jnp.sin(i * 1.31 + 0.7) + 0.01 * (i + 1.0) / m
    v0 = jnp.broadcast_to(v0 / jnp.linalg.norm(v0), (nb, m))

    Vb = jnp.zeros((nb, k, m), dtype=dtype).at[:, 0, :].set(v0)
    alpha = jnp.zeros((nb, k), dtype=dtype)
    beta = jnp.zeros((nb, k), dtype=dtype)  # beta[j] = ||r_j|| after step j

    def body(j, carry):
        Vb, alpha, beta = carry
        v = Vb[:, j, :]
        w = jnp.einsum("bpq,bq->bp", M, v)
        a = jnp.einsum("bp,bp->b", v, w)
        alpha = alpha.at[:, j].set(a)
        # full reorthogonalization against all previous vectors (twice, for
        # the classical 'twice is enough' robustness)
        for _ in range(2):
            coeff = jnp.einsum("bkp,bp->bk", Vb, w)
            w = w - jnp.einsum("bk,bkp->bp", coeff, Vb)
        b = jnp.linalg.norm(w, axis=-1)
        beta = beta.at[:, j].set(b)
        bsafe = jnp.where(b > 0, b, 1.0)
        vnext = jnp.where((b > 0)[:, None], w / bsafe[:, None], 0.0)
        Vb = jax.lax.cond(
            j + 1 < k,
            lambda Vb: Vb.at[:, j + 1, :].set(vnext),
            lambda Vb: Vb,
            Vb,
        )
        return Vb, alpha, beta

    Vb, alpha, beta = jax.lax.fori_loop(0, k, body, (Vb, alpha, beta))

    # tridiagonal T: diag alpha, offdiag beta[:-1]
    T = (
        jax.vmap(jnp.diag)(alpha)
        + jax.vmap(lambda b: jnp.diag(b[:-1], 1))(beta)
        + jax.vmap(lambda b: jnp.diag(b[:-1], -1))(beta)
    )
    lam, U = eigh_jacobi(T)
    theta = lam[:, 0]
    s_last = U[:, -1, 0]
    resid = jnp.abs(beta[:, -1] * s_last)
    # rounding margin: the Cholesky backward error class, 2 m u ||M||
    # (Gershgorin scale >= ||M||)
    scale = jnp.max(jnp.sum(jnp.abs(M), axis=-1), axis=-1)
    eps = jnp.asarray(np.finfo(np.dtype(dtype)).eps, dtype)
    lo = theta - resid - 2.0 * m * eps * scale
    L = jnp.linalg.cholesky(M - lo[:, None, None] * jnp.eye(m, dtype=dtype))
    certified = jnp.logical_not(jnp.isnan(L).any(axis=(-1, -2)))
    return jax.lax.cond(
        certified.all(),
        lambda M: lo,
        lambda M: jnp.where(certified, lo, eigmin_chol(M)),
        M,
    )


def eigh_jacobi(M: jax.Array, sweeps: int | None = None) -> Tuple[jax.Array, jax.Array]:
    """Eigendecomposition of a batch of symmetric matrices [nb, m, m].

    Returns (eigenvalues ascending [nb, m], eigenvectors [nb, m, m]) with
    M = V diag(lam) V^T. Odd m is handled by an internal decoupled pad
    index (zero off-diagonal coupling, sentinel diagonal sorted last).
    """
    nb, m, _ = M.shape
    if sweeps is None:
        sweeps = _default_sweeps(m)
    if m % 2 != 0:
        big = jnp.max(jnp.sum(jnp.abs(M), axis=-1)) + 1.0  # beyond the spectrum
        Mp = jnp.zeros((nb, m + 1, m + 1), dtype=M.dtype)
        Mp = Mp.at[:, :m, :m].set(M).at[:, m, m].set(big)
        pairs = jnp.asarray(round_robin_pairs(m + 1))
        lam, V = _eigh_jacobi_impl(Mp, pairs, sweeps)
        return lam[:, :m], V[:, :m, :m]
    pairs = jnp.asarray(round_robin_pairs(m))
    return _eigh_jacobi_impl(M, pairs, sweeps)
