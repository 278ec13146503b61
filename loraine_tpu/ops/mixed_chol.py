"""Mixed-precision blocked Cholesky: f32 panels + f64 Newton refinement.

Why: the IPM's direct path factors the Schur matrix H every iteration and
the NT scaling factors X every iteration (reference
`src/predictor_corrector.jl:55-97`, `src/prepare_W.jl:5-26`) — together a
large share of the per-iteration cost at large n/m. Where an f32 panel
factorization is much cheaper than an f64 one, this module factors to f64
accuracy at close to f32 cost (opt-in: chol_backend='mixed'; no measured
win on a GPU with native f64 yet):

  per 128-panel k of a right-looking blocked elimination
    D = T[:b,:b]                       (f64, trailing-updated)
    L32  = chol(f32(D))                 f32 panel factorization
    Li32 = triinv(L32)                  f32
    Newton-refine to f64 (`passes` times, all panel-sized GEMMs):
      E  = D - L L^T                    (f64)
      F  = Li32 E Li32^T                (f32; absolute error u32*sqrt(k)|F|)
      L += L32 @ phi(F)                 (f64 GEMM; phi = tril + diag/2)
    and refine the inverse: Li <- Li (2I - L Li)   (f64 GEMMs)
    fallback (lax.cond, only the taken branch executes): if the f32 panel
    was indefinite-in-f32 or the refinement did not contract (kappa(D)
    beyond ~1/u32), factor the panel with XLA's f64 Cholesky instead —
    bitwise the conservative path, paying its latency only for the panels
    that need it (IPM ill-conditioning concentrates in late panels).
  off-diagonal panel: L_rk = R @ Li_kk^T            (one f64 GEMM)
  trailing update:    T   -= L_rk L_rk^T            (one f64 GEMM)

All O(n^3) work is f64 GEMMs; all sequential latency is f32-panel-sized.
The one f32 GEMM (the Newton residual F) asks for Precision.HIGHEST, so a
GPU never runs it as TF32 (whose ~1e-3 relative error would stall the
refinement). NaN semantics match `jnp.linalg.cholesky`: a panel that
is indefinite in f64 yields NaNs that propagate through later panels, so
`chol_reg`'s NaN-keyed shift loop works unchanged.

Accuracy: with `passes=3` the per-panel factor residual reaches the f64
roundoff class for kappa(panel) up to ~1e6 and degrades gracefully above
(the Newton contraction is ~u32*kappa per pass); the fallback triggers on
measured non-contraction, so delivered accuracy is bounded by the check in
`_PANEL_ACCEPT`. Oracle-tested against the f64 factorization in
tests/test_mixed_chol.py across conditioning regimes.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["panel_chol_mixed", "chol_mixed_blocked"]

# accept the mixed panel when the last Newton residual F = Li E Li^T is
# below this (spectral-relative) size: the NEXT correction would change L by
# |F|/2 relative, so |F| <= 1e-7 leaves the factor within ~5e-8 of the f64
# one — combined with the quadratic contraction this means the accepted
# factor's residual is ~|F|^2 ~ 1e-14-class. Above the threshold the panel
# recomputes in f64.
_PANEL_ACCEPT = 1e-7


def _dot32(a: jax.Array, b: jax.Array) -> jax.Array:
    """Batched f32 matmul at full f32 precision (never TF32)."""
    return jnp.matmul(a, b, precision=lax.Precision.HIGHEST)


def _phi(F: jax.Array) -> jax.Array:
    """Lower-triangular half-projection: tril(F, -1) + diag(F)/2."""
    return jnp.tril(F, -1) + 0.5 * jnp.tril(jnp.triu(F))


def panel_chol_mixed(D: jax.Array, passes: int = 3):
    """Factor a (batched) f64 SPD panel: returns (L, Li) in f64.

    f32 seed + `passes` Newton refinements of both the factor and its
    inverse; falls back to XLA's f64 Cholesky (one lax.cond for the whole
    batch) when the f32 path fails or does not contract.
    """
    b = D.shape[-1]
    eye = jnp.eye(b, dtype=D.dtype)
    f32 = jnp.float32

    L32 = jnp.linalg.cholesky(D.astype(f32))
    seed_bad = jnp.isnan(L32).any()

    def mixed(_):
        Li32 = jax.scipy.linalg.solve_triangular(
            L32, jnp.broadcast_to(eye.astype(f32), L32.shape), lower=True
        )
        L = L32.astype(D.dtype)
        Fmax = jnp.zeros((), D.dtype)
        for _ in range(passes):
            E = D - L @ jnp.swapaxes(L, -1, -2)
            F = _dot32(_dot32(Li32, E.astype(f32)), jnp.swapaxes(Li32, -1, -2))
            F = F.astype(D.dtype)
            Fmax = jnp.max(jnp.abs(F))
            L = L + L @ _phi(F)
        # refine the inverse to f64: Li <- Li (2I - L Li), twice
        Li = Li32.astype(D.dtype)
        for _ in range(2):
            Li = Li @ (2.0 * eye - L @ Li)
        Li = jnp.tril(Li)
        ok = Fmax <= _PANEL_ACCEPT
        return L, Li, ok

    def fallback(_):
        L = jnp.linalg.cholesky(D)
        Li = jax.scipy.linalg.solve_triangular(
            L, jnp.broadcast_to(eye, L.shape), lower=True
        )
        return L, Li, jnp.asarray(True)

    L, Li, ok = lax.cond(seed_bad, fallback, mixed, None)
    # second-stage fallback: mixed ran but did not contract enough
    return lax.cond(
        jnp.logical_and(jnp.logical_not(seed_bad), jnp.logical_not(ok)),
        fallback,
        lambda _: (L, Li, jnp.asarray(True)),
        None,
    )[:2]


def chol_mixed_blocked(M: jax.Array, base: int = 128) -> jax.Array:
    """Batched lower Cholesky, blocked right-looking with mixed-precision
    panels. Drop-in for `linalg.chol_blocked` (same NaN semantics); see the
    module docstring for the per-panel algorithm."""
    n = M.shape[-1]
    if n <= base:
        L, _ = panel_chol_mixed(M)
        return L
    batch = M.shape[:-2]
    cols = []
    T = M
    k = 0
    while k < n:
        b = min(base, n - k)
        D = T[..., :b, :b]
        Ld, Ldi = panel_chol_mixed(D)
        if k + b < n:
            R = T[..., b:, :b]
            Lr = R @ jnp.swapaxes(Ldi, -1, -2)  # R L_kk^{-T}, one GEMM
            col = jnp.concatenate([Ld, Lr], axis=-2)
            T = T[..., b:, b:] - Lr @ jnp.swapaxes(Lr, -1, -2)
        else:
            col = Ld
        if k:
            col = jnp.concatenate(
                [jnp.zeros(batch + (k, b), dtype=M.dtype), col], axis=-2
            )
        cols.append(col)
        k += b
    return jnp.concatenate(cols, axis=-1)
