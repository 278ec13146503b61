"""Accurate (double-double class) matrix multiply via the Ozaki scheme.

Computes ``A @ B`` to ~``bits`` significant bits using only STANDARD f64
GEMMs plus elementwise double-double accumulation — high-precision matmul
whose heavy FLOPs all stay GEMM-shaped instead of
scalarizing into software multiprecision (the reference reaches the same
capability through MultiFloats `Float64xN` scalars, `src/Solvers.jl:10`).

Scheme (Ozaki-Ogita-Oishi-Rump error-free matrix-product transform): slice
each operand into exponent-aligned pieces of ``beta`` significand bits,
with ``2*beta + ceil(log2(k)) <= 53`` (k = contraction length). Then every
partial product GEMM ``A_p @ B_q`` is EXACT in f64 (each output element is
a sum of <= 2^w grid-aligned products of <= 2*beta bits: no rounding).
The exact partials are accumulated elementwise in double-double, largest
first; pairs with ``(p+q)*beta > bits`` are truncated, bounding the total
relative error by ~2^-bits of |A||B| scale.

Used by the solver's high-precision mode (``precision='dd'``) for Schur
assembly and iterative refinement residuals.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from .dd import DD, dd_add, two_sum

__all__ = [
    "slice_operand",
    "acc_matmul",
    "acc_matvec",
    "dd_gemm_hi_lo",
    "pow2_int",
    "ceil_log2",
]

# Fiber-max clamp for slice_operand. 2**-400 (not the f64-min-adjacent
# 2**-1000): it keeps every exponent handed to pow2_int within +-1024 by
# construction (|e| <= max(400, 1026) + beta*s ~ 1005 for the largest
# slicing configs), so no derived power of two ever leaves the exactly
# representable range. Fibers with max below 2**-400 contribute < 2**-800
# to any product — far below the dd (2**-106) resolution target.
_TINY = 2.0**-400


def pow2_int(e: jax.Array, dtype=jnp.float64) -> jax.Array:
    """EXACT 2**e for integer arrays e, built by repeated squaring — every
    multiply of powers of two is exact in f64 (including subnormal powers
    down to 2**-1074).

    Domain: e in [-1022, 1023], the NORMAL f64 range; arguments outside are
    CLAMPED to it (a jit-safe fail-stop: callers are documented to stay in
    range, and a clamped value keeps everything finite instead of silently
    returning a wrong scale — see the slice_operand invariant note). The
    lower end is -1022, not the subnormal -1074: XLA flushes f64 subnormals
    to zero (measured: 2**-1022 * 0.5 == 0.0 on CPU), so subnormal powers
    of two are not representable at runtime.

    Why not frexp/ldexp: they need an f64 <-> s64 bitcast that not every
    XLA backend lowers, and exp2 is not guaranteed to hit exact powers of
    two. No value here ever becomes inf
    (an inf in a not-taken where() branch is fragile): the negative
    branch accumulates exact 0.5-powers directly (never forming 2**k for
    k > 1023 and then dividing), and the positive branch is clamped below
    2**1024.
    """
    neg = e < 0
    k = jnp.abs(e).astype(jnp.int32)
    k = jnp.minimum(k, jnp.where(neg, 1022, 1023))  # both fit in 10 bits
    # base two for positive e, one-half for negative: products of exact
    # powers of two are exact in f64 in both directions (no subnormals
    # are reached under the clamp, all intermediates stay normal)
    two = jnp.where(neg, jnp.asarray(0.5, dtype), jnp.asarray(2.0, dtype))
    result = jnp.ones(e.shape, dtype=dtype)
    base = two
    for j in range(10):  # k < 1024
        result = jnp.where((k & 1) == 1, result * base, result)
        k = k >> 1
        if j < 9:  # largest base needed: two**512
            base = base * base
    return result


def ceil_log2(x: jax.Array) -> jax.Array:
    """int32 e with 2**e >= x (one bit of headroom against log2 rounding);
    x must be positive."""
    return (jnp.floor(jnp.log2(x)) + 2.0).astype(jnp.int32)


def _slice_params(k: int, bits: int):
    w = max(1, math.ceil(math.log2(max(2, k))))
    beta = (53 - w) // 2
    if beta < 10:
        raise ValueError(f"contraction length {k} too large for Ozaki slicing")
    # each operand must be covered to ~bits so that the dropped residual
    # times the other operand stays below the target
    nsl = max(2, math.ceil(bits / beta))
    return beta, nsl


def slice_operand(X: jax.Array, axis: int, beta: int, s: int):
    """Split X into s exponent-aligned slices of <= beta significand bits
    each (per-fiber along ``axis``), X == sum(slices) + residual (dropped).
    Returns a list of arrays shaped like X.

    Extraction is round-to-grid by exact power-of-two divide (q*sigma with
    integer |q| <= 2^(beta-1)): unlike the classic add-shift trick it has
    no sub-grid boundary case for negative values, and it needs no
    frexp/ldexp."""
    mx = jnp.max(jnp.abs(X), axis=axis, keepdims=True)
    e = ceil_log2(jnp.maximum(mx, _TINY))  # 2**e in [2*mx, 4*mx]
    slices = []
    R = X
    for i in range(s):
        sigma = pow2_int(e - beta * (i + 1), X.dtype)
        inv = pow2_int(beta * (i + 1) - e, X.dtype)
        q = jnp.round(R * inv) * sigma  # multiple of sigma, <= beta bits
        slices.append(q)
        R = R - q  # exact
    return slices


def acc_matmul(A: jax.Array, B: jax.Array, bits: int = 106) -> DD:
    """A [..., m, k] @ B [..., k, n] -> DD [..., m, n], accurate to ~2^-bits
    relative to the |A| |B| scale. Broadcasting batch dims follow
    ``jnp.matmul``."""
    k = A.shape[-1]
    if B.shape[-2] != k:
        raise ValueError(f"contraction mismatch {A.shape} @ {B.shape}")
    beta, s = _slice_params(k, bits)
    Asl = slice_operand(A, -1, beta, s)
    Bsl = slice_operand(B, -2, beta, s)
    acc = None
    # largest partials first: accumulate in increasing p+q
    for t in range(2 * s - 1):
        if (t + 2) * beta > bits + 2 * beta:  # truncate sub-target terms
            break
        for p in range(s):
            q = t - p
            if q < 0 or q >= s:
                continue
            part = Asl[p] @ Bsl[q]  # EXACT f64 GEMM by construction
            if acc is None:
                acc = DD(part, jnp.zeros_like(part))
            else:
                acc = dd_add(acc, DD(part, jnp.zeros_like(part)))
    return acc


def acc_matvec(A: jax.Array, x: jax.Array, bits: int = 106) -> DD:
    """A [..., m, k] @ x [..., k] -> DD [..., m]."""
    r = acc_matmul(A, x[..., None], bits=bits)
    return DD(r.hi[..., 0], r.lo[..., 0])


def dd_gemm_hi_lo(Ahi: jax.Array, Alo: jax.Array, B: jax.Array, bits: int = 106) -> DD:
    """(Ahi + Alo) @ B in dd: accurate GEMM on the hi part plus a plain f64
    GEMM for the lo part (whose own rounding error is ~u^2 of the total)."""
    r = acc_matmul(Ahi, B, bits=bits)
    lo_part = Alo @ B
    s = two_sum(r.hi, lo_part)
    return DD(s.hi, s.lo + r.lo)
