"""f64-accurate matrix multiply from int8 GEMMs (integer Ozaki scheme).

Integer tensor cores multiply int8 with EXACT int32 accumulation at far
higher throughput than f64 units. This module reconstructs f64-accurate
products from exact integer partial products:

    A's row i is split into slices  A = sum_p sigma_i 2^(-6p) Q_p[i,:]
    with Q_p int8, |Q_p| <= 64 (6-bit payload; exponent-aligned per row).
    Likewise B per column. Every pairwise product Q_p(A) @ Q_q(B) is an
    exact int32 GEMM (|prod| <= 2^12, k <= 2^18 terms -> < 2^31).
    Partials with equal t = p+q share the 2^(-6t) weight; the weighted f64
    recombination is a handful of elementwise multiply-adds.

Accuracy: slices cover 6*s bits per operand; with the default s (enough
for > 54 bits) the result is at least as accurate as a true fused f64
GEMM (error 2^-60 * |A||B| from truncation, below f64's own 2^-53 rounding
of the inputs' products). This is the integer variant of the Ozaki
error-free transform used in ops/ozaki.py for the double-double mode.

Use: the opt-in ``gemm_backend='int8'`` for the rank-1 Schur assembly's
large GEMMs. It wins only where int8 GEMMs outrun native f64 by more than
the ~s^2/2 partial products cost; no such win is measured yet.
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

__all__ = ["matmul_f64_int8", "INT8_BETA"]

INT8_BETA = 6  # payload bits per slice: |q| <= 64 fits int8 with headroom
_TINY = 2.0**-1000


def _slice_int8(X: jax.Array, axis: int, s: int):
    """Split X into s int8 slices along exponent-aligned per-fiber grids.

    Returns (slices int8 [s, ...], scale f64 broadcastable to X) with
    X ≈ sum_p scale * 2^(-6(p+1)) * slices[p] (residual < scale*2^(-6s)/2).
    Exact powers of two come from repeated squaring (ozaki.pow2_int).
    """
    from .ozaki import ceil_log2, pow2_int

    mx = jnp.max(jnp.abs(X), axis=axis, keepdims=True)
    e = ceil_log2(jnp.maximum(mx, _TINY))  # 2**e in [2*mx, 4*mx]
    scale = pow2_int(e)
    R = X
    out = []
    for p in range(s):
        inv = pow2_int(INT8_BETA * (p + 1) - e)
        sigma = pow2_int(e - INT8_BETA * (p + 1))
        q = jnp.round(R * inv)  # |q| <= 2**(INT8_BETA-1) + 1 << 127
        out.append(q.astype(jnp.int8))
        R = R - q * sigma  # exact: q integer <= 7 bits, sigma power of two
    return jnp.stack(out), scale


def _num_slices(bits: int) -> int:
    return int(math.ceil(bits / INT8_BETA)) + 1


@partial(jax.jit, static_argnames=("bits",))
def matmul_f64_int8(A: jax.Array, B: jax.Array, bits: int = 55) -> jax.Array:
    """A [..., m, k] @ B [..., k, n] in f64-equivalent accuracy, with all
    heavy FLOPs as int8 x int8 -> int32 GEMMs."""
    if A.dtype != jnp.float64 or B.dtype != jnp.float64:
        raise TypeError("matmul_f64_int8 expects f64 operands")
    k = A.shape[-1]
    if k > (1 << 17):
        raise ValueError("contraction too long for int32 accumulation")
    s = _num_slices(bits)
    Asl, a_scale = _slice_int8(A, -1, s)  # [s, ..., m, k], scale [..., m, 1]
    Bsl, b_scale = _slice_int8(B, -2, s)  # [s, ..., k, n], scale [..., 1, n]

    tmax = min(2 * s - 2, _num_slices(bits))  # t = p+q; weight 2^(-6(t+2))
    out = None
    for t in range(tmax + 1):
        acc = None  # f64 accumulation across pairs (each partial is exact
        # int32 for k <= 2^17; summing pairs in int32 could overflow)
        for p in range(max(0, t - s + 1), min(s, t + 1)):
            q = t - p
            part = jax.lax.dot_general(
                Asl[p],
                Bsl[q],
                (((Asl[p].ndim - 1,), (Bsl[q].ndim - 2,)),
                 (tuple(range(Asl[p].ndim - 2)), tuple(range(Bsl[q].ndim - 2)))),
                preferred_element_type=jnp.int32,
            ).astype(jnp.float64)
            acc = part if acc is None else acc + part
        w = 2.0 ** (-INT8_BETA * (t + 2))
        out = acc * w if out is None else out + acc * w
    return out * (a_scale * b_scale)
