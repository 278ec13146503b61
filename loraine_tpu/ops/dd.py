"""Double-double (compensated float64-pair) arithmetic primitives.

The equivalent of the reference's high-precision mode
(MultiFloats `Float64x2`, `src/Solvers.jl:10`, `README.md:37-54`): a value
is represented as an unevaluated sum ``hi + lo`` with ``|lo| <= ulp(hi)/2``,
giving ~32 significant digits. Built from the classical error-free
transforms (Knuth TwoSum, Dekker split/TwoProd), which are exact in IEEE
binary64 arithmetic; all ops are branch-free, vectorized, and jit-safe.

The solver uses these for the precision-critical inner products and the
Schur-solve residual (iterative refinement in twice working precision) when
``precision='dd'`` is selected — the scope SURVEY.md section 7.8 prescribes
("double-double for the Cholesky/residual path"), chosen after measuring
the plain-f64 DIMACS floors (docs/precision.md).

Note: correctness relies on IEEE-compliant f64 with one rounding per
add/mul (no fast-math reassociation in XLA by default). Whether a
platform's compiler keeps the transforms exact is a row of the platform
table (config.AUTO_BACKENDS 'dd_exact'): tests verify the identities on the
CPU against numpy.longdouble, and chip_smoke.py checks them on the GPU
against exact rationals.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

__all__ = [
    "DD",
    "two_sum",
    "two_prod",
    "dd_add",
    "dd_mul_f64",
    "dd_neg",
    "dd_sum",
    "dd_dot",
    "dd_matvec",
    "dd_to_f64",
]

_SPLIT = 134217729.0  # 2**27 + 1, Dekker splitter for binary64


class DD(NamedTuple):
    """Unevaluated hi+lo pair; ``hi`` carries the leading 53 bits."""

    hi: jax.Array
    lo: jax.Array


def two_sum(a: jax.Array, b: jax.Array) -> DD:
    """Knuth TwoSum: s + e == a + b exactly, s = fl(a + b).

    The ``0.0 * b`` term is an XLA:CPU fold-blocker, not arithmetic: the
    algebraic simplifier pattern-matches ``(a + b) - a -> b`` /
    ``s - (s - a) -> a`` inside fusions (measured in the dd Jacobi: results
    degraded to plain-f64 accuracy, tests/test_dd_linalg.py), which is
    exactly the cancellation two_sum exists to capture. Routing ``bb``
    through a value-identical but structurally distinct node disables the
    pattern; where no such fold exists it is an exact no-op."""
    s = a + b
    bb = (s - a) + 0.0 * b
    e = (a - (s - bb)) + (b - bb)
    return DD(s, e)


def _split(a: jax.Array) -> Tuple[jax.Array, jax.Array]:
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: jax.Array, b: jax.Array) -> DD:
    """Dekker TwoProd: p + e == a * b exactly, p = fl(a * b)."""
    p = a * b
    ahi, alo = _split(a)
    bhi, blo = _split(b)
    e = ((ahi * bhi - p) + ahi * blo + alo * bhi) + alo * blo
    return DD(p, e)


def _renorm(hi: jax.Array, lo: jax.Array) -> DD:
    s = hi + lo
    # (s - hi) + 0.0*lo: XLA:CPU fold-blocker (see two_sum) — the simplifier
    # rewrite (hi + lo) - hi -> lo would zero the correction entirely
    t = (s - hi) + 0.0 * lo
    return DD(s, lo - t)


def dd_add(x: DD, y: DD) -> DD:
    """Full dd + dd (Dekker add22, ~11 flops)."""
    s = two_sum(x.hi, y.hi)
    t = two_sum(x.lo, y.lo)
    c = s.lo + t.hi
    v = _renorm(s.hi, c)
    w = t.lo + v.lo
    return _renorm(v.hi, w)


def dd_neg(x: DD) -> DD:
    return DD(-x.hi, -x.lo)


def dd_mul_f64(x: DD, a: jax.Array) -> DD:
    """dd * f64."""
    p = two_prod(x.hi, a)
    return _renorm(p.hi, p.lo + x.lo * a)


def dd_sum(x: DD, axis: int = -1) -> DD:
    """Reduce a dd array along ``axis`` with a pairwise tree of dd adds,
    keeping the ~u^2 accumulation error of true double-double summation
    (vs u*log(n) for plain pairwise f64). The log2(n) fold unrolls at
    trace time — shapes are static under jit."""
    hi = jnp.moveaxis(x.hi, axis, -1)
    lo = jnp.moveaxis(x.lo, axis, -1)
    n = hi.shape[-1]
    while n > 1:
        half = n // 2
        head = DD(hi[..., :half], lo[..., :half])
        tail = DD(hi[..., half : 2 * half], lo[..., half : 2 * half])
        acc = dd_add(head, tail)
        if n % 2:
            # odd element folds into the first slot
            first = dd_add(
                DD(acc.hi[..., :1], acc.lo[..., :1]),
                DD(hi[..., -1:], lo[..., -1:]),
            )
            hi = jnp.concatenate([first.hi, acc.hi[..., 1:]], axis=-1)
            lo = jnp.concatenate([first.lo, acc.lo[..., 1:]], axis=-1)
        else:
            hi, lo = acc.hi, acc.lo
        n = half
    return DD(hi[..., 0], lo[..., 0])


def dd_dot(a: jax.Array, b: jax.Array) -> DD:
    """Dot product in twice working precision (Ogita-Rump-Oishi dot2
    accuracy class): TwoProd each term, dd-tree-sum the results.
    ``a``/``b`` may carry leading batch axes; contraction is over the
    last axis."""
    p = two_prod(a, b)
    return dd_sum(p, axis=-1)


def dd_matvec(H: jax.Array, x: jax.Array) -> DD:
    """H @ x with dd accumulation: [n, n] @ [n] -> dd [n]."""
    return dd_dot(H, x[None, :])


def dd_to_f64(x: DD) -> jax.Array:
    return x.hi + x.lo
