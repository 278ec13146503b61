"""Preconditioned conjugate gradients as a jit-safe ``lax.while_loop``.

Replaces the reference's external ConjugateGradients.jl dependency
(`src/predictor_corrector.jl:134,235`). Convergence: relative residual
``||r|| <= tol * ||b||`` with an iteration cap (reference uses
``maxIter = 10000``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["pcg", "cg_plain"]


def cg_plain(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    tol: jax.Array,
    maxiter: int,
) -> Tuple[jax.Array, jax.Array]:
    """Unpreconditioned CG, latency-lean: 6 ops per iteration (one matvec,
    two scalar reductions, three axpys). Used by the materialized small-n
    path on the SPLIT-preconditioned system Hp = Mli H Mli^T, which has the
    same Krylov iterates (hence iteration counts) as `pcg` on H with
    M = Mli^T Mli — at small n each op costs a kernel launch regardless
    of size, so fewer ops is the whole game there."""
    threshold2 = tol * tol * jnp.vdot(b, b)

    def cond(c: _CGCarry):
        return jnp.logical_and(c.rr > threshold2, c.it < maxiter)

    def body(c: _CGCarry):
        Ap = matvec(c.p)
        alpha = c.rr / jnp.vdot(c.p, Ap)
        x = c.x + alpha * c.p
        r = c.r - alpha * Ap
        rr = jnp.vdot(r, r)
        p = r + (rr / c.rr) * c.p
        return _CGCarry(x=x, r=r, p=p, rz=rr, rr=rr, it=c.it + 1)

    carry0 = _CGCarry(
        x=jnp.zeros_like(b), r=b, p=b, rz=jnp.vdot(b, b), rr=jnp.vdot(b, b),
        it=jnp.int32(0),
    )
    out = lax.while_loop(cond, body, carry0)
    return out.x, out.it


class _CGCarry(NamedTuple):
    x: jax.Array
    r: jax.Array
    p: jax.Array
    rz: jax.Array
    rr: jax.Array  # ||r||^2, carried so cond() is a scalar compare
    it: jax.Array


def pcg(
    matvec: Callable[[jax.Array], jax.Array],
    b: jax.Array,
    precond: Callable[[jax.Array], jax.Array],
    tol: jax.Array,
    maxiter: int,
) -> Tuple[jax.Array, jax.Array]:
    """Solve A x = b with preconditioned CG. Returns (x, iterations).

    Latency-tuned for the device while-loop: ||r||^2 is carried (the stopping
    test is a scalar compare, no norm kernel in cond), and the (rr, rz)
    reductions are fused into one stacked sum per iteration.
    """
    threshold2 = tol * tol * jnp.vdot(b, b)
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    carry0 = _CGCarry(
        x=x0, r=r0, p=z0, rz=jnp.vdot(r0, z0), rr=jnp.vdot(r0, r0),
        it=jnp.int32(0),
    )

    def cond(c: _CGCarry):
        return jnp.logical_and(c.rr > threshold2, c.it < maxiter)

    def body(c: _CGCarry):
        Ap = matvec(c.p)
        pAp = jnp.vdot(c.p, Ap)
        alpha = c.rz / pAp
        x = c.x + alpha * c.p
        r = c.r - alpha * Ap
        z = precond(r)
        both = jnp.stack([r, z]) @ r  # [rr, rz] in one reduction
        rr, rz = both[0], both[1]
        beta = rz / c.rz
        p = z + beta * c.p
        return _CGCarry(x=x, r=r, p=p, rz=rz, rr=rr, it=c.it + 1)

    out = lax.while_loop(cond, body, carry0)
    return out.x, out.it
