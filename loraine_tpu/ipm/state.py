"""Solver iterate state and per-iteration statistics.

The whole iterate is a small pytree advanced by a jitted step — the reference
keeps the same quantities as mutable fields on `MySolver` (`src/Solvers.jl:
18-147`); deltas, scaling and residuals are *local* to one step here, so the
persistent state is just (X, S, y, LP variables, sigma).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["X", "S", "y", "X_lin", "S_lin", "sigma",
                 "X_lo", "S_lo", "y_lo", "X_lin_lo", "S_lin_lo"],
    meta_fields=[],
)
@dataclasses.dataclass
class IPMState:
    X: Tuple[jax.Array, ...]  # per block group [nb, m, m]
    S: Tuple[jax.Array, ...]
    y: jax.Array  # [n]
    X_lin: Optional[jax.Array]  # [nlin] or None
    S_lin: Optional[jax.Array]
    sigma: jax.Array  # scalar
    # double-double tails (precision='dd2': iterates stored as hi+lo pairs,
    # the stand-in for the reference's Float64x4-class tiers,
    # `src/Solvers.jl:18` MySolver{T}; None in every other mode)
    X_lo: Optional[Tuple[jax.Array, ...]] = None
    S_lo: Optional[Tuple[jax.Array, ...]] = None
    y_lo: Optional[jax.Array] = None
    X_lin_lo: Optional[jax.Array] = None
    S_lin_lo: Optional[jax.Array] = None


class StepStats(NamedTuple):
    """Scalars shipped to the host after each iteration (drives the log table
    and the status decisions in the outer loop)."""

    obj: jax.Array  # -b^T y + b_const
    mu: jax.Array
    sigma: jax.Array
    err1: jax.Array
    err2: jax.Array
    err3: jax.Array
    err4: jax.Array
    err5: jax.Array
    err6: jax.Array
    dimacs: jax.Array
    alpha_min: jax.Array
    beta_min: jax.Array
    h_shifts: jax.Array  # Schur-Cholesky regularization shifts this iter
    h_ok: jax.Array  # Schur factorization succeeded
    nt_ok: jax.Array  # NT scaling Cholesky factorizations succeeded
    cg_iter_pre: jax.Array
    cg_iter_cor: jax.Array
