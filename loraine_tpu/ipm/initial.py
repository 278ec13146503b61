"""Initial point heuristics.

Two strategies matching the reference (`src/initial_point.jl:17-81`):
  initpoint = 0: X = I, S = n * I (n = number of variables), LP vars = 1.
  initpoint = 1: SDPT3-like norm-scaled identity start.

These are one-time host-side computations (numpy-ish jnp, no jit needed).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..config import Options
from ..problem import SDPProblem
from .state import IPMState

__all__ = ["initial_point", "INITIAL_SIGMA", "TAU", "EXPON"]

# Reference constants `src/initial_point.jl:5-9`.
INITIAL_SIGMA = 3.0
TAU = 0.95
EXPON = 3.0


def initial_point(problem: SDPProblem, opts: Options) -> IPMState:
    """Pure host-side (numpy) construction — on an accelerator every eager
    device op is a separate tiny executable, so the start point is built in
    numpy and shipped once."""
    dtype = problem.b.dtype
    n = problem.n
    b2 = 1.0 + np.abs(np.asarray(problem.b))
    norm_b2 = float(np.linalg.norm(b2))

    Xs, Ss = [], []
    for g in problem.groups:
        m = g.m
        eye = np.eye(m)[None]
        if opts.initpoint == 0:
            eps = np.ones((g.nb,))
            eta = np.full((g.nb,), float(n))
        else:
            fro_A = np.asarray(g.data_norms)  # [nb], precomputed at build
            f = norm_b2 / (1.0 + fro_A)
            eps = np.sqrt(m) * np.maximum(1.0, np.sqrt(m) * f)
            fro_C = np.asarray(g.C_norms)
            mf = np.maximum(f, fro_C)
            mf = (1.0 + mf) / np.sqrt(m)
            eta = np.sqrt(m) * np.maximum(1.0, mf)
        Xs.append(jnp.asarray(eps[:, None, None] * eye, dtype=dtype))
        Ss.append(jnp.asarray(eta[:, None, None] * eye, dtype=dtype))

    if problem.nlin > 0:
        if opts.initpoint == 0:
            epss = etaa = 1.0
        else:
            C_lin = np.asarray(problem.C_lin)  # [n, nlin]
            row_norms = np.linalg.norm(C_lin, axis=1)  # per variable j
            p = b2 / (1.0 + row_norms)
            epss = max(1.0, float(p.max())) if p.size else 1.0
            mf = max(float(row_norms.max()) if row_norms.size else 0.0,
                     float(np.linalg.norm(np.asarray(problem.d_lin))))
            etaa = max(1.0, mf / np.sqrt(problem.nlin))
        X_lin = jnp.asarray(np.full(problem.nlin, epss), dtype=dtype)
        S_lin = jnp.asarray(np.full(problem.nlin, etaa), dtype=dtype)
    else:
        X_lin = None
        S_lin = None

    if opts.precision == "dd2":
        # dd-stored iterates: the start point is f64-exact, so the tails
        # begin at zero (see ipm/step.py dd2 mode)
        return IPMState(
            X=tuple(Xs),
            S=tuple(Ss),
            y=jnp.asarray(np.zeros(n), dtype=dtype),
            X_lin=X_lin,
            S_lin=S_lin,
            sigma=jnp.asarray(INITIAL_SIGMA, dtype=dtype),
            X_lo=tuple(jnp.zeros_like(X) for X in Xs),
            S_lo=tuple(jnp.zeros_like(S) for S in Ss),
            y_lo=jnp.asarray(np.zeros(n), dtype=dtype),
            X_lin_lo=None if X_lin is None else jnp.zeros_like(X_lin),
            S_lin_lo=None if S_lin is None else jnp.zeros_like(S_lin),
        )
    return IPMState(
        X=tuple(Xs),
        S=tuple(Ss),
        y=jnp.asarray(np.zeros(n), dtype=dtype),
        X_lin=X_lin,
        S_lin=S_lin,
        sigma=jnp.asarray(INITIAL_SIGMA, dtype=dtype),
    )
