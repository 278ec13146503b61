"""Per-phase timing diagnostics.

The production step is one fused jitted program (by design: one dispatch,
cross-phase fusion), so phase times are measured here by running each phase as its own
jitted piece on a representative iterate. Phase names mirror the reference's
TimerOutputs sections (`prepare_W` `src/prepare_W.jl:37-46`, `BBBB`
`src/makeBBBB.jl:86-98`, `backslash`/Cholesky `src/predictor_corrector.jl:
55-97`, `find_step_A..D` `src/predictor_corrector.jl:251-285`, convergence
`src/Solvers.jl:496-568`; printed by the reference when `timing > 0`,
`src/Loraine.jl:88-90`).

Wired into the solver: ``timing=2`` prints this breakdown after the solve
(`Solver.solve`), and the CLI exposes ``--phases``.

    from loraine_tpu.utils.diagnostics import profile_phases
    times = profile_phases(problem, options)   # dict of seconds
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import jax
import jax.numpy as jnp

from ..config import Options
from ..ops.linalg import chol_blocked, chol_reg, cho_solve_inv, sym, tri_inv
from ..ops.nt_scaling import nt_scale
from ..ops.schur import Aadj, Aop, lp_weight, schur_group, schur_lp

__all__ = ["profile_phases", "format_phases"]


def _timed(fn, *args, repeats: int = 5) -> float:
    fn_j = jax.jit(fn)
    jax.block_until_ready(fn_j(*args))  # compile
    best = float("inf")
    for _ in range(2):  # two passes; take the better (host timing noise)
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = fn_j(*args)
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / repeats)
    return best


def profile_phases(
    problem, options: Optional[dict] = None, repeats: int = 5, iters: int = 3
) -> Dict[str, float]:
    """Time each IPM phase standalone at a representative iterate (reached by
    ``iters`` warm-up steps). Returns {phase name: seconds}. The 'full fused
    step' row is the ground truth; phase rows attribute it (standalone jits
    lose some fusion, so their sum can exceed the fused time)."""
    from ..ipm.initial import initial_point
    from ..ipm.step import build_step, jitted_step

    opts = Options.from_dict(options) if not isinstance(options, Options) else options
    opts = opts.validated()
    st = initial_point(problem, opts)
    step = jitted_step(opts, opts.preconditioner if opts.kit else -1)
    tol = jnp.asarray(opts.tol_cg, dtype=problem.b.dtype)
    for _ in range(iters):
        st, _stats = step(problem, st, tol)
    jax.block_until_ready(st)
    out: Dict[str, float] = {}

    def all_nt(X, S):
        return tuple(
            nt_scale(x, s, method=opts.nt_method, eigh_backend=opts.eigh_backend,
                     chol_backend=opts.chol_backend)
            for x, s in zip(X, S)
        )

    out["prepare_W (NT scaling)"] = _timed(all_nt, st.X, st.S, repeats=repeats)
    nts = jax.jit(all_nt)(st.X, st.S)

    def resid(X, y):
        Rp = problem.b
        for g, Xg in zip(problem.groups, X):
            Rp = Rp - Aop(g, Xg)
        Rds = tuple(sym(g.C - S - Aadj(g, y)) for g, S in zip(problem.groups, st.S))
        h = Rp
        for g, nt, Rd, S in zip(problem.groups, nts, Rds, st.S):
            h = h + Aop(g, nt.W @ (Rd + S) @ nt.W)
        return Rp, Rds, h

    out["residuals + RHS (makeRHS)"] = _timed(resid, st.X, st.y, repeats=repeats)
    Rp, Rds, h = jax.jit(resid)(st.X, st.y)

    if opts.kit == 0:
        def schur(nts):
            H = jnp.zeros((problem.n, problem.n), dtype=problem.b.dtype)
            for g, nt in zip(problem.groups, nts):
                H = H + schur_group(g, nt.W, nt.G)
            if problem.nlin:
                H = H + schur_lp(problem.C_lin, lp_weight(st.X_lin, 1.0 / st.S_lin))
            return sym(H)

        out["Schur assembly (BBBB)"] = _timed(schur, nts, repeats=repeats)
        H = jax.jit(schur)(nts)

        def hchol(H):
            hc = chol_reg(H, 1e-4, 1000, backend=opts.chol_backend)
            return tri_inv(hc.L)

        out["H Cholesky + tri_inv"] = _timed(hchol, H, repeats=repeats)
        Li = jax.jit(hchol)(H)

        def solve4(Li, h):
            x = h
            for _ in range(4):
                x = cho_solve_inv(Li, x)
            return x

        out["4x triangular solves (GEMV)"] = _timed(solve4, Li, h, repeats=repeats)
    else:
        # kit=1 phases: materialized Schur operator + H_alpha prep + the
        # CG solve, exactly as the step's small-n route dispatches
        # them (`ipm/step.py` mat_cg branch)
        from ..ops.precond import prep_alpha
        from ..ops.schur import lp_weight as _lpw

        mat_cg = opts.cg_materialize == "always" or (
            opts.cg_materialize == "auto" and problem.n <= 512
        )
        lpw = (
            _lpw(st.X_lin, 1.0 / st.S_lin) if problem.nlin else None
        )

        def hcg(nts):
            H = jnp.zeros((problem.n, problem.n), dtype=problem.b.dtype)
            for g, nt in zip(problem.groups, nts):
                H = H + schur_group(g, nt.W, nt.G)
            if problem.nlin:
                H = H + schur_lp(problem.C_lin, lpw)
            return sym(H)

        if mat_cg:
            out["Schur materialize (CG operator)"] = _timed(
                hcg, nts, repeats=repeats
            )
            Hcg = jax.jit(hcg)(nts)
        if opts.preconditioner in (1, 4):
            def palpha(nts):
                pa = prep_alpha(
                    problem, nts, lpw, opts.erank, opts.aamat,
                    opts.eigh_backend, materialize=mat_cg,
                )
                return pa.Mli if mat_cg else pa.diag_scalar

            out["precond prep (H_alpha)"] = _timed(palpha, nts, repeats=repeats)
        if mat_cg and opts.preconditioner == 1:
            from ..ops.cg import cg_plain

            pa = jax.jit(
                lambda nts: prep_alpha(problem, nts, lpw, opts.erank, opts.aamat,
                                       opts.eigh_backend, materialize=True)
            )(nts)

            def cgsolve(Hcg, Mli, rhs):
                # the step's split-preconditioned f64 CG (ipm/step.py)
                MliT = jnp.swapaxes(Mli, -1, -2)
                Hp = sym(Mli @ Hcg @ MliT)
                u, _ = cg_plain(lambda v: Hp @ v, Mli @ rhs, 1e-7,
                                opts.cg_maxiter)
                return MliT @ u

            out["CG solve (f64 split-preconditioned, tol 1e-7)"] = _timed(
                cgsolve, Hcg, pa.Mli, h, repeats=repeats
            )

    # steplength phase: the scaled-direction spectral computation, exactly as
    # the step's eigmin path sees it (find_step_A..D): one batched lambda_min
    # of the stacked [scaleX; scaleS] directions
    from ..ipm.step import steplength_eigmin

    eigmin_fn = steplength_eigmin(opts)
    for gi, (g, nt, X) in enumerate(zip(problem.groups, nts, st.X)):
        delS = Rds[gi]  # representative direction-magnitude matrix
        GT = jnp.swapaxes(nt.G, -1, -2)

        def steplen(delS, nt=nt, GT=GT):
            delSb = GT @ delS @ nt.G
            scaleS = sym(nt.DDsi[:, :, None] * delSb * nt.DDsi[:, None, :])
            return eigmin_fn(jnp.concatenate([scaleS, scaleS], axis=0))

        out[f"find_step spectral, group{gi} (predictor)"] = _timed(
            steplen, delS, repeats=repeats
        )

    # DIMACS errors (check_convergence)
    def dimacs(X, S, y):
        err = jnp.zeros((), dtype=problem.b.dtype)
        for g, Xg, Sg in zip(problem.groups, X, S):
            L = chol_blocked(jnp.concatenate([Xg, Sg], axis=0))
            err = err + jnp.sum(jnp.isnan(L).astype(problem.b.dtype))
            err = err + jnp.sum(jnp.einsum("bpq,bpq->b", Sg, Xg))
            err = err + jnp.sum(jnp.sqrt(jnp.sum((g.C - Sg) ** 2, axis=(-1, -2))))
        return err + jnp.dot(problem.b, y)

    out["DIMACS errors (check_convergence)"] = _timed(
        dimacs, st.X, st.S, st.y, repeats=repeats
    )

    t0 = time.perf_counter()
    for _ in range(repeats):
        res = step(problem, st, tol)
    jax.block_until_ready(res)
    out["full fused step"] = (time.perf_counter() - t0) / repeats
    return out


def format_phases(times: Dict[str, float]) -> str:
    """Render the phase table (the reference prints a TimerOutputs tree when
    timing > 0; this is the equivalent surface)."""
    total = times.get("full fused step", None)
    width = max(len(k) for k in times)
    lines = [" per-phase device times (standalone jits; 'full fused step' is ground truth)"]
    for k, v in times.items():
        pct = f" {100.0 * v / total:5.1f}%" if total and k != "full fused step" else ""
        lines.append(f"   {k:<{width}} {v * 1e3:9.2f} ms{pct}")
    return "\n".join(lines)
