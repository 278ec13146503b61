"""One predictor-corrector IPM iteration as a single jitted function.

Covers the reference's `myIPstep` (`src/Solvers.jl:448-478`) plus
`check_convergence` (`:496-568`): NT scaling, predictor (direct Schur
assembly + Cholesky, or matrix-free PCG with H_alpha/H_beta), Mehrotra
sigma update, corrector, steplengths via batched eigenvalue bounds, iterate
update, and the six DIMACS errors. All per-block loops of the reference are
batched ops over stacked block groups; the outer Python loop over *groups*
(few, distinct padded sizes) unrolls at trace time.

Convergence-error convention preserved from the reference: err1/err3 use the
residuals computed at the *start* of the iteration (pre-update iterate) while
err2/4/5/6 use the updated iterate — this keeps iteration counts comparable.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import Options
from ..problem import SDPProblem
from ..ops.cg import cg_plain, pcg
from ..ops.dd import (
    DD, dd_add, dd_mul_f64, dd_neg, dd_sum, dd_to_f64, two_prod, two_sum,
)
from ..config import backend_table
from ..ops.eigh import eigh_backend_for, eigh_jacobi, eigh_mixed, eigmin_lanczos
from ..ops.linalg import (
    btrace,
    chol_reg,
    cho_solve_inv,
    eigmin,
    eigmin_chol,
    sym,
    tri_inv,
)
from ..ops.dd_linalg import dd_const, dd_div, dd_mul
from ..ops.nt_scaling import NTScaling, NTTails, nt_scale, nt_scale_dd
from ..ops.ozaki import acc_matmul, acc_matvec
from ..ops.precond import prep_alpha, prep_beta
from ..ops.schur import (
    Aadj,
    Aadj_dd,
    Aop,
    Aop_dd,
    lp_weight,
    schur_group,
    schur_group_dd,
    schur_group_mixed,
    schur_lp,
    schur_lp_dd,
    schur_lp_mixed,
)
from .initial import EXPON, TAU
from .state import IPMState, StepStats

__all__ = ["build_step", "jitted_step", "build_chunk", "jitted_chunk", "ChunkResult"]

_STEP_EPS = -1e-6  # "essentially feasible direction" threshold


def _steplen(ev: jax.Array) -> jax.Array:
    """alpha = 0.99 if lambda_min > -1e-6 else min(1, -tau/lambda_min)
    (`src/predictor_corrector.jl:274-291`)."""
    return jnp.where(ev > _STEP_EPS, 0.99, jnp.minimum(1.0, -TAU / ev))


def _safe_pow(base: jax.Array, expo: jax.Array) -> jax.Array:
    b = jnp.maximum(base, 1e-300)
    return jnp.exp(expo * jnp.log(b))


# ---- double-double helpers (precision='dd' mode; ops/dd.py, ops/ozaki.py)


def _dd0(x: jax.Array) -> DD:
    return DD(x, jnp.zeros_like(x))


def _sandwich_dd(L: jax.Array, M: jax.Array, R: jax.Array) -> DD:
    """L M R in dd for batched [nb, m, m] operands (Ozaki GEMMs + lo-part
    f64 correction)."""
    T1 = acc_matmul(L, M)
    T = acc_matmul(T1.hi, R)
    s = two_sum(T.hi, T1.lo @ R)
    return DD(s.hi, s.lo + T.lo)


def _trace_dot_dd(A: jax.Array, B: jax.Array) -> DD:
    """sum over all entries of A * B in dd (batched trace inner product)."""
    p = two_prod(A.reshape(-1), B.reshape(-1))
    return dd_sum(p)


def _dd_dot(a: jax.Array, b: jax.Array) -> DD:
    return dd_sum(two_prod(a, b))


class _GroupDirs(NamedTuple):
    delX: jax.Array
    delS: jax.Array
    alpha: jax.Array  # [nb]
    beta: jax.Array  # [nb]
    delX_lo: Optional[jax.Array] = None  # dd2: direction tails
    delS_lo: Optional[jax.Array] = None


def _group_dirs(
    g,
    nt: NTScaling,
    Rd: jax.Array,
    X: jax.Array,
    dely: jax.Array,
    *,
    predict: bool,
    sig_mu: Optional[jax.Array] = None,
    RNT: Optional[jax.Array] = None,
    eigmin_fn=eigmin,
    dd_mode: bool = False,
    T_dd=None,
    U_dd=None,
    Rd_dd=None,  # dd2: dual residual as a DD pair (keeps delS dd-exact)
    tail: Optional[NTTails] = None,  # dd NT scaling: W low words
) -> _GroupDirs:
    """Directions and per-block steplengths (`find_step`,
    `src/predictor_corrector.jl:248-293`).

    In dd mode ``dely`` is a DD pair (see solve2): the lo part's sandwich
    contribution keeps A(delX) = Rp exact past the f64 resolution of dely.
    In dd2 mode (``Rd_dd`` given) delS and delX are RETURNED as DD pairs so
    the iterate updates stay at dd resolution. With ``tail`` (native dd NT,
    nt_precision='dd') the W sandwich carries the W_lo first-order terms —
    the SAME terms the Schur assembly folded in, so solve-refinement
    consistency is preserved.
    """
    dd2 = Rd_dd is not None
    if dd_mode:
        dely, dely_lo = dely.hi, dely.lo
    GT = jnp.swapaxes(nt.G, -1, -2)
    delS = Rd - Aadj(g, dely)
    adj = None
    if dd2:
        adj = Aadj_dd(g, DD(dely, dely_lo))
        delS_dd = dd_add(Rd_dd, dd_neg(adj))
        delS_dd = DD(sym(delS_dd.hi), sym(delS_dd.lo))
        delS = delS_dd.hi
    if dd_mode:
        # Feasibility-exact dd directions. The Newton identity
        # A(delX) = Rp needs W S W == X and S^-1 == G D^-1 G^T EXACTLY;
        # in f64 they hold only to u*||W||^2 (||W|| ~ mu^-1/2 near
        # convergence) — THE f64 DIMACS-floor driver. Using the SAME
        # computed T = W(Rd+S)W (and corrector U = G[sig*mu/D + RNT]G^T)
        # in both the RHS and the direction makes the cancellation exact
        # by construction:  delX = -T + W Aadj(dely) W (+ U).
        if adj is not None:
            # dd2: reuse the dd adjoint computed for delS (its hi is the
            # correctly-rounded dd leading word, tighter than the plain
            # f64 einsum)
            WAW = _sandwich_dd(nt.W, adj.hi, nt.W)
            wlo = nt.W @ adj.lo @ nt.W
            if tail is not None:
                wlo = wlo + tail.W_lo @ (adj.hi @ nt.W) + (nt.W @ adj.hi) @ tail.W_lo
            WAW = DD(WAW.hi, WAW.lo + wlo)
        else:
            WAW = _sandwich_dd(nt.W, Aadj(g, dely), nt.W)
            WAW = DD(WAW.hi, WAW.lo + nt.W @ Aadj(g, dely_lo) @ nt.W)
        acc = dd_add(dd_neg(T_dd), WAW)
        if not predict:
            acc = dd_add(acc, U_dd)
        if dd2:
            delX_dd = DD(sym(acc.hi), sym(acc.lo))
            delX = delX_dd.hi
        else:
            delX = sym(dd_to_f64(acc))
    else:
        Xi = nt.W @ delS @ nt.W
        if predict:
            delX = sym(-X - Xi)
        else:
            delX = sym(sig_mu * nt.Si - X - Xi + nt.G @ RNT @ GT)

    delSb = GT @ delS @ nt.G
    scaleS = sym(nt.DDsi[:, :, None] * delSb * nt.DDsi[:, None, :])
    delXb = nt.Gi @ delX @ jnp.swapaxes(nt.Gi, -1, -2)
    scaleX = sym(nt.DDsi[:, :, None] * delXb * nt.DDsi[:, None, :])
    # one batched eigendecomposition for both steplengths (latency win)
    nb = scaleX.shape[0]
    ev = eigmin_fn(jnp.concatenate([scaleX, scaleS], axis=0))
    alpha = _steplen(ev[:nb])
    beta = _steplen(ev[nb:])
    if dd2:
        return _GroupDirs(delX=delX, delS=delS, alpha=alpha, beta=beta,
                          delX_lo=delX_dd.lo, delS_lo=delS_dd.lo)
    return _GroupDirs(delX=delX, delS=delS, alpha=alpha, beta=beta)


class _LinDirs(NamedTuple):
    delX: jax.Array
    delS: jax.Array
    alpha: jax.Array
    beta: jax.Array


def _lin_dirs(
    problem,
    st: IPMState,
    Si_lin: jax.Array,
    Rd_lin: jax.Array,
    dely: jax.Array,
    *,
    predict: bool,
    sig_mu: Optional[jax.Array] = None,
    RNT_lin: Optional[jax.Array] = None,
) -> _LinDirs:
    """LP-cone directions and steplengths (`find_step_lin`,
    `src/predictor_corrector.jl:329-347`)."""
    delS = Rd_lin - problem.C_lin.T @ dely
    delX = -st.X_lin - st.X_lin * Si_lin * delS
    if not predict:
        delX = delX + sig_mu * Si_lin + RNT_lin
    mX = jnp.min(delX / st.X_lin)
    mS = jnp.min(delS / st.S_lin)
    return _LinDirs(delX=delX, delS=delS, alpha=_steplen(mX), beta=_steplen(mS))


class _LinDirsDD(NamedTuple):
    delX: DD
    delS: DD
    alpha: jax.Array
    beta: jax.Array


def _cmatvec_dd(M: jax.Array, v: DD) -> DD:
    """M @ v for a dd vector: Ozaki-exact on the hi word, plain f64 on the
    lo correction."""
    r = acc_matvec(M, v.hi)
    s = two_sum(r.hi, M @ v.lo)
    return DD(s.hi, s.lo + r.lo)


def _lin_dirs_dd(
    problem,
    Xl: DD,
    Sl: DD,
    lpw: DD,
    Rd_lin: DD,
    dely: DD,
    *,
    predict: bool,
    U_lin: Optional[DD] = None,
) -> _LinDirsDD:
    """LP-cone directions at dd resolution (dd2 tier; `find_step_lin`,
    `src/predictor_corrector.jl:329-364` with `T = Float64x4`,
    `src/Solvers.jl:18`).

    ``U_lin`` is the corrector centrality term sig_mu*Si + RNT_lin,
    computed ONCE by the caller and reused verbatim in the RHS (as its
    negation inside `tmp`) — the same feasibility-exact construction as
    the SDP blocks' T/U sandwiches."""
    adj = _cmatvec_dd(problem.C_lin.T, dely)
    delS = dd_add(Rd_lin, dd_neg(adj))
    # delX = -X - lpw*delS (+ U_lin on the corrector); lpw = X/S in dd
    delX = dd_neg(dd_add(Xl, dd_mul(lpw, delS)))
    if not predict:
        delX = dd_add(delX, U_lin)
    mX = jnp.min(delX.hi / Xl.hi)
    mS = jnp.min(delS.hi / Sl.hi)
    return _LinDirsDD(delX=delX, delS=delS, alpha=_steplen(mX), beta=_steplen(mS))


def steplength_eigmin(opts: Options):
    """lambda_min (or a lower bound on it) of a batch [nb, m, m], by the
    resolved ``step_eig`` / ``eigh_backend`` options — the steplength
    spectra of `find_step` (`src/predictor_corrector.jl:274-291`)."""
    mode = opts.step_eig
    if mode == "chol":
        return eigmin_chol
    if mode == "lanczos":
        return eigmin_lanczos
    if mode != "exact":
        raise ValueError(
            f"step_eig {mode!r} is not a resolved choice; resolve 'auto' "
            "with Options.validated()"
        )

    def exact(M):
        resolved = eigh_backend_for(opts.eigh_backend, M.shape[-1])
        if resolved == "jacobi":
            # lambda_min needs ~1e-9 relative, reached in 7 sweeps (full
            # eigenvector accuracy needs the default count) — halves the
            # dominant sequential-rounds cost of the steplength phase
            return eigh_jacobi(M, sweeps=7)[0][..., 0]
        if resolved == "mixed":
            return eigh_mixed(M, refine_iters=1)[0][..., 0]
        return eigmin(M)

    return exact


def build_step(opts: Options, precond_kind: int, mesh=None,
               mixed_assembly: bool = False):
    """Return step(problem, state, tol_cg) -> (new_state, StepStats).

    ``opts`` and ``precond_kind`` are static (the hybrid 4 -> 1 switch of
    `src/Solvers.jl:339-347` rebuilds the step once at the switch).

    ``mixed_assembly``: assemble the Schur matrix with the f32 fast path
    (ops/schur.py schur_group_mixed) — the early-iteration phase of
    assembly_precision='f32'; the host loop rebuilds with False once
    DIMACS < 1e-3 (ipm/solver.py). Everything else (residuals, NT,
    directions, errors) stays exact f64, so the reported DIMACS remains
    trustworthy while mixed.

    ``mesh``: when the problem data is sharded over a ('blocks', 'schur')
    mesh, anchor the CG vectors to the schur (constraint) axis so GSPMD
    keeps the data-operator contractions shard-local — without the
    constraint the replicated CG carries make XLA all-gather the [n, m, m]
    data stack on EVERY CG iteration (measured 20x step blow-up at n=2048).
    This is the distributed Schur solve: H is never formed, each matvec
    psums only [nb, m, m] partials over the schur axis.
    """
    kit = opts.kit
    schur_sharded = (
        mesh is not None
        and "schur" in getattr(mesh, "axis_names", ())
        and dict(getattr(mesh, "shape", {})).get("schur", 1) > 1
    )

    def _on_schur(x):
        if not schur_sharded:
            return x
        from jax.sharding import NamedSharding, PartitionSpec

        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, PartitionSpec("schur"))
        )

    # row-sharding for [n, n] Schur-sized matrices: with it, chol_blocked /
    # tri_inv become the DISTRIBUTED factorization (panel chol replicated,
    # all O(n^3) GEMM work shard-local; see ops/linalg.py) — replacing the
    # round-2 all-gather + replicated Cholesky (SURVEY section 7 hard part
    # "Distributed Cholesky vs CG")
    if schur_sharded:
        from jax.sharding import NamedSharding, PartitionSpec

        def _row_shard(x):
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, PartitionSpec("schur", None))
            )
    else:
        _row_shard = None
    # high-precision mode: Schur assembly, RHS contractions, and the Schur
    # solve's iterative refinement run in double-double — the stand-in for
    # MultiFloats Float64xN. It applies to BOTH linear-system paths: the
    # direct route factors in f64 and refines with dd residuals; the CG
    # route (kit=1) wraps PCG in dd iterative refinement (solve_cg_dd) — the
    # equivalent of the reference's Float64xN-typed CG
    dd_mode = opts.precision in ("dd", "dd2")
    # dd2: the x4-class tier — in addition to dd assembly/solves, the
    # ITERATES (X, S, y) are stored as double-double pairs and every
    # residual/update runs on the pairs, so the DIMACS floor is no longer
    # pinned by u64 * ||iterate|| storage rounding (the reference reaches
    # this regime by instantiating MySolver{Float64x4},
    # `src/Solvers.jl:18`, `README.md:37-54`). The NT scaling still
    # computes from the f64 hi parts — its breakdown at mu ~ u64-resolution
    # of X's spectrum is the tier's measured floor (docs/precision.md).
    dd2 = opts.precision == "dd2"
    # native dd NT scaling (nt_precision): the dd2 tier's fix for the
    # measured f64 NT wall — chol(X), the congruence L_x' S L_x, and its
    # Jacobi eigendecomposition run on dd pairs (ops/dd_linalg.py), so the
    # congruent spectrum (~mu) survives below the f64 formation noise.
    # Reference equivalent: `prepare_W` at T = Float64x4
    # (`src/prepare_W.jl:41-45`, `src/Solvers.jl:18`). Options.validated()
    # resolves 'auto' per platform (config.AUTO_BACKENDS).
    nt_dd = dd2 and opts.nt_precision == "dd"
    eigmin_fn = steplength_eigmin(opts)

    # err2/err4 strategy. In normal operation the iterates are strictly
    # feasible BY CONSTRUCTION: steplengths come from lower bounds on the
    # scaled-direction spectra (exact eigenvalues, Cholesky bisection, or
    # the Cholesky-certified Lanczos bound), so X + alpha*delX =
    # G_x(D^(1/2)(I + alpha * scaleX)D^(1/2))G_x^T stays PD whenever
    # alpha*|lambda_min bound| <= tau < 1 — the same rounding class at which
    # the reference's eigmin-based err2/err4 report ~0
    # (`src/Solvers.jl:498-524`). The violations are therefore zero without
    # any PD probe (saving a batched f64 Cholesky per iteration). The
    # certificate breaks down exactly when the NT scaling itself was
    # regularized (chol shifts / congruent spectrum of S non-positive) —
    # there, report the Gershgorin violation magnitude of the updated
    # iterate (O(m^2), and honest about the breakdown: can overstate, never
    # understate... it is a lower bound on lambda_min).

    def psd_violation(M, suspect):
        """max(0, -gershgorin lower bound) per batch element where
        ``suspect``, else 0."""
        diag = jnp.diagonal(M, axis1=-2, axis2=-1)
        gersh = jnp.min(diag - (jnp.sum(jnp.abs(M), axis=-1) - jnp.abs(diag)), axis=-1)
        return jnp.where(suspect, jnp.maximum(0.0, -gersh), 0.0)

    def step(problem: SDPProblem, st: IPMState, tol_cg: jax.Array):
        dtype = problem.b.dtype
        nlin = problem.nlin
        nlmi = problem.nlmi
        ngroups = len(problem.groups)
        denom = problem.sum_msizes + nlin
        one = jnp.ones((), dtype=dtype)

        # dd2: iterates as DD pairs (hi = st.X etc, lo = the stored tails)
        if dd2:
            X_dds = tuple(DD(X, Xl) for X, Xl in zip(st.X, st.X_lo))
            S_dds = tuple(DD(S, Sl) for S, Sl in zip(st.S, st.S_lo))
            y_dd = DD(st.y, st.y_lo)
            Xl_dd = DD(st.X_lin, st.X_lin_lo) if nlin else None
            Sl_dd = DD(st.S_lin, st.S_lin_lo) if nlin else None
        else:
            X_dds = S_dds = (None,) * ngroups
            y_dd = Xl_dd = Sl_dd = None

        # ---- mu (`find_mu`, src/Solvers.jl:480-494)
        if dd2:
            # <X, S> in dd: near the dd2 floor the products are O(1) with
            # ~20-digit cancellation — an f64 trace would report mu ~ 1e-16
            # noise instead of the true barrier value
            tr_dd = DD(jnp.zeros((), dtype=dtype), jnp.zeros((), dtype=dtype))
            for Xd, Sd in zip(X_dds, S_dds):
                t = _trace_dot_dd(Xd.hi, Sd.hi)
                cross = jnp.sum(Xd.hi * Sd.lo) + jnp.sum(Xd.lo * Sd.hi)
                s2 = two_sum(t.hi, cross)
                tr_dd = dd_add(tr_dd, DD(s2.hi, s2.lo + t.lo))
            if nlin:
                t = _dd_dot(Xl_dd.hi, Sl_dd.hi)
                cross = jnp.dot(Xl_dd.hi, Sl_dd.lo) + jnp.dot(Xl_dd.lo, Sl_dd.hi)
                s2 = two_sum(t.hi, cross)
                tr_dd = dd_add(tr_dd, DD(s2.hi, s2.lo + t.lo))
            mu = dd_to_f64(tr_dd) / denom
        else:
            tr = jnp.zeros((), dtype=dtype)
            for X, S in zip(st.X, st.S):
                tr = tr + btrace(X, S)
            if nlin:
                tr = tr + jnp.dot(st.X_lin, st.S_lin)
            mu = tr / denom

        # ---- NT scaling (prepare_W)
        if nt_dd:
            nt_pairs = tuple(
                nt_scale_dd(Xd, Sd, eigh_backend=opts.eigh_backend)
                for Xd, Sd in zip(X_dds, S_dds)
            )
            nts = tuple(p[0] for p in nt_pairs)
            nt_tails = tuple(p[1] for p in nt_pairs)
        else:
            nts = tuple(
                nt_scale(X, S, method=opts.nt_method,
                         eigh_backend=opts.eigh_backend,
                         chol_backend=opts.chol_backend)
                for X, S in zip(st.X, st.S)
            )
            nt_tails = (None,) * ngroups
        nt_ok = one.astype(bool)
        nt_suspect = jnp.zeros((), dtype=bool)  # feasibility cert broken
        for nt in nts:
            nt_ok = jnp.logical_and(nt_ok, nt.ok)
            nt_suspect = nt_suspect | nt.shifted | nt.s_indef
        if nlin and dd2:
            # LP scaling quantities at dd resolution: Si = 1/S and
            # lpw = X/S drive the LP Schur block and the lin directions;
            # their f64 rounding (u64 * ||lpw||, ||lpw|| ~ 1/mu on the
            # active set) would pin the LP residuals exactly like the
            # matrix blocks' f64 W did
            Si_lin_dd = dd_div(dd_const(1.0, st.S_lin), Sl_dd)
            lpw_dd = dd_mul(Xl_dd, Si_lin_dd)
            Si_lin, lpw = Si_lin_dd.hi, lpw_dd.hi
        else:
            Si_lin_dd = lpw_dd = None
            Si_lin = (1.0 / st.S_lin) if nlin else None
            lpw = lp_weight(st.X_lin, Si_lin) if nlin else None

        # ---- residuals (`predictor`, src/predictor_corrector.jl:8-22)
        if dd_mode:
            Rp_dd = _dd0(problem.b)
            for g, X, Xd in zip(problem.groups, st.X, X_dds):
                Rp_dd = dd_add(
                    Rp_dd,
                    dd_neg(Aop_dd(g, X, Xd.lo if dd2 else None)),
                )
            if nlin:
                if dd2:
                    lin = _cmatvec_dd(problem.C_lin, Xl_dd)
                else:
                    lin = acc_matvec(problem.C_lin, st.X_lin)
                Rp_dd = dd_add(Rp_dd, dd_neg(lin))
            Rp = dd_to_f64(Rp_dd)
        else:
            Rp = problem.b
            for g, X in zip(problem.groups, st.X):
                Rp = Rp - Aop(g, X)
            if nlin:
                Rp = Rp - problem.C_lin @ st.X_lin
        if dd2:
            # Rd = C - S - Aadj(y) at dd resolution: near the dd2 floor the
            # f64 evaluation rounds at u64 * ||C||, which would pin err3
            Rd_dds = []
            for g, Sd in zip(problem.groups, S_dds):
                adj = Aadj_dd(g, y_dd)
                t = two_sum(g.C, -Sd.hi)
                acc = dd_add(DD(t.hi, t.lo - Sd.lo), dd_neg(adj))
                Rd_dds.append(DD(sym(acc.hi), sym(acc.lo)))
            Rd_dds = tuple(Rd_dds)
            Rds = tuple(r.hi for r in Rd_dds)
        else:
            Rd_dds = (None,) * ngroups
            Rds = tuple(
                sym(g.C - S - Aadj(g, st.y)) for g, S in zip(problem.groups, st.S)
            )
        if nlin and dd2:
            # Rd_lin = d - S - C_lin' y at dd resolution (TwoSum chain +
            # dd-exact adjoint, like the matrix blocks' Rd)
            adj_l = _cmatvec_dd(problem.C_lin.T, y_dd)
            t = two_sum(problem.d_lin, -Sl_dd.hi)
            Rd_lin_dd = dd_add(DD(t.hi, t.lo - Sl_dd.lo), dd_neg(adj_l))
            Rd_lin = Rd_lin_dd.hi
        else:
            Rd_lin_dd = None
            Rd_lin = (problem.d_lin - st.S_lin - problem.C_lin.T @ st.y) if nlin else None

        # ---- predictor RHS (`makeRHS`, src/makeBBBB.jl:221-228)
        if dd_mode:
            # T = W (Rd + S) W per group, in dd — reused VERBATIM in the
            # direction formula so the feasibility identity cancels exactly.
            # dd2: Rd + S carries a dd tail; its W-sandwich enters T.lo
            if dd2:
                T_dds = []
                for nt, tail, Rdd, Sd in zip(nts, nt_tails, Rd_dds, S_dds):
                    M_dd = dd_add(Rdd, Sd)
                    T = _sandwich_dd(nt.W, M_dd.hi, nt.W)
                    tlo = nt.W @ M_dd.lo @ nt.W
                    if tail is not None:
                        # W-tail first-order terms (native dd NT): keep T
                        # consistent with the tailed W of the directions
                        tlo = tlo + tail.W_lo @ (M_dd.hi @ nt.W) \
                            + (nt.W @ M_dd.hi) @ tail.W_lo
                    T_dds.append(DD(T.hi, T.lo + tlo))
                T_dds = tuple(T_dds)
            else:
                T_dds = tuple(
                    _sandwich_dd(nt.W, Rd + S, nt.W)
                    for nt, Rd, S in zip(nts, Rds, st.S)
                )
            h_dd = Rp_dd
            for g, T in zip(problem.groups, T_dds):
                h_dd = dd_add(h_dd, Aop_dd(g, T.hi, T.lo))
            if nlin:
                if dd2:
                    v = dd_add(dd_mul(lpw_dd, Rd_lin_dd), Xl_dd)
                    h_dd = dd_add(h_dd, _cmatvec_dd(problem.C_lin, v))
                else:
                    h_dd = dd_add(
                        h_dd, acc_matvec(problem.C_lin, lpw * Rd_lin + st.X_lin)
                    )
            h = dd_to_f64(h_dd)
        else:
            T_dds = (None,) * ngroups
            h = Rp
            for g, nt, Rd, S in zip(problem.groups, nts, Rds, st.S):
                h = h + Aop(g, nt.W @ (Rd + S) @ nt.W)
            if nlin:
                h = h + problem.C_lin @ (lpw * Rd_lin + st.X_lin)

        # ---- predictor solve
        h_shifts = jnp.int32(0)
        h_ok = one.astype(bool)
        cg_pre = jnp.int32(0)
        cg_cor = jnp.int32(0)
        if kit == 0:
            if dd_mode:
                zero_n = jnp.zeros((problem.n, problem.n), dtype=dtype)
                H_dd = DD(zero_n, zero_n)
                for g, nt, tail in zip(problem.groups, nts, nt_tails):
                    H_dd = dd_add(H_dd, schur_group_dd(
                        g, nt.W, nt.G,
                        W_lo=None if tail is None else tail.W_lo,
                        G_lo=None if tail is None else tail.G_lo,
                    ))
                if nlin:
                    if dd2:
                        H_dd = dd_add(H_dd, schur_lp_dd(problem.C_lin, lpw_dd))
                    else:
                        H_dd = dd_add(H_dd, _dd0(schur_lp(problem.C_lin, lpw)))
                Hs_dd = DD(sym(H_dd.hi), sym(H_dd.lo))
                Hs = Hs_dd.hi
            else:
                H = jnp.zeros((problem.n, problem.n), dtype=dtype)
                for g, nt in zip(problem.groups, nts):
                    if mixed_assembly:
                        H = H + schur_group_mixed(g, nt.W, nt.G)
                    else:
                        H = H + schur_group(g, nt.W, nt.G, opts.gemm_backend)
                if nlin:
                    H = H + (schur_lp_mixed(problem.C_lin, lpw)
                             if mixed_assembly else schur_lp(problem.C_lin, lpw))
                Hs = sym(H)
            # absolute 1e-4 shift, reference semantics
            # (`src/predictor_corrector.jl:74`). Relative (diag-scaled)
            # variants were measured WORSE on badly-scaled problems (tru9:
            # stall at 1.4e-7 with 1e-4 absolute vs 4e-6 with a clamped
            # relative shift); sub-f64 floors are precision='dd' territory.
            if _row_shard is not None:
                Hs = _row_shard(Hs)
            hc = chol_reg(Hs, 1e-4, 1000, backend=opts.chol_backend,
                          shard=_row_shard)
            h_shifts, h_ok = hc.shifts, hc.ok
            # explicit inv(L): the 4 sequential single-RHS triangular solves
            # per iteration become GEMVs; iterative refinement (below)
            # absorbs the u*cond-class inversion error (ops/linalg.py:tri_inv)
            Hli = tri_inv(hc.L, shard=_row_shard)

            if dd_mode:
                def solve2(rhs_dd):
                    # mixed-precision iterative refinement: f64 factorization
                    # + double-double residuals -> forward error ~u instead
                    # of u*cond(H) (cond(H) ~ 1/mu^2 near convergence).
                    # The solution is RETURNED in dd: rounding dely to f64
                    # would re-introduce a Schur residual u*||H||*||dely||
                    # into A(delX) = Rp (||H|| grows like 1/mu — the very
                    # term the feasibility-exact construction cancels).
                    x = cho_solve_inv(Hli, rhs_dd.hi)
                    xlo = jnp.zeros_like(x)
                    for _ in range(3):
                        Hx = acc_matvec(Hs_dd.hi, x)
                        s = two_sum(Hx.hi, Hs_dd.lo @ x + Hs_dd.hi @ xlo)
                        Hx = DD(s.hi, s.lo + Hx.lo)
                        r = dd_add(rhs_dd, dd_neg(Hx))
                        d = cho_solve_inv(Hli, dd_to_f64(r))
                        snew = two_sum(x, d)
                        x, xlo = snew.hi, snew.lo + xlo
                    return DD(x, xlo)

                dely = solve2(h_dd)
            else:
                def solve2(rhs):
                    # one step of iterative refinement (the reference carries
                    # this commented out at src/predictor_corrector.jl:98-115);
                    # costs one n^2 matvec and buys ~3 digits near convergence
                    x = cho_solve_inv(Hli, rhs)
                    r = rhs - Hs @ x
                    return x + cho_solve_inv(Hli, r)

                dely = solve2(h)
        else:
            # Small-n regime dispatch: the implicit CG body costs ~15-25
            # small kernels per iteration (per-block W mat(A^T x) W + SMW),
            # which is pure launch latency when n and the blocks are tiny.
            # Materializing the SAME Schur operator (one batched
            # assembly per IPM iteration, the kit=0 einsums) and the SAME
            # H_alpha matrix M = AAAATtau + t t^T (one n x n Cholesky) turns
            # each CG iteration into 3 GEMVs. Operator and preconditioner are
            # unchanged up to rounding — the CG trajectory and iteration
            # counts stay comparable to the implicit route.
            mat_cg = opts.cg_materialize == "always" or (
                opts.cg_materialize == "auto" and problem.n <= 512
            )
            if mat_cg:
                Hcg = jnp.zeros((problem.n, problem.n), dtype=dtype)
                for g, nt in zip(problem.groups, nts):
                    if mixed_assembly:
                        Hcg = Hcg + schur_group_mixed(g, nt.W, nt.G)
                    else:
                        Hcg = Hcg + schur_group(g, nt.W, nt.G, opts.gemm_backend)
                if nlin:
                    Hcg = Hcg + (schur_lp_mixed(problem.C_lin, lpw)
                                 if mixed_assembly else schur_lp(problem.C_lin, lpw))
                Hcg = sym(Hcg)
                matvec = lambda x: Hcg @ x
            else:
                def matvec(x):
                    x = _on_schur(x)
                    r = jnp.zeros_like(x)
                    for g, nt in zip(problem.groups, nts):
                        r = r + Aop(g, nt.W @ Aadj(g, x) @ nt.W)
                    if nlin:
                        r = r + problem.C_lin @ (lpw * (problem.C_lin.T @ x))
                    return _on_schur(r)

            if precond_kind == 0:
                precond = _on_schur
                Mli_mat = None
            elif precond_kind == 1:
                pa = prep_alpha(
                    problem, nts, lpw, opts.erank, opts.aamat,
                    opts.eigh_backend, materialize=mat_cg,
                )
                precond = pa.apply if mat_cg else (
                    lambda x: _on_schur(pa.apply_with(problem, _on_schur(x)))
                )
                Mli_mat = pa.Mli if mat_cg else None
            else:  # 2 or 4 (hybrid starts as beta)
                pb = prep_beta(
                    problem, nts, lpw, opts.erank, opts.aamat, opts.eigh_backend
                )
                precond = lambda x: _on_schur(pb.apply(x))
                # beta is diagonal: its inverse-Cholesky factor is
                # diag(1/sqrt(d)), so the split-preconditioned CG's
                # z = Mli^T Mli r reproduces r / d exactly
                Mli_mat = jnp.diag(1.0 / jnp.sqrt(pb.diag)) if mat_cg else None

            if mat_cg and not dd_mode and Mli_mat is not None:
                # split-preconditioned f64 CG: solve (Mli H Mli^T) u = Mli b,
                # x = Mli^T u — the same Krylov iterates as PCG with
                # M = Mli^T Mli, at 6 ops per CG iteration instead of 9
                # (every op at this size is launch latency)
                MliT = jnp.swapaxes(Mli_mat, -1, -2)
                Hp = sym(Mli_mat @ Hcg @ MliT)

                def solve_cg(rhs):
                    u, it = cg_plain(
                        lambda v: Hp @ v, Mli_mat @ rhs, tol_cg, opts.cg_maxiter
                    )
                    return MliT @ u, it
            else:
                solve_cg = lambda rhs: pcg(
                    matvec, _on_schur(rhs), precond, tol_cg, opts.cg_maxiter
                )
            h = _on_schur(h)
            if dd_mode:
                # dd on the CG path (lifts the round-1 kit=0 restriction;
                # the reference runs its whole CG in Float64xN with an f64
                # tolerance, `src/predictor_corrector.jl:131-134`): PCG in
                # f64 + double-double iterative refinement — the residual
                # of the dd RHS is re-solved with the SAME preconditioner,
                # and the solution is accumulated in dd like the direct
                # path's solve2.
                def matvec_dd(x, xlo):
                    acc = None
                    for g, nt, tail in zip(problem.groups, nts, nt_tails):
                        M = Aadj(g, x)
                        Mlo = Aadj(g, xlo)
                        T = _sandwich_dd(nt.W, M, nt.W)
                        tlo = nt.W @ Mlo @ nt.W
                        if tail is not None:
                            # native dd NT: same W-tail terms as the
                            # direction formulas (operator consistency)
                            tlo = tlo + tail.W_lo @ (M @ nt.W) + (nt.W @ M) @ tail.W_lo
                        T = DD(T.hi, T.lo + tlo)
                        r = Aop_dd(g, T.hi, T.lo)
                        acc = r if acc is None else dd_add(acc, r)
                    if nlin:
                        if dd2:
                            u = _cmatvec_dd(problem.C_lin.T, DD(x, xlo))
                            r = _cmatvec_dd(problem.C_lin, dd_mul(lpw_dd, u))
                        else:
                            u = problem.C_lin.T @ x + problem.C_lin.T @ xlo
                            r = acc_matvec(problem.C_lin, lpw * u)
                        acc = r if acc is None else dd_add(acc, r)
                    return acc

                def solve_cg_dd(rhs_dd):
                    x, it0 = pcg(matvec, rhs_dd.hi, precond, tol_cg,
                                 opts.cg_maxiter)
                    xlo = jnp.zeros_like(x)
                    iters = it0
                    for _ in range(2):
                        r = dd_add(rhs_dd, dd_neg(matvec_dd(x, xlo)))
                        d, itr = pcg(matvec, dd_to_f64(r), precond, tol_cg,
                                     opts.cg_maxiter)
                        iters = iters + itr
                        snew = two_sum(x, d)
                        x, xlo = snew.hi, snew.lo + xlo
                    return DD(x, xlo), iters

                dely, cg_pre = solve_cg_dd(h_dd)
            else:
                dely, cg_pre = solve_cg(h)
            solve2 = None  # corrector re-runs CG with the same preconditioner

        # ---- predictor directions + steplengths
        dirs = tuple(
            _group_dirs(g, nt, Rd, X, dely, predict=True, eigmin_fn=eigmin_fn,
                        dd_mode=dd_mode, T_dd=T, Rd_dd=Rdd, tail=tl)
            for g, nt, Rd, X, T, Rdd, tl in zip(
                problem.groups, nts, Rds, st.X, T_dds, Rd_dds, nt_tails
            )
        )
        if nlin:
            if dd2:
                ld = _lin_dirs_dd(
                    problem, Xl_dd, Sl_dd, lpw_dd, Rd_lin_dd, dely,
                    predict=True,
                )
            else:
                ld = _lin_dirs(
                    problem, st, Si_lin, Rd_lin,
                    dely.hi if dd_mode else dely, predict=True,
                )
            alpha_lin, beta_lin = ld.alpha, ld.beta
        else:
            alpha_lin = beta_lin = one
        alpha_min = alpha_lin
        beta_min = beta_lin
        for d in dirs:
            alpha_min = jnp.minimum(alpha_min, jnp.min(d.alpha))
            beta_min = jnp.minimum(beta_min, jnp.min(d.beta))

        # trial point + NT correction term (`find_step`,
        # src/predictor_corrector.jl:302-310)
        trXnSn_mat = jnp.zeros((), dtype=dtype)
        RNTs = []
        for g, nt, d, X, S, Xd, Sd in zip(
            problem.groups, nts, dirs, st.X, st.S, X_dds, S_dds
        ):
            if dd2:
                # dd trial trace: at mu ~ 1e-18 the f64 product noise
                # (~u64 * ||X|| ||S||) would swamp trXnSn and break the
                # Mehrotra sigma heuristic
                Xn_dd = dd_add(Xd, dd_mul_f64(DD(d.delX, d.delX_lo),
                                              d.alpha[:, None, None]))
                Sn_dd = dd_add(Sd, dd_mul_f64(DD(d.delS, d.delS_lo),
                                              d.beta[:, None, None]))
                t = _trace_dot_dd(Xn_dd.hi, Sn_dd.hi)
                cross = jnp.sum(Xn_dd.hi * Sn_dd.lo) + jnp.sum(Xn_dd.lo * Sn_dd.hi)
                trXnSn_mat = trXnSn_mat + t.hi + (t.lo + cross)
            else:
                Xn = X + d.alpha[:, None, None] * d.delX
                Sn = S + d.beta[:, None, None] * d.delS
                trXnSn_mat = trXnSn_mat + btrace(Xn, Sn)
            deed = nt.D[:, :, None] + nt.D[:, None, :]
            N = nt.Gi @ d.delX @ d.delS @ nt.G
            RNTs.append(-(N + jnp.swapaxes(N, -1, -2)) / deed)
        trXnSn = trXnSn_mat
        if nlin:
            if dd2:
                Xn_l_dd = dd_add(Xl_dd, dd_mul_f64(ld.delX, ld.alpha))
                Sn_l_dd = dd_add(Sl_dd, dd_mul_f64(ld.delS, ld.beta))
                t = _dd_dot(Xn_l_dd.hi, Sn_l_dd.hi)
                cross = jnp.dot(Xn_l_dd.hi, Sn_l_dd.lo) + jnp.dot(
                    Xn_l_dd.lo, Sn_l_dd.hi
                )
                trXnSn = trXnSn + t.hi + (t.lo + cross)
                RNT_lin_dd = dd_neg(
                    dd_mul(dd_mul(ld.delX, ld.delS), Si_lin_dd)
                )
                RNT_lin = RNT_lin_dd.hi
            else:
                Xn_lin = st.X_lin + ld.alpha * ld.delX
                Sn_lin = st.S_lin + ld.beta * ld.delS
                trXnSn = trXnSn + jnp.dot(Xn_lin, Sn_lin)
                RNT_lin = -(ld.delX * ld.delS) * Si_lin
        else:
            RNT_lin = None

        # ---- sigma update (`sigma_update`, src/predictor_corrector.jl:148-179)
        step_pred = jnp.minimum(alpha_min, beta_min)
        expon_used = jnp.where(
            mu > 1e-6,
            jnp.where(
                step_pred < 1.0 / math.sqrt(3.0),
                one,
                jnp.maximum(EXPON, 3.0 * step_pred**2),
            ),
            jnp.maximum(one, jnp.minimum(EXPON * one, 3.0 * step_pred**2)),
        )
        ratio = trXnSn / denom / mu
        # the `sigma = 0.8` fallback tests only the MATRIX trace, not the LP
        # part (`src/predictor_corrector.jl:158-160` calls btrace over LMI
        # blocks only); the ratio uses the combined trace
        sigma = jnp.where(
            trXnSn_mat < 0,
            jnp.asarray(0.8, dtype=dtype),
            jnp.minimum(one, _safe_pow(ratio, expon_used)),
        )
        sig_mu = sigma * mu
        if dd2:
            # centrality target sigma*mu at dd resolution: near the dd2
            # floor the f64 product would round the target exactly where
            # the trajectory needs it (mu below f64 resolution of <X,S>)
            denom_dd = dd_const(float(denom), tr_dd.hi)
            sig_mu_dd = dd_mul_f64(dd_div(tr_dd, denom_dd), sigma)
        else:
            sig_mu_dd = None

        # ---- corrector RHS (`corrector`, src/predictor_corrector.jl:183-192)
        if dd_mode:
            # Algebraically identical to the reference's
            # G[G'RdG + D - sig*mu/D - RNT]G' form via the exact NT
            # identities G D G' = W S W and G D^-1 G' = S^-1; phrased as
            # T - U with U = G[sig*mu/D + RNT]G' so the SAME T and U feed
            # the corrector direction (feasibility-exact, see _group_dirs)
            if nt_dd:
                # centrality target sig_mu/D at dd resolution: with D now
                # dd-accurate, an f64 quotient would re-inject u64-relative
                # noise into the corrector exactly where the trajectory
                # needs it (mu below the f64 resolution of the spectrum)

                def _U_dd(nt, tail, RNT):
                    GT_ = jnp.swapaxes(nt.G, -1, -2)
                    D_dd = DD(nt.D, tail.D_lo)
                    q = dd_div(
                        DD(jnp.broadcast_to(sig_mu_dd.hi, nt.D.shape),
                           jnp.broadcast_to(sig_mu_dd.lo, nt.D.shape)),
                        D_dd,
                    )
                    s = two_sum(_bdiag(q.hi), RNT)
                    inner = DD(s.hi, s.lo + _bdiag(q.lo))
                    U = _sandwich_dd(nt.G, inner.hi, GT_)
                    Ulo = nt.G @ inner.lo @ GT_ \
                        + tail.G_lo @ (inner.hi @ GT_) \
                        + (nt.G @ inner.hi) @ jnp.swapaxes(tail.G_lo, -1, -2)
                    return DD(U.hi, U.lo + Ulo)

                U_dds = tuple(
                    _U_dd(nt, tail, RNT)
                    for nt, tail, RNT in zip(nts, nt_tails, RNTs)
                )
            else:
                U_dds = tuple(
                    _sandwich_dd(
                        nt.G,
                        _bdiag(sig_mu / nt.D) + RNT,
                        jnp.swapaxes(nt.G, -1, -2),
                    )
                    for nt, RNT in zip(nts, RNTs)
                )
            h2_dd = Rp_dd
            for g, T, U in zip(problem.groups, T_dds, U_dds):
                h2_dd = dd_add(h2_dd, Aop_dd(g, T.hi, T.lo))
                neg = dd_neg(Aop_dd(g, U.hi, U.lo))
                h2_dd = dd_add(h2_dd, neg)
            if nlin:
                if dd2:
                    # U_lin = sig_mu*Si + RNT_lin, computed ONCE and reused
                    # verbatim in the corrector direction (feasibility-exact
                    # construction, like the matrix blocks' U sandwich)
                    sgv = DD(
                        jnp.broadcast_to(sig_mu_dd.hi, Si_lin_dd.hi.shape),
                        jnp.broadcast_to(sig_mu_dd.lo, Si_lin_dd.hi.shape),
                    )
                    U_lin_dd = dd_add(dd_mul(sgv, Si_lin_dd), RNT_lin_dd)
                    arg = dd_add(
                        dd_add(dd_mul(lpw_dd, Rd_lin_dd), Xl_dd),
                        dd_neg(U_lin_dd),
                    )
                    h2_dd = dd_add(h2_dd, _cmatvec_dd(problem.C_lin, arg))
                else:
                    tmp = ld.delX * ld.delS * Si_lin - sig_mu * Si_lin
                    h2_dd = dd_add(
                        h2_dd,
                        acc_matvec(problem.C_lin, lpw * Rd_lin + st.X_lin + tmp),
                    )
            if kit == 0:
                dely2 = solve2(h2_dd)
            else:
                dely2, cg_cor = solve_cg_dd(h2_dd)
        else:
            U_dds = (None,) * ngroups
            h2 = Rp
            for g, nt, Rd, RNT in zip(problem.groups, nts, Rds, RNTs):
                GT = jnp.swapaxes(nt.G, -1, -2)
                inner = (
                    GT @ Rd @ nt.G
                    + _bdiag(nt.D)
                    - _bdiag(sig_mu / nt.D)
                    - RNT
                )
                h2 = h2 + Aop(g, nt.G @ inner @ GT)
            if nlin:
                tmp = ld.delX * ld.delS * Si_lin - sig_mu * Si_lin
                h2 = h2 + problem.C_lin @ (lpw * Rd_lin + st.X_lin + tmp)

            if kit == 0:
                dely2 = solve2(h2)
            else:
                dely2, cg_cor = solve_cg(h2)

        # ---- corrector directions + final update
        dirs2 = tuple(
            _group_dirs(
                g, nt, Rd, X, dely2,
                predict=False, sig_mu=sig_mu, RNT=RNT, eigmin_fn=eigmin_fn,
                dd_mode=dd_mode, T_dd=T, U_dd=U, Rd_dd=Rdd, tail=tl,
            )
            for g, nt, Rd, X, RNT, T, U, Rdd, tl in zip(
                problem.groups, nts, Rds, st.X, RNTs, T_dds, U_dds, Rd_dds,
                nt_tails
            )
        )
        if nlin:
            if dd2:
                ld2 = _lin_dirs_dd(
                    problem, Xl_dd, Sl_dd, lpw_dd, Rd_lin_dd, dely2,
                    predict=False, U_lin=U_lin_dd,
                )
            else:
                ld2 = _lin_dirs(
                    problem, st, Si_lin, Rd_lin,
                    dely2.hi if dd_mode else dely2,
                    predict=False, sig_mu=sig_mu, RNT_lin=RNT_lin,
                )
            alpha_lin2, beta_lin2 = ld2.alpha, ld2.beta
        else:
            alpha_lin2 = beta_lin2 = one
        amin = alpha_lin2
        bmin = beta_lin2
        for d in dirs2:
            amin = jnp.minimum(amin, jnp.min(d.alpha))
            bmin = jnp.minimum(bmin, jnp.min(d.beta))

        if dd2:
            # iterate updates at dd resolution — the whole point of the tier
            y_new_dd = dd_add(y_dd, dd_mul_f64(dely2, bmin))
            y_new = y_new_dd.hi
            X_new_dds = tuple(
                dd_add(Xd, dd_mul_f64(DD(d.delX, d.delX_lo), amin))
                for Xd, d in zip(X_dds, dirs2)
            )
            S_new_dds = tuple(
                dd_add(Sd, dd_mul_f64(DD(d.delS, d.delS_lo), bmin))
                for Sd, d in zip(S_dds, dirs2)
            )
            X_new_dds = tuple(DD(sym(x.hi), sym(x.lo)) for x in X_new_dds)
            S_new_dds = tuple(DD(sym(s.hi), sym(s.lo)) for s in S_new_dds)
            X_new = tuple(x.hi for x in X_new_dds)
            S_new = tuple(s.hi for s in S_new_dds)
        else:
            y_new = st.y + bmin * (dd_to_f64(dely2) if dd_mode else dely2)
            X_new = tuple(sym(X + amin * d.delX) for X, d in zip(st.X, dirs2))
            S_new = tuple(sym(S + bmin * d.delS) for S, d in zip(st.S, dirs2))
        if nlin:
            if dd2:
                Xl_new_dd = dd_add(Xl_dd, dd_mul_f64(ld2.delX, amin))
                Sl_new_dd = dd_add(Sl_dd, dd_mul_f64(ld2.delS, bmin))
                X_lin_new, S_lin_new = Xl_new_dd.hi, Sl_new_dd.hi
            else:
                Xl_new_dd = Sl_new_dd = None
                X_lin_new = st.X_lin + amin * ld2.delX
                S_lin_new = st.S_lin + bmin * ld2.delS
        else:
            Xl_new_dd = Sl_new_dd = None
            X_lin_new = S_lin_new = None

        # ---- DIMACS errors (`check_convergence`, src/Solvers.jl:496-524)
        normb = jnp.linalg.norm(problem.b)
        if dd_mode:
            by_dd = _dd_dot(problem.b, y_new)
            if dd2:
                s2 = two_sum(by_dd.hi, jnp.dot(problem.b, y_new_dd.lo))
                by_dd = DD(s2.hi, s2.lo + by_dd.lo)
            by = dd_to_f64(by_dd)
            trCX_dd = DD(jnp.zeros((), dtype=dtype), jnp.zeros((), dtype=dtype))
        else:
            by = jnp.dot(problem.b, y_new)
        err1 = jnp.linalg.norm(Rp) / (1.0 + normb)
        err2 = jnp.zeros((), dtype=dtype)
        err3 = jnp.zeros((), dtype=dtype)
        err4 = jnp.zeros((), dtype=dtype)
        err6 = jnp.zeros((), dtype=dtype)
        trCX = jnp.zeros((), dtype=dtype)
        for gi, (g, X, S, Rd) in enumerate(zip(problem.groups, X_new, S_new, Rds)):
            normC = jnp.sqrt(jnp.sum(g.C**2, axis=(-1, -2)))  # [nb]
            viol = psd_violation(jnp.concatenate([X, S], axis=0), nt_suspect)
            violX, violS = viol[: X.shape[0]], viol[X.shape[0] :]
            err2 = err2 + jnp.sum(violX / (1.0 + normb))
            err3 = err3 + jnp.sum(
                jnp.sqrt(jnp.sum(Rd**2, axis=(-1, -2))) / (1.0 + normC)
            )
            err4 = err4 + jnp.sum(violS / (1.0 + normC))
            CX = jnp.einsum("bpq,bpq->b", g.C, X)
            trCX = trCX + jnp.sum(CX)
            if dd_mode:
                t = _trace_dot_dd(g.C, X)
                if dd2:
                    s2 = two_sum(t.hi, jnp.sum(g.C * X_new_dds[gi].lo))
                    t = DD(s2.hi, s2.lo + t.lo)
                trCX_dd = dd_add(trCX_dd, t)
            if dd2:
                # per-block <S, X> at dd resolution: near the floor the f64
                # product noise (~u64 * ||S|| ||X||) exceeds the true
                # barrier value
                Xd2, Sd2 = X_new_dds[gi], S_new_dds[gi]
                nb_ = X.shape[0]
                p = two_prod(Sd2.hi.reshape(nb_, -1), Xd2.hi.reshape(nb_, -1))
                t = dd_sum(DD(p.hi, p.lo), axis=-1)  # [nb] dd
                cross = jnp.sum(
                    (Sd2.hi * Xd2.lo + Sd2.lo * Xd2.hi).reshape(nb_, -1),
                    axis=-1,
                )
                SX = t.hi + (t.lo + cross)
            else:
                SX = jnp.einsum("bpq,bpq->b", S, X)
            err6 = err6 + jnp.sum(SX / (1.0 + jnp.abs(CX) + jnp.abs(by)))
        if nlin:
            dX = jnp.dot(problem.d_lin, X_lin_new)
            normd = jnp.linalg.norm(problem.d_lin)
            err2 = err2 + jnp.maximum(0.0, -jnp.min(X_lin_new)) / (1.0 + normb)
            err3 = err3 + jnp.linalg.norm(Rd_lin) / (1.0 + normd)
            err4 = err4 + jnp.maximum(0.0, -jnp.min(S_lin_new)) / (1.0 + normd)
            if dd_mode:
                ddX = _dd_dot(problem.d_lin, X_lin_new)
                if dd2:
                    s2 = two_sum(ddX.hi, jnp.dot(problem.d_lin, Xl_new_dd.lo))
                    ddX = DD(s2.hi, s2.lo + ddX.lo)
                gap = dd_to_f64(dd_add(dd_add(trCX_dd, ddX), dd_neg(by_dd)))
            else:
                gap = trCX + dX - by
            err5 = gap / (1.0 + jnp.abs(trCX) + jnp.abs(by))
            if dd2:
                # LP complementarity at dd resolution: near the floor the
                # f64 dot's noise u64*||S||*||X|| exceeds the true value
                t = _dd_dot(Sl_new_dd.hi, Xl_new_dd.hi)
                cross = jnp.dot(Sl_new_dd.hi, Xl_new_dd.lo) + jnp.dot(
                    Sl_new_dd.lo, Xl_new_dd.hi
                )
                SXl = t.hi + (t.lo + cross)
            else:
                SXl = jnp.dot(S_lin_new, X_lin_new)
            err6 = err6 + SXl / (1.0 + jnp.abs(dX) + jnp.abs(by))
        else:
            if dd_mode:
                gap = dd_to_f64(dd_add(trCX_dd, dd_neg(by_dd)))
            else:
                gap = trCX - by
            err5 = gap / (1.0 + jnp.abs(trCX) + jnp.abs(by))

        dimacs = err2 + err3 + err4 + jnp.abs(err5) + err6
        if nlmi > 0:
            dimacs = dimacs + err1

        if dd2:
            new_state = IPMState(
                X=X_new, S=S_new, y=y_new, X_lin=X_lin_new,
                S_lin=S_lin_new, sigma=sigma,
                X_lo=tuple(x.lo for x in X_new_dds),
                S_lo=tuple(s_.lo for s_ in S_new_dds),
                y_lo=y_new_dd.lo,
                X_lin_lo=None if Xl_new_dd is None else Xl_new_dd.lo,
                S_lin_lo=None if Sl_new_dd is None else Sl_new_dd.lo,
            )
        else:
            new_state = IPMState(
                X=X_new, S=S_new, y=y_new, X_lin=X_lin_new, S_lin=S_lin_new,
                sigma=sigma,
            )
        stats = StepStats(
            obj=-by + problem.b_const,
            mu=mu,
            sigma=sigma,
            err1=err1,
            err2=err2,
            err3=err3,
            err4=err4,
            err5=err5,
            err6=err6,
            dimacs=dimacs,
            alpha_min=amin,
            beta_min=bmin,
            h_shifts=h_shifts,
            h_ok=h_ok,
            nt_ok=nt_ok,
            cg_iter_pre=cg_pre,
            cg_iter_cor=cg_cor,
        )
        return new_state, stats

    return step


def _bdiag(d: jax.Array) -> jax.Array:
    """[nb, m] -> [nb, m, m] batched diagonal embed."""
    return jax.vmap(jnp.diag)(d)


# ---------------------------------------------------------------------------
# Chunked on-device IPM loop: run up to K iterations per dispatch.
#
# Why: a dispatch plus a device->host fetch per iteration would put a host
# round trip (and the host's per-iteration Python) between every two
# iterations; for small problems that is comparable to the iteration
# itself. Running the convergence/status logic of the reference's outer
# loop (`src/Solvers.jl:329-349`, `check_convergence` `:543-566`) inside a
# lax.while_loop and fetching a [K]-row stats buffer ONCE per chunk removes
# that overhead without changing any decision: the status precedence and the
# tol_cg schedule are replicated exactly; per-iteration log rows are printed
# by the host from the fetched buffer.
# ---------------------------------------------------------------------------


class ChunkResult(NamedTuple):
    state: IPMState
    buf: StepStats  # [K]-arrays; rows [0, k) are valid
    k: jax.Array  # iterations executed this chunk (int32)
    it: jax.Array  # global iteration counter after the chunk
    tol_cg: jax.Array
    regcount: jax.Array
    status: jax.Array  # 0 = still running
    switch: jax.Array  # hybrid preconditioner 4 -> 1 switch requested
    mixed_off: jax.Array  # mixed f32 assembly -> exact f64 switch requested


class _ChunkCarry(NamedTuple):
    state: IPMState
    buf: StepStats
    k: jax.Array
    it: jax.Array
    tol_cg: jax.Array
    regcount: jax.Array
    status: jax.Array
    switch: jax.Array
    mixed_off: jax.Array


# DIMACS threshold below which the mixed f32 assembly hands over to the
# exact f64 path (assembly_precision='auto'): the f32 H's ~1e-6 relative
# error is backward-error-class safe down to here, with an order of margin
MIXED_ASSEMBLY_DIMACS = 1e-3


def build_chunk(opts: Options, precond_kind: int, K: int, mesh=None,
                mixed_assembly: bool = False):
    """Return chunk(problem, state, tol_cg, it0, regcount0) -> ChunkResult."""
    step = build_step(opts, precond_kind, mesh=mesh,
                      mixed_assembly=mixed_assembly)
    hybrid = opts.kit == 1 and precond_kind == 4

    def chunk(problem: SDPProblem, state: IPMState, tol_cg, it0, regcount0):
        dtype = problem.b.dtype
        fz = jnp.zeros((K,), dtype=dtype)
        iz = jnp.zeros((K,), dtype=jnp.int32)
        bz = jnp.zeros((K,), dtype=bool)
        buf0 = StepStats(
            obj=fz, mu=fz, sigma=fz, err1=fz, err2=fz, err3=fz, err4=fz,
            err5=fz, err6=fz, dimacs=fz, alpha_min=fz, beta_min=fz,
            h_shifts=iz, h_ok=bz, nt_ok=bz, cg_iter_pre=iz, cg_iter_cor=iz,
        )

        def cond(c: _ChunkCarry):
            running = jnp.logical_and(c.status == 0, jnp.logical_not(c.switch))
            running = jnp.logical_and(running, jnp.logical_not(c.mixed_off))
            return jnp.logical_and(running, c.k < K)

        def body(c: _ChunkCarry):
            new_state, stats = step(problem, c.state, c.tol_cg)
            it = c.it + 1
            regcount = c.regcount + (stats.h_shifts > 0).astype(jnp.int32)
            dimacs = stats.dimacs
            # status precedence mirrors the host loop / reference `solve`
            status = jnp.where(jnp.logical_not(stats.h_ok), jnp.int32(3), jnp.int32(0))
            ok = status == 0
            status = jnp.where(
                ok & (stats.h_shifts > 0) & (regcount > 5), 3, status
            )
            ok = status == 0
            status = jnp.where(ok & jnp.logical_not(stats.nt_ok), 4, status)
            ok = status == 0
            status = jnp.where(ok & jnp.logical_not(jnp.isfinite(dimacs)), 3, status)
            ok = status == 0
            status = jnp.where(ok & (dimacs < opts.eDIMACS), 1, status)
            ok = status == 0
            status = jnp.where(ok & (dimacs > 1e55), 2, status)
            ok = status == 0
            status = jnp.where(ok & (jnp.abs(stats.obj) > 1e55), 3, status)
            ok = status == 0
            status = jnp.where(ok & (it >= opts.maxit), 4, status)

            if hybrid:
                cg_cor = stats.cg_iter_cor.astype(dtype)
                thresh = opts.erank * problem.nlmi * math.sqrt(problem.n) / 20.0
                switch = (status == 0) & (
                    ((cg_cor / 2.0 > thresh) & (it > math.sqrt(problem.n) / 60.0))
                    | (cg_cor > 100)
                )
            else:
                switch = jnp.asarray(False)

            if mixed_assembly:
                # hand over to the exact f64 assembly near convergence
                # (host rebuilds the chunk; see ipm/solver.py)
                mixed_off = (status == 0) & (dimacs < MIXED_ASSEMBLY_DIMACS)
            else:
                mixed_off = jnp.asarray(False)

            buf = StepStats(
                *(b.at[c.k].set(v) for b, v in zip(c.buf, stats))
            )
            tol_cg = jnp.maximum(c.tol_cg * opts.tol_cg_up, opts.tol_cg_min)
            return _ChunkCarry(
                state=new_state, buf=buf, k=c.k + 1, it=it, tol_cg=tol_cg,
                regcount=regcount, status=status, switch=switch,
                mixed_off=mixed_off,
            )

        init = _ChunkCarry(
            state=state, buf=buf0, k=jnp.int32(0), it=jnp.asarray(it0, jnp.int32),
            tol_cg=jnp.asarray(tol_cg, dtype), regcount=jnp.asarray(regcount0, jnp.int32),
            status=jnp.int32(0), switch=jnp.asarray(False),
            mixed_off=jnp.asarray(False),
        )
        out = jax.lax.while_loop(cond, body, init)
        return ChunkResult(
            state=out.state, buf=out.buf, k=out.k, it=out.it,
            tol_cg=out.tol_cg, regcount=out.regcount, status=out.status,
            switch=out.switch, mixed_off=out.mixed_off,
        )

    return chunk


_CHUNK_CACHE = {}


def jitted_chunk(opts: Options, precond_kind: int, K: int, mesh=None,
                 mixed_assembly: bool = False):
    """Jitted chunked loop, cached like jitted_step (same trace-relevant
    key + eDIMACS/maxit/tol schedule, which are baked into the chunk)."""
    key = (
        tuple(getattr(opts, f) for f in _TRACE_RELEVANT),
        precond_kind, K, opts.eDIMACS, opts.maxit, opts.tol_cg_up,
        opts.tol_cg_min, mesh, mixed_assembly,
    )
    fn = _CHUNK_CACHE.get(key)
    if fn is None:
        # The platform table may carry compiler options for the dd-NT
        # chunk: XLA:CPU's O2/O3 backend pipeline explodes compiling it
        # (>60 GB RSS / bad_alloc even at m=8 — module-size pathology of
        # the dd error-free-transform op mix; the standalone dd Jacobi
        # compiles in ~6 s), while opt level 1 compiles the same chunk in
        # ~90 s within ~8 GB and PRESERVES the EFTs (err1 ~ 2e-22 on the
        # small e2e gate). Only the explicit nt_precision='dd' pays it.
        compiler_options = None
        if opts.precision == "dd2" and opts.nt_precision == "dd":
            compiler_options = backend_table()["dd_nt_compiler_options"]
        fn = jax.jit(build_chunk(opts, precond_kind, K, mesh=mesh,
                                 mixed_assembly=mixed_assembly),
                     compiler_options=compiler_options)
        _CHUNK_CACHE[key] = fn
    return fn


_STEP_CACHE = {}

# options that change the traced program; everything else (maxit, verb,
# eDIMACS, tolerance schedule, timing, profile_dir, ...) lives on the host
# side of the loop and must NOT key the cache
_TRACE_RELEVANT = (
    "kit", "erank", "aamat", "cg_maxiter", "nt_method", "dtype", "step_eig",
    "eigh_backend", "precision", "cg_materialize", "gemm_backend",
    "chol_backend", "nt_precision",
)


def jitted_step(opts: Options, precond_kind: int):
    """Jitted step, cached on the *trace-relevant* option values so repeated
    solves (and repeated Solver instances) reuse traces and XLA executables
    instead of paying every compile again."""
    key = (tuple(getattr(opts, f) for f in _TRACE_RELEVANT), precond_kind)
    fn = _STEP_CACHE.get(key)
    if fn is None:
        fn = jax.jit(build_step(opts, precond_kind))
        _STEP_CACHE[key] = fn
    return fn
