"""Host-side IPM driver: thin outer loop around the jitted step.

Mirrors the reference's `solve` loop (`src/Solvers.jl:304-361`): iteration
log, CG-tolerance schedule, hybrid-preconditioner switch, status handling.
The outer loop runs tens of iterations, so host round-trips per iteration
are negligible; every numeric kernel is inside the jitted step.

Status codes (reference `src/MOI_wrapper.jl:252-265`):
  0 = not solved, 1 = optimal, 2 = (probably) infeasible,
  3 = (probably) unbounded or infeasible, 4 = iteration/numerics limit.
"""
from __future__ import annotations

import dataclasses
import math
import time
import warnings
from typing import Any, Dict, List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Options
from ..problem import SDPProblem, problem_from_sdpa
from ..utils.timers import PhaseTimer
from .initial import initial_point
from .state import IPMState
from .step import jitted_chunk

# iterations per device dispatch: the chunked on-device loop
# (step.py:build_chunk) fetches stats once per chunk instead of once per
# iteration, so the host round trip is paid once per chunk
STEPS_PER_DISPATCH = 8

__all__ = ["Result", "Solver", "solve", "solve_json", "solve_sdpa"]

STATUS_NAMES = {
    0: "NOT_SOLVED",
    1: "OPTIMAL",
    2: "INFEASIBLE",
    3: "INFEASIBLE_OR_UNBOUNDED",
    4: "ITERATION_LIMIT",
}


def _detect_mesh(problem: SDPProblem):
    """Return the mesh a sharded problem was placed on (parallel/mesh.py's
    shard_problem), or None for unsharded problems."""
    from jax.sharding import NamedSharding

    sh = getattr(problem.b, "sharding", None)
    if isinstance(sh, NamedSharding) and "schur" in sh.mesh.axis_names:
        return sh.mesh
    return None


def _fetch(x) -> np.ndarray:
    """device->host fetch that also works for arrays sharded across
    processes (multi-host runs): such arrays are reassembled with a
    process allgather."""
    if getattr(x, "is_fully_addressable", True):
        return np.asarray(jax.device_get(x))
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


@dataclasses.dataclass
class Result:
    """Solution container (reference result surface:
    `src/MOI_wrapper.jl:241-354`)."""

    status: int
    status_name: str
    objective: float  # -b^T y + b_const (SDPA-sense optimal value)
    dual_objective: float  # -sum <C_i, X_i> - d_lin^T x_lin
    y: np.ndarray
    X: List[np.ndarray]  # primal blocks, original order/sizes (unpadded)
    S: List[np.ndarray]  # dual slack blocks, original order/sizes
    X_lin: Optional[np.ndarray]
    iterations: int
    cg_iterations: int
    dimacs: float
    errs: Dict[str, float]
    solve_time: float
    iteration_times: List[float]
    timer: PhaseTimer
    final_state: Optional[IPMState] = None  # for warm-start / checkpointing
    history: Optional[List[Dict[str, float]]] = None  # per-iteration stats


class Solver:
    def __init__(
        self,
        problem: SDPProblem,
        options: Union[Options, Dict[str, Any], None] = None,
        initial_state: Optional[IPMState] = None,
    ):
        """``initial_state`` warm-starts the IPM from a saved iterate
        (see save_state/load_state); shapes must match the problem."""
        if isinstance(options, dict) or options is None:
            options = Options.from_dict(options)
        self.problem = problem
        self.opts = options.validated()
        self.timer = PhaseTimer()
        self.initial_state = initial_state
        self._apply_auto_downgrades()

    def _apply_auto_downgrades(self) -> None:
        """kit/datarank auto-downgrades (`src/Solvers.jl:421-444`)."""
        o = self.opts
        p = self.problem
        # precision='dd2' covers every storage: dense (Ozaki matvec),
        # rank-1 (TwoProd factor + Ozaki GEMM), sparse (per-cell layout
        # attached lazily in solve() via ensure_dd_aadj), the LP cone and
        # kit=1 (dd lin-cone updates + dd2 CG refinement,
        # `src/predictor_corrector.jl:329-364`, `:131-134` at Float64x4).
        if o.kit == 1:
            if p.nlmi == 0:
                warnings.warn("Switching to a direct solver, no LMIs")
                o.kit = 0
            elif p.nlmi > 0 and o.erank >= max(g.m for g in p.groups) - 1:
                warnings.warn("Switching to a direct solver, erank bigger than matrix size")
                o.kit = 0

    def _normalize_tails(self, state: IPMState) -> IPMState:
        """Reconcile the state's dd2 tails with the requested precision.

        A pre-dd2 checkpoint resumed under precision='dd2' gets zero tails
        (exact: the stored f64 iterate IS hi+0); a dd2 checkpoint resumed at
        lower precision drops them (the hi words are the correctly rounded
        f64 iterate)."""
        import dataclasses as _dc
        import jax.numpy as jnp

        if self.opts.precision == "dd2":
            if state.X_lo is None:
                state = _dc.replace(
                    state,
                    X_lo=tuple(jnp.zeros_like(X) for X in state.X),
                    S_lo=tuple(jnp.zeros_like(S) for S in state.S),
                    y_lo=jnp.zeros_like(state.y),
                    X_lin_lo=None if state.X_lin is None else jnp.zeros_like(state.X_lin),
                    S_lin_lo=None if state.S_lin is None else jnp.zeros_like(state.S_lin),
                )
        elif state.X_lo is not None:
            state = _dc.replace(
                state, X_lo=None, S_lo=None, y_lo=None,
                X_lin_lo=None, S_lin_lo=None,
            )
        return state

    # -- logging ----------------------------------------------------------
    def _header(self) -> None:
        o = self.opts
        p = self.problem
        if o.verb <= 0:
            return
        print(" *** loraine_tpu ***")
        print(f" Number of variables: {p.n:5d}")
        print(f" LMI constraints    : {p.nlmi:5d}")
        if p.nlmi > 0:
            sizes = []
            for g in p.groups:
                sizes += list(g.orig_sizes)
            print(" Matrix size(s)     :" + "".join(f"{s:6d}" for s in sizes))
        print(f" Linear constraints : {p.nlin:5d}")
        if o.kit > 0:
            print(f" Preconditioner     : {o.preconditioner:5d}")
        else:
            print(" Preconditioner     :  none, using direct solver")
        print(" *** IP STARTS")
        if o.verb < 2:
            if o.kit == 0:
                print(" it        obj         error     CPU/it")
            else:
                print(" it        obj         error     cg_iter   CPU/it")
        else:
            if o.kit == 0:
                print(" it        obj         error      err1      err2      err3      err4      err5      err6     CPU/it")
            else:
                print(" it        obj         error      err1      err2      err3      err4      err5      err6    cg_pre  cg_cor  CPU/it")

    def _log_iter(self, it: int, s: Dict[str, float], dt: float) -> None:
        o = self.opts
        if o.verb <= 0:
            return
        if o.verb > 1:
            if o.kit == 0:
                print(f"{it:3d} {s['obj']:16.8e} {s['dimacs']:9.2e} {s['err1']:9.2e} {s['err2']:9.2e} {s['err3']:9.2e} {s['err4']:9.2e} {s['err5']:9.2e} {s['err6']:9.2e} {dt:8.2f}")
            else:
                print(f"{it:3d} {s['obj']:16.8e} {s['dimacs']:9.2e} {s['err1']:9.2e} {s['err2']:9.2e} {s['err3']:9.2e} {s['err4']:9.2e} {s['err5']:9.2e} {s['err6']:9.2e} {int(s['cg_pre']):7d} {int(s['cg_cor']):7d} {dt:8.2f}")
        else:
            if o.kit == 0:
                print(f"{it:3d} {s['obj']:16.8e} {s['dimacs']:9.2e} {dt:8.2f}")
            else:
                print(f"{it:3d} {s['obj']:16.8e} {s['dimacs']:9.2e} {int(s['cg_pre'] + s['cg_cor']):9d} {dt:8.2f}")

    # -- main loop --------------------------------------------------------
    def solve(self) -> Result:
        from .. import _enable_persistent_cache

        _enable_persistent_cache()
        o = self.opts
        p = self.problem
        t_start = time.time()
        self._header()

        with self.timer.phase("initial point"):
            state = self.initial_state if self.initial_state is not None else initial_point(p, o)
            state = self._normalize_tails(state)

        profiler_cm = None
        if o.profile_dir:
            profiler_cm = jax.profiler.trace(o.profile_dir)
            profiler_cm.__enter__()

        precond_kind = o.preconditioner if o.kit == 1 else -1
        # iterations per dispatch: tiny problems (control1-class) amortize
        # the host round trip over more on-device iterations. The compile
        # cost is unchanged (K is just the while_loop trip bound and the
        # stats-buffer row count); the device loop still stops at
        # convergence, so large K never overshoots.
        if p.n <= 64 and p.sum_msizes <= 256:
            base_k = 64  # control1-class
        elif p.n <= 256 and p.sum_msizes <= 512:
            base_k = 32  # theta1-class
        else:
            base_k = STEPS_PER_DISPATCH
        K = max(1, min(base_k, o.maxit))
        # sharded problems carry their mesh on the data; pass it to the step
        # builder so the CG vectors are anchored to the schur axis (the
        # distributed Schur solve — see build_step)
        mesh = _detect_mesh(p)
        if o.precision == "dd2" and any(
            g.is_sparse and g.Acell is None for g in p.groups
        ):
            # sparse dd2: attach the per-cell adjoint layout the dd-exact
            # Aadj needs (problem.py ensure_dd_aadj; lazy — only dd2
            # solves pay for it)
            from ..problem import ensure_dd_aadj

            p = ensure_dd_aadj(p, mesh)
        # mixed f32 Schur assembly phase (assembly_precision='f32'; the
        # chunk signals mixed_off when DIMACS crosses the handover threshold
        # and the loop rebuilds with the exact f64 assembly — same mechanics
        # as the reference's hybrid-preconditioner switch). Options resolve
        # 'auto' to 'f64' (config.AUTO_BACKENDS). The sparse-mixed A_flat32
        # path is not dispatched (ops/schur.py schur_group_mixed), so the
        # solver never attaches the f32 copy; mixed assembly covers the LP
        # block and dense-stored groups.
        mixed = o.assembly_precision == "f32"
        with self.timer.phase("build/compile step"):
            chunk = jitted_chunk(o, precond_kind, K, mesh=mesh,
                                 mixed_assembly=mixed)

        tol_cg = o.tol_cg
        status = 0
        it = 0
        regcount = 0
        cg_tot = 0
        stats_h: Dict[str, float] = {}
        iteration_times: List[float] = []
        history: List[Dict[str, float]] = []
        dtype = p.b.dtype

        while status == 0:
            t2 = time.time()
            with self.timer.phase("ipm step"):
                res = chunk(p, state, jnp.asarray(tol_cg, dtype=dtype), it, regcount)
                state = res.state
                buf, k, it_d, tol_d, reg_d, status_d, switch = jax.device_get(
                    (res.buf, res.k, res.it, res.tol_cg, res.regcount,
                     res.status, res.switch)
                )
            dt = time.time() - t2
            k = int(k)
            per_iter = dt / max(k, 1)

            # replay the chunk's per-iteration rows on the host: log lines,
            # history, and the reference's warning messages
            # (src/predictor_corrector.jl:55-97, src/Solvers.jl:543-566)
            for r in range(k):
                it += 1
                iteration_times.append(per_iter)
                stats_h = {
                    "obj": float(buf.obj[r]), "mu": float(buf.mu[r]),
                    "err1": float(buf.err1[r]), "err2": float(buf.err2[r]),
                    "err3": float(buf.err3[r]), "err4": float(buf.err4[r]),
                    "err5": float(buf.err5[r]), "err6": float(buf.err6[r]),
                    "dimacs": float(buf.dimacs[r]),
                    "cg_pre": int(buf.cg_iter_pre[r]),
                    "cg_cor": int(buf.cg_iter_cor[r]),
                }
                cg_tot += stats_h["cg_pre"] + stats_h["cg_cor"]
                history.append(dict(stats_h))
                if not bool(buf.h_ok[r]):
                    if o.verb > 0:
                        print("WARNING: H cannot be made positive definite, giving up")
                    continue
                if int(buf.h_shifts[r]) > 0:
                    regcount += 1
                    if o.verb > 0:
                        print("Matrix H not positive definite, regularized")
                    if regcount > 5:
                        if o.verb > 0:
                            print("WARNING: too many regularizations of H, giving up")
                        continue
                if not bool(buf.nt_ok[r]):
                    if o.verb > 0:
                        print("WARNING: X or S cannot be made positive definite, giving up")
                    continue
                if not math.isfinite(stats_h["dimacs"]):
                    if o.verb > 0:
                        print("WARNING: numerical breakdown (non-finite error), giving up")
                    continue
                self._log_iter(it, stats_h, per_iter)

            status = int(status_d)
            regcount = int(reg_d)
            tol_cg = float(tol_d)
            it = int(it_d)
            if o.verb > 0 and status in (2, 3, 4) and stats_h:
                if status == 2:
                    print("WARNING: Problem probably infeasible (stopping status = 2)")
                elif status == 3 and abs(stats_h.get("obj", 0.0)) > 1e55:
                    print("WARNING: Problem probably unbounded or infeasible (stopping status = 3)")
                elif status == 4 and it >= o.maxit:
                    print("WARNING: Stopped by iteration limit (stopping status = 4)")

            # mixed f32 -> exact f64 assembly handover, signaled by the chunk
            if status == 0 and mixed and bool(res.mixed_off):
                mixed = False
                if o.verb > 0:
                    print("Switching to exact f64 Schur assembly")
                # drop the f32 copy: frees its HBM and restores the
                # canonical problem pytree (A_flat32=None), so the exact
                # chunk shares the compile-cache entry of pure-f64 solves
                if any(g.A_flat32 is not None for g in p.groups):
                    import dataclasses as _dc

                    p = _dc.replace(p, groups=tuple(
                        _dc.replace(g, A_flat32=None)
                        if g.A_flat32 is not None else g
                        for g in p.groups
                    ))
                with self.timer.phase("build/compile step"):
                    chunk = jitted_chunk(o, precond_kind, K, mesh=mesh,
                                         mixed_assembly=mixed)

            # hybrid preconditioner switch (src/Solvers.jl:339-347), signaled
            # by the device chunk
            if status == 0 and bool(switch):
                precond_kind = 1
                o.aamat = 2
                if o.verb > 0:
                    print("Switching to preconditioner 1")
                with self.timer.phase("build/compile step"):
                    chunk = jitted_chunk(o, precond_kind, K, mesh=mesh,
                                         mixed_assembly=mixed)

        if profiler_cm is not None:
            jax.block_until_ready(state)
            profiler_cm.__exit__(None, None, None)

        solve_time = time.time() - t_start
        if o.verb > 0:
            if o.kit == 1:
                print(f" *** Total CG iterations: {cg_tot:8d}")
            if status == 1:
                print(f" *** Optimal solution found in {solve_time:8.2f} seconds")

        result = self._extract(state, stats_h, status, it, cg_tot, solve_time, iteration_times)
        result.history = history
        if o.verb > 0 and status == 1:
            print(f"Primal objective: {result.objective}")
            print(f"Dual objective:   {result.dual_objective}")
        if o.timing > 0 and o.verb > 0:
            print(self.timer.report())
        if o.timing >= 2 and o.verb > 0:
            # deep per-phase attribution (the reference's TimerOutputs tree,
            # `src/Solvers.jl:467-476`, printed via `src/Loraine.jl:88-90`);
            # re-times each phase standalone at a representative iterate, so
            # it costs extra device work — opt-in by timing=2 / CLI --phases
            from ..utils.diagnostics import format_phases, profile_phases

            times = profile_phases(self.problem, o)
            print(format_phases(times))
        return result

    def _extract(self, state, stats_h, status, it, cg_tot, solve_time, iteration_times) -> Result:
        p = self.problem
        nblocks = p.nlmi
        Xb: List[Optional[np.ndarray]] = [None] * nblocks
        Sb: List[Optional[np.ndarray]] = [None] * nblocks
        for g, Xg, Sg in zip(p.groups, state.X, state.S):
            Xh = _fetch(Xg)
            Sh = _fetch(Sg)
            for bpos, (oidx, osize) in enumerate(zip(g.orig_indices, g.orig_sizes)):
                Xb[oidx] = Xh[bpos, :osize, :osize]
                Sb[oidx] = Sh[bpos, :osize, :osize]
        y = _fetch(state.y)
        X_lin = None if state.X_lin is None else _fetch(state.X_lin)

        # host-side arithmetic: avoids compiling eager device programs
        trCX = 0.0
        for g, Xg, Sg in zip(p.groups, state.X, state.S):
            Ch = _fetch(g.C)
            Xh = _fetch(Xg)
            trCX += float(np.sum(Ch * Xh))
        dual_obj = -trCX
        if p.nlin > 0:
            dual_obj -= float(np.dot(_fetch(p.d_lin), X_lin))

        return Result(
            status=status,
            status_name=STATUS_NAMES.get(status, "UNKNOWN"),
            objective=float(-np.dot(np.asarray(jax.device_get(p.b)), y) + p.b_const),
            dual_objective=dual_obj,
            y=y,
            X=Xb,
            S=Sb,
            X_lin=X_lin,
            iterations=it,
            cg_iterations=cg_tot,
            dimacs=stats_h.get("dimacs", float("nan")),
            errs={k: stats_h.get(k, float("nan")) for k in ("err1", "err2", "err3", "err4", "err5", "err6")},
            solve_time=solve_time,
            iteration_times=iteration_times,
            timer=self.timer,
            final_state=state,
        )


def solve(problem: SDPProblem, options: Union[Options, Dict[str, Any], None] = None) -> Result:
    """Solve an SDPProblem. ``options`` may be an Options or a flat dict with
    the reference's option names."""
    return Solver(problem, options).solve()


def solve_json(path: str, options: Union[Options, Dict[str, Any], None] = None) -> Result:
    """Read a POEMA-JSON problem and solve it — the working replacement for
    the reference's `TBD/solve_json.jl` flow over the broken raw-dict entry
    (`src/Loraine.jl:30-93`)."""
    from ..io.poema import read_poema_json
    from ..problem import problem_from_dict

    if isinstance(options, dict) or options is None:
        options = Options.from_dict(options)
    options = options.validated()
    dtype = jnp.float64 if options.dtype == "float64" else jnp.float32
    d = read_poema_json(path)
    problem = problem_from_dict(
        d, datarank=options.datarank, pad_multiple=options.pad_multiple, dtype=dtype
    )
    return Solver(problem, options).solve()


def load_problem(path: str, options: Union[Options, Dict[str, Any], None] = None) -> SDPProblem:
    """Read an SDPA .dat-s file into an SDPProblem using the same
    option-driven storage selection as ``solve_sdpa`` (datarank, padding,
    datasparsity -> dense/sparse split)."""
    if isinstance(options, dict) or options is None:
        options = Options.from_dict(options)
    options = options.validated()
    dtype = jnp.float64 if options.dtype == "float64" else jnp.float32
    # datasparsity drives the dense/sparse data-kernel split as in the
    # reference (`src/model.jl:153-174`, docs/src/Loraine_options.md:52-56).
    # None (default) = the Kojima-style modeled-cost auto-selection
    # (problem.py pick_storage; the reference carries the original cost
    # model commented out, `src/model.jl:234-287`); 0 = force dense;
    # k > 0 = explicit nnz threshold (the reference's shipped rule),
    # applied at any n.
    ds = options.datasparsity
    if ds == 0:
        storage, thr, min_n = "dense", None, 256
    elif ds is None:
        storage, thr, min_n = "auto", None, 256
    else:
        storage, thr, min_n = "auto", int(ds), 0
    return problem_from_sdpa(
        path,
        datarank=options.datarank,
        pad_multiple=options.pad_multiple,
        dtype=dtype,
        storage=storage,
        sparse_max_nnz=thr,
        sparse_min_n=min_n,
    )


def solve_sdpa(path: str, options: Union[Options, Dict[str, Any], None] = None) -> Result:
    """Read an SDPA .dat-s file and solve it (the `solve_sdpa` example flow,
    reference `examples/solve_sdpa.jl`)."""
    if isinstance(options, dict) or options is None:
        options = Options.from_dict(options)
    options = options.validated()
    problem = load_problem(path, options)
    return Solver(problem, options).solve()
