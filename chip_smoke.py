#!/usr/bin/env python
"""Smoke test of the solver on an NVIDIA GPU: the quickest proof that the
main path still starts, compiles and solves correctly on the card.

    python chip_smoke.py                # default phases, one GPU
    python chip_smoke.py --all-options  # every selectable option value
    python chip_smoke.py --chips 4      # the sharded path on four GPUs only

Default phases, all in this one JAX process:

1. device      JAX's default device is a GPU; the card's name and power
               limit as nvidia-smi reports them.
2. primitives  chol_reg's NaN-keyed shift loop on indefinite matrices; every
               eigensolver against numpy.linalg.eigh at the bench's block
               sizes; the steplength lower bound of every step_eig mode
               against the true lambda_min. Times each on the card.
3. dd          TwoSum, TwoProd, a dd dot product and the Ozaki GEMM, jitted
               on the card, against exact rationals; the verdict must agree
               with the platform table (config.AUTO_BACKENDS 'dd_exact').
4. main path   the six bench problems through lt.solve_sdpa with bench.py's
               options: OPTIMAL, DIMACS below eDIMACS, objective at its
               anchor. Times the f64 CG iteration of the kit=1 path.

Any failed check makes the exit code non-zero and suppresses the last line,
which is otherwise one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a GPU the script stops at phase 1.
"""
import argparse
import fractions
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402

# Objective anchors: (value, tolerance, source). The check is
# |objective - value| <= tolerance * max(1, |value|), the normalisation of
# the DIMACS duality-gap error. SDPLIB optima are published to 7
# significant digits, hence 1e-6 where the solve stops well below that.
# thetaG11's published optimum is 400.0; its bench solve stops at
# eDIMACS = 1e-5 (the CPU solve at the commit that introduced this script
# lands at 400.00023145620156, DIMACS 7.5e-6), hence 1e-5.
# tru9 and vib9 have no published optimum: their anchors are the
# objectives of the same solves (bench.py options) on the CPU backend at
# that commit (DIMACS 8.1e-7 and 1.8e-6); two correct solves stopped at
# eDIMACS = 1e-5 may differ by that much, hence 1e-5.
ANCHORS = {
    "theta1": (23.0, 1e-6, "SDPLIB theta1"),
    "control1-cg": (17.78463, 1e-6, "SDPLIB control1"),
    "tru9": (0.059753332407001473, 1e-5, "CPU solve"),
    "vib9": (0.012766831268998486, 1e-5, "CPU solve"),
    "maxG11": (629.1648, 1e-6, "SDPLIB maxG11"),
    "thetaG11": (400.0, 1e-5, "SDPLIB thetaG11"),
}

# bench block sizes (theta1 50, control1 10 and 5, tru9 144/145, maxG11 800,
# thetaG11 801)
EIG_SIZES = (5, 10, 50, 144, 145, 800, 801)


class Checks:
    """Collects failed checks so one call reports every failure."""

    def __init__(self):
        self.failed = []

    def check(self, ok, what):
        if not ok:
            self.failed.append(what)
            print(f"  FAILED: {what}", flush=True)
        return ok


def log(msg):
    print(msg, flush=True)


def timed(fn, *args, repeats=5):
    """Median wall time (s) of fn(*args) on the device, compile excluded."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ---------------------------------------------------------------- phase 1


def phase_device(n_chips):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: no GPU (JAX's default device is {devs[0].platform!r})"
        )
    if len(devs) < n_chips:
        raise SystemExit(f"chip_smoke: {n_chips} GPUs needed, found {len(devs)}")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise SystemExit("chip_smoke: nvidia-smi printed no card")
    for line in out.splitlines():
        log(f"card: {line.strip()}")
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")
    return devs


# ---------------------------------------------------------------- phase 2


def _sym_random(rng, nb, m):
    A = rng.standard_normal((nb, m, m))
    return (A + A.transpose(0, 2, 1)) / 2


def check_chol_reg(ck, rng):
    """An indefinite matrix must come back shifted, ok, and NaN-free: the
    shift loop keys on the NaN factor a failed Cholesky returns."""
    import jax
    import jax.numpy as jnp

    from loraine_tpu.ops.linalg import chol_reg

    eps = 0.05
    f = jax.jit(lambda M: chol_reg(M, eps, 1000))
    for nb, n in ((1, 800), (3, 145), (2, 50)):
        A = rng.standard_normal((nb, n, n))
        M = A @ A.transpose(0, 2, 1) / n - 0.5 * np.eye(n)  # lambda_min ~ -0.5
        r = f(jnp.asarray(M))
        L = np.asarray(r.L)
        shifts = int(r.shifts)
        nan_free = not np.isnan(L).any()
        ck.check(shifts > 0 and bool(r.ok) and nan_free,
                 f"chol_reg [{nb},{n},{n}] indefinite: shifts={shifts} "
                 f"ok={bool(r.ok)} nan_free={nan_free}")
        # L L^T = M + c I with c a positive multiple of eps, per element
        D = L @ L.transpose(0, 2, 1) - M
        c = np.einsum("bii->b", D) / n
        resid = np.max(np.abs(D - c[:, None, None] * np.eye(n))) / np.max(np.abs(M))
        mult = c / eps
        ck.check(resid < 1e-12 and np.all(mult > 0.5)
                 and np.allclose(mult, np.round(mult), atol=1e-6),
                 f"chol_reg [{nb},{n},{n}] factor: |LL^T - M - cI|/|M| = "
                 f"{resid:.1e}, c/eps = {np.round(mult, 3)}")
        log(f"  chol_reg [{nb},{n},{n}] indefinite: {shifts} shift(s), ok, "
            f"NaN-free, |LL^T-(M+cI)|/|M| = {resid:.1e}")
    # a failed Cholesky reports NaN (in its lower triangle), not an
    # exception: the signal itself
    L = np.asarray(jax.jit(jnp.linalg.cholesky)(jnp.asarray(-np.eye(4)[None])))
    ck.check(np.isnan(L[0][np.tril_indices(4)]).all(),
             "jnp.linalg.cholesky of -I is not NaN")


def eig_solvers():
    import jax
    import jax.numpy as jnp

    from loraine_tpu.ops.eigh import eigh_jacobi, eigh_mixed

    return {
        "xla": jax.jit(jnp.linalg.eigh),
        "xla-eigvalsh": jax.jit(jnp.linalg.eigvalsh),
        "jacobi": jax.jit(eigh_jacobi),
        "mixed": jax.jit(eigh_mixed),
    }


# Tolerances, relative to ||M||_2: a backward-stable f64 eigensolver is
# accurate to ~m * u * ||M|| (< 2e-13 at m = 801). 1e-10 leaves room for
# the Jacobi solver's fixed sweep count and the mixed solver's two
# refinement rounds (documented ~1e-13 eigenvector error on spectra with
# gaps above 1e-6 ||M||), while any f32-class result (~1e-7) fails.
EIG_TOL = 1e-10


def check_eigensolvers(ck, rng):
    import jax.numpy as jnp

    solvers = eig_solvers()
    times = {}
    for m in EIG_SIZES:
        nb = 2
        M = _sym_random(rng, nb, m)
        ref = np.linalg.eigvalsh(M)
        norm = np.max(np.abs(ref))
        Mj = jnp.asarray(M)
        row = []
        for name, fn in solvers.items():
            out = fn(Mj)
            if name == "xla-eigvalsh":
                lam = np.asarray(out)
                rec = orth = 0.0
            else:
                lam, V = np.asarray(out[0]), np.asarray(out[1])
                rec = np.max(np.abs(V @ (lam[..., None] * V.transpose(0, 2, 1)) - M)) / norm
                orth = np.max(np.abs(V.transpose(0, 2, 1) @ V - np.eye(m)))
            lam_err = np.max(np.abs(lam - ref)) / norm
            ck.check(max(lam_err, rec, orth) < EIG_TOL,
                     f"eigh {name} m={m}: eigenvalues {lam_err:.1e}, "
                     f"reconstruction {rec:.1e}, orthogonality {orth:.1e} "
                     f"(tolerance {EIG_TOL:.0e})")
            t = timed(fn, Mj)
            times[(name, m)] = t
            row.append(f"{name} {t * 1e3:.3f} ms (err {max(lam_err, rec, orth):.1e})")
        log(f"  eigh [{nb},{m},{m}]: " + "; ".join(row))
    return times


def _graded_clustered(rng, kind, nb, m):
    """Steplength-like test spectra: random, graded (1e-8..1 with a negative
    tail), clustered (a tight cluster plus an isolated minimum)."""
    if kind == "random":
        return _sym_random(rng, nb, m)
    if kind == "graded":
        lam = -np.logspace(-8, 0, m)[None, :] * rng.uniform(0.5, 2.0, (nb, 1))
    else:
        lam = 1.0 + 1e-7 * rng.standard_normal((nb, m))
        lam[:, 0] = -0.25
    Q = np.linalg.qr(rng.standard_normal((nb, m, m)))[0]
    M = (Q * lam[:, None, :]) @ Q.transpose(0, 2, 1)
    return (M + M.transpose(0, 2, 1)) / 2


# How far above the true lambda_min (relative to ||M||_2) a steplength
# value may land. The reference lambda_min (numpy, f64) is itself accurate
# only to ~m u ||M|| (< 2e-13 at m = 801), hence 1e-12 for the certified
# bounds ('chol', 'lanczos') and the converged solvers. 'exact' with the
# Jacobi solver runs 7 sweeps (ipm/step.py steplength_eigmin), which leaves
# up to ~6e-7 on graded spectra (measured on the CPU backend, m = 50);
# the step rule alpha = min(1, -TAU / lambda) with TAU = 0.95 keeps a 5%
# margin to the cone boundary, so 1e-6 is the stated allowance there.
STEP_ALLOW = {"exact/jacobi": 1e-6}


def check_step_eig(ck, rng):
    """The steplength lambda_min of every step_eig mode must not exceed the
    true lambda_min (by more than STEP_ALLOW)."""
    import jax
    import jax.numpy as jnp

    import loraine_tpu as lt
    from loraine_tpu.ipm.step import steplength_eigmin

    modes = [("exact", b) for b in ("xla", "jacobi", "mixed")]
    modes += [("chol", "xla"), ("lanczos", "xla")]
    times = {}
    for m in EIG_SIZES:
        nb = 2  # the step stacks [scaleX; scaleS]: 2 nb matrices
        row = []
        for step_eig, eigh_backend in modes:
            opts = lt.Options(step_eig=step_eig, eigh_backend=eigh_backend).validated()
            fn = jax.jit(steplength_eigmin(opts))
            worst = -np.inf
            for kind in ("random", "graded", "clustered"):
                M = _graded_clustered(rng, kind, 2 * nb, m)
                true = np.linalg.eigvalsh(M)[:, 0]
                lo = np.asarray(fn(jnp.asarray(M)))
                norm = np.max(np.abs(np.linalg.eigvalsh(M)), axis=-1)
                excess = np.max((lo - true) / norm)
                worst = max(worst, excess)
            label = f"{step_eig}/{eigh_backend}" if step_eig == "exact" else step_eig
            allow = STEP_ALLOW.get(label, 1e-12)
            ck.check(worst <= allow,
                     f"step_eig {label} m={m}: bound exceeds lambda_min by "
                     f"{worst:.1e} ||M|| (allowed {allow:.0e})")
            t = timed(fn, jnp.asarray(_sym_random(rng, 2 * nb, m)))
            times[(label, m)] = t
            row.append(f"{label} {t * 1e3:.3f} ms")
        log(f"  step_eig [{2 * nb},{m},{m}]: " + "; ".join(row))
    return times


# ---------------------------------------------------------------- phase 3


F = fractions.Fraction


def _dd_inputs(rng, n):
    """Pairs for TwoSum/TwoProd: random magnitudes over 2^+-60, plus
    near-cancellation (b ~ -a within a few ulps) and mixed-scale pairs."""
    a = rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))
    b = rng.standard_normal(n) * np.exp2(rng.integers(-60, 60, n))
    k = n // 4
    b[:k] = -a[:k] * (1.0 + rng.integers(-8, 8, k) * 2.0**-52)
    b[k:2 * k] = -a[k:2 * k] + a[k:2 * k] * 2.0**-40 * rng.standard_normal(k)
    b[2 * k:3 * k] = a[2 * k:3 * k] * 2.0**-70 * rng.standard_normal(k)
    return a, b


def check_dd(ck, rng):
    import jax
    import jax.numpy as jnp

    from loraine_tpu.config import AUTO_BACKENDS, Options
    from loraine_tpu.ops.dd import dd_dot, two_prod, two_sum
    from loraine_tpu.ops.ozaki import acc_matmul

    n = 10_000
    a, b = _dd_inputs(rng, n)
    s = jax.jit(two_sum)(jnp.asarray(a), jnp.asarray(b))
    sh, sl = np.asarray(s.hi), np.asarray(s.lo)
    sum_ok = sum(
        F(sh[i]) + F(sl[i]) == F(a[i]) + F(b[i]) and sh[i] == a[i] + b[i]
        for i in range(n)
    )
    p = jax.jit(two_prod)(jnp.asarray(a), jnp.asarray(b))
    ph, pl = np.asarray(p.hi), np.asarray(p.lo)
    prod_ok = sum(
        F(ph[i]) + F(pl[i]) == F(a[i]) * F(b[i]) and ph[i] == a[i] * b[i]
        for i in range(n)
    )
    # dd dot products with heavy cancellation: error against the exact sum,
    # relative to sum |a_i b_i| (dot2 accuracy class: a few 2^-104)
    k = 64
    X = rng.standard_normal((200, k))
    Y = rng.standard_normal((200, k))
    Y[:, k // 2:] = -X[:, : k // 2] * Y[:, : k // 2] / X[:, k // 2:]  # cancel
    d = jax.jit(dd_dot)(jnp.asarray(X), jnp.asarray(Y))
    dot_err = 0.0
    for r in range(200):
        exact = sum(F(X[r, i]) * F(Y[r, i]) for i in range(k))
        got = F(float(d.hi[r])) + F(float(d.lo[r]))
        scale = sum(abs(F(X[r, i]) * F(Y[r, i])) for i in range(k))
        dot_err = max(dot_err, float(abs(got - exact) / scale))
    # Ozaki GEMM against the exact rational product, relative to the
    # per-entry k * max|A_i.| * max|B_.j| scale its slicing works on
    m_, k_, n_ = 12, 24, 12
    A = rng.standard_normal((m_, k_)) * np.exp2(rng.integers(-20, 20, (m_, 1)))
    B = rng.standard_normal((k_, n_)) * np.exp2(rng.integers(-20, 20, (1, n_)))
    C = jax.jit(acc_matmul)(jnp.asarray(A), jnp.asarray(B))
    gemm_err = 0.0
    for i in range(m_):
        for j in range(n_):
            exact = sum(F(A[i, t]) * F(B[t, j]) for t in range(k_))
            got = F(float(C.hi[i, j])) + F(float(C.lo[i, j]))
            scale = k_ * np.max(np.abs(A[i])) * np.max(np.abs(B[:, j]))
            gemm_err = max(gemm_err, float(abs(got - exact)) / scale)
    exact = sum_ok == n and prod_ok == n and dot_err < 2.0**-100 and gemm_err < 2.0**-100
    log(f"  two_sum exact on {sum_ok}/{n} pairs; two_prod exact on {prod_ok}/{n}; "
        f"dd_dot max error {dot_err:.2e} (bound 2^-100 = {2.0**-100:.1e}); "
        f"acc_matmul max error {gemm_err:.2e}")
    table = AUTO_BACKENDS["gpu"]["dd_exact"]
    if exact:
        log("  verdict: the error-free transforms are exact on XLA:GPU; "
            "precision='dd'/'dd2' available")
        ck.check(table is True, "dd exact on the card but AUTO_BACKENDS['gpu'] "
                 f"refuses it: {table!r}")
    else:
        log("  verdict: the error-free transforms are NOT exact on XLA:GPU")
        refused = False
        try:
            Options(precision="dd").validated(platform="gpu")
        except ValueError as e:
            refused = True
            log(f"  precision='dd' refused on the GPU: {e}")
        ck.check(refused, "dd not exact on the card but Options accepts it")
    return exact


# ---------------------------------------------------------------- phase 4


def cg_iteration_time(n=21, kappa=1e10, seed=0):
    """Device time of one iteration of the kit=1 path's f64 split-
    preconditioned CG (ops/cg.py cg_plain) at control1's n: the difference
    of 400 and 100 forced iterations on a kappa=1e10 SPD system (the
    late-IPM conditioning), so loop entry and exit cancel."""
    import jax
    import jax.numpy as jnp

    from loraine_tpu.ops.cg import cg_plain

    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    H = jnp.asarray((Q * np.logspace(0, np.log10(kappa), n)) @ Q.T)
    b = jnp.asarray(rng.standard_normal(n))
    tol = jnp.asarray(1e-300)

    def run(iters):
        f = jax.jit(lambda H, b: cg_plain(lambda v: H @ v, b, tol, iters))
        it = int(f(H, b)[1])
        return timed(f, H, b, repeats=7), it

    t_lo, it_lo = run(100)
    t_hi, it_hi = run(400)
    return (t_hi - t_lo) / max(1, it_hi - it_lo), it_lo, it_hi


def solve_case(ck, name, path, opts, anchor=None, tol=None, source="", warm=True):
    import loraine_tpu as lt

    t0 = time.time()
    r = lt.solve_sdpa(os.path.join(HERE, path), dict(opts))
    cold = time.time() - t0
    warm_wall = None
    if warm:
        t0 = time.time()
        r = lt.solve_sdpa(os.path.join(HERE, path), dict(opts))
        warm_wall = time.time() - t0
    msg = (f"  {name}: status={r.status_name} iterations={r.iterations} "
           f"objective={r.objective!r} dimacs={r.dimacs:.2e} "
           f"wall cold {cold:.2f} s")
    if warm_wall is not None:
        msg += f", warm {warm_wall:.2f} s"
    if opts.get("kit") == 1:
        msg += f", cg_iterations={r.cg_iterations}"
    log(msg)
    ck.check(r.status == 1, f"{name}: status {r.status_name}")
    ck.check(r.dimacs < opts["eDIMACS"],
             f"{name}: DIMACS {r.dimacs:.2e} >= eDIMACS {opts['eDIMACS']:.0e}")
    if anchor is not None:
        rel = abs(r.objective - anchor) / max(1.0, abs(anchor))
        ck.check(rel <= tol, f"{name}: objective {r.objective!r} vs {source} "
                 f"{anchor!r}: error {rel:.1e} > {tol:.0e}")
    return r


def phase_main(ck):
    from bench import CASES

    for name, path, opts in CASES:
        anchor, tol, source = ANCHORS[name]
        solve_case(ck, name, path, opts, anchor, tol, source)
        if name == "control1-cg":
            t, lo, hi = cg_iteration_time()
            log(f"  control1-class CG iteration (n=21, f64 split-preconditioned, "
                f"{lo}->{hi} iterations): {t * 1e6:.2f} us")


# ---------------------------------------------------------------- options


def all_option_cases():
    """(label, path, options, anchor, rel tol): theta1 (dense) and tru3
    (forced sparse storage plus its LP cone) under every option value a
    user can select; maxG11 for the rank-1 int8 GEMM backend."""
    theta = ("tests/data/theta1.dat-s",
             {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0}, 23.0, 1e-6)
    tru3 = ("tests/data/tru3.dat-s",
            {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0,
             "datasparsity": 8}, 0.0625018, 1e-5)
    variants = [{"eigh_backend": v} for v in ("xla", "jacobi", "mixed")]
    variants += [{"step_eig": v} for v in ("exact", "chol", "lanczos")]
    variants += [{"chol_backend": "mixed"}, {"assembly_precision": "f32"},
                 {"nt_method": "svd"}, {"precision": "dd"}, {"precision": "dd2"}]
    out = []
    for v in variants:
        for label, (path, base, anchor, tol) in (("theta1", theta), ("tru3", tru3)):
            out.append((f"{label} {v}", path, {**base, **v}, anchor, tol))
    kit1 = {"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-6,
            "initpoint": 1, "verb": 0}
    for v in ({"cg_materialize": "never"}, {"cg_materialize": "always"},
              {"preconditioner": 2}, {"preconditioner": 4},
              {"precision": "dd"}):
        out.append((f"theta1 kit=1 {v}", "tests/data/theta1.dat-s",
                    {**kit1, **v}, 23.0, 1e-5))
    out.append(("maxG11 {'gemm_backend': 'int8'}", "tests/data/maxG11.dat-s",
                {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "datarank": -1,
                 "verb": 0, "gemm_backend": "int8"}, 629.1648, 1e-6))
    # last: the native dd NT chunk is the largest compile
    v = {"precision": "dd2", "nt_precision": "dd"}
    for label, (path, base, anchor, tol) in (("theta1", theta), ("tru3", tru3)):
        out.append((f"{label} {v}", path, {**base, **v}, anchor, tol))
    return out


def phase_all_options(ck, dd_available):
    for label, path, opts, anchor, tol in all_option_cases():
        if opts.get("precision", "f64") != "f64" and not dd_available:
            log(f"  {label}: skipped, precision refused on this platform")
            continue
        try:
            solve_case(ck, label, path, opts, anchor, tol, "anchor", warm=False)
        except Exception as e:  # report every option, then fail
            ck.check(False, f"{label}: {type(e).__name__}: {e}")


# ---------------------------------------------------------------- 4 chips


def phase_four_chips(ck, n):
    import jax

    import __graft_entry__ as g
    import loraine_tpu as lt
    from loraine_tpu.ipm.initial import initial_point
    from loraine_tpu.parallel.mesh import make_mesh, shard_problem, shard_state

    t0 = time.time()
    g.dryrun_multichip(n)
    log(f"  dryrun_multichip({n}): all 7 gates passed in {time.time() - t0:.1f} s")
    # the Schur-sharded operands must really span every device
    mesh = make_mesh((2, n // 2), jax.devices()[:n])
    opts = {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0, "datasparsity": 8}
    prob = lt.load_problem(os.path.join(HERE, "tests/data/tru3.dat-s"), opts)
    sp = shard_problem(prob, mesh)
    st = shard_state(initial_point(prob, lt.Options(**opts).validated()), prob, mesh)
    arrays = {}
    for i, grp in enumerate(sp.groups):
        for f in ("A", "AT", "B", "Avals", "Arows", "Acols", "C"):
            x = getattr(grp, f)
            if x is not None:
                arrays[f"group{i}.{f}"] = x
    for i, x in enumerate(st.X):
        arrays[f"state.X[{i}]"] = x
    res = lt.solve(sp, dict(opts))
    for i, x in enumerate(res.final_state.X):
        arrays[f"solved.X[{i}]"] = x
    arrays["solved.y"] = res.final_state.y
    for k, x in arrays.items():
        span = len(x.sharding.device_set)
        ck.check(span == n, f"{k} spans {span} of {n} devices ({x.sharding})")
    log(f"  span: {len(arrays)} sharded operands each span all {n} devices; "
        f"sharded tru3 {res.status_name} objective={res.objective!r}")
    ck.check(res.status == 1 and abs(res.objective - 0.0625018) < 1e-5,
             f"sharded tru3: {res.status_name} {res.objective!r}")


# ---------------------------------------------------------------- main


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--all-options", action="store_true",
                    help="also solve theta1/tru3/maxG11 under every option value")
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path on four GPUs")
    args = ap.parse_args()

    devs = phase_device(args.chips)
    import jax

    import loraine_tpu as lt  # noqa: F401  (enables x64 before any array)

    ck = Checks()
    rng = np.random.default_rng(20261016)
    t_start = time.time()
    if args.chips == 4:
        log("phase: four-chip sharded path")
        phase_four_chips(ck, 4)
    else:
        log("phase: primitives")
        check_chol_reg(ck, rng)
        check_eigensolvers(ck, rng)
        check_step_eig(ck, rng)
        log("phase: double-double on the card")
        dd_available = check_dd(ck, rng)
        log("phase: main path (bench problems through lt.solve_sdpa)")
        phase_main(ck)
        if args.all_options:
            log("phase: every option value")
            phase_all_options(ck, dd_available)
    log(f"elapsed {time.time() - t_start:.1f} s")
    if ck.failed:
        log(f"{len(ck.failed)} check(s) failed")
        sys.exit(1)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
