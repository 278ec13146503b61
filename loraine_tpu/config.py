"""Solver options.

Mirrors the reference option surface (Loraine.jl `src/Solvers.jl:169-302`,
`docs/src/Loraine_options.md`) with the same names, defaults, and
validation/auto-correction semantics (minus its known bugs: the reference reads
``datasparsity`` from the ``"maxit"`` key at `src/Solvers.jl:203`; we read it
from ``datasparsity``), plus accelerator knobs (``dtype``, ``pad_multiple``,
the backend choices).

Every option whose value is ``'auto'`` is resolved in ONE place,
`resolve_backends` (called by `Options.validated`), from the table
`AUTO_BACKENDS` keyed by the JAX platform. No other module looks at the
platform.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional


@dataclasses.dataclass
class Options:
    """Options for the interior-point solver.

    Reference semantics: Loraine.jl `docs/src/Loraine_options.md:4-56`.

    Attributes:
      kit: 0 = direct (Cholesky) linear solver, 1 = preconditioned CG.
      tol_cg: initial CG tolerance (relative residual).
      tol_cg_up: per-IPM-iteration multiplicative CG tolerance update.
      tol_cg_min: CG tolerance floor.
      eDIMACS: stopping tolerance on the sum of DIMACS errors.
      preconditioner: 0 none / 1 H_alpha / 2 H_beta / 4 hybrid (beta -> alpha).
      erank: estimated rank of the primal solution (H_alpha subspace size).
      aamat: ttau formula selector: 0 -> min(lambda_tail); otherwise
        (min+mean)/2 of the tail spectrum.
      fig_ev: unused diagnostic flag (kept for option-surface parity).
      verb: 0 silent, 1 short iteration log, 2 full DIMACS breakdown.
      datarank: 0 full-rank data; -1 factorize each A_i as +/- b_i b_i^T
        (falls back to 0 when factorization error > 5e-6, reference
        `src/model.jl:189-191`).
      initpoint: 0 = simple identity start, 1 = SDPT3-like scaled start.
      timing: print per-phase timing tree at the end of the solve.
      maxit: IPM iteration limit.
      datasparsity: dense/sparse data-kernel split control (reference
        `src/model.jl:153-174`). None (default) = Kojima-style modeled-cost
        auto-selection (problem.py pick_storage; the reference carries the
        original Kojima cost model commented out, `src/model.jl:234-287`);
        0 = force dense; k > 0 = explicit nnz threshold (the reference's
        shipped rule, default 8 there): matrices with at most k nonzeros go
        to the sparse gather path, at any n.
      dtype: 'float64' (default; IPM needs f64 late iterations) or 'float32'.
      pad_multiple: pad LMI block sizes up to a multiple of this.
      step_eig: steplength spectra method (see the field comment).
    """

    kit: int = 0
    tol_cg: float = 1.0e-2
    tol_cg_up: float = 0.5
    tol_cg_min: float = 1.0e-7
    eDIMACS: float = 1.0e-7
    preconditioner: int = 1
    erank: int = 1
    aamat: int = 1
    fig_ev: int = 0
    verb: int = 1
    datarank: int = 0
    initpoint: int = 0
    timing: int = 1
    maxit: int = 100
    datasparsity: Optional[int] = None
    # accelerator knobs
    dtype: str = "float64"
    pad_multiple: int = 8
    # steplength lambda_min method ('auto' resolves per platform, see
    # AUTO_BACKENDS below):
    # 'exact': the eigh_backend eigensolver (full eigenvalues);
    # 'lanczos': Ritz-residual bound from ~50 matvecs, certified by one
    #   Cholesky (Cholesky bisection where the certificate fails; ops/eigh.py);
    # 'chol': Cholesky-bisection lower bound (safe; ~45 sequential batched
    #   Cholesky factorizations per phase)
    step_eig: str = "auto"
    cg_maxiter: int = 10000
    # kit=1 operator application: 'auto' materializes the Schur operator H
    # and the H_alpha matrix densely when n <= 512 (each CG iteration = one
    # GEMV plus vector ops, run as the f64 split-preconditioned CG of
    # ops/cg.py, instead of the ~20-kernel implicit per-block pipeline — a
    # pure win on latency-bound small problems); 'never' keeps the
    # matrix-free operator everywhere (the reference's regime, required at
    # large n); 'always' forces materialization (testing/benchmarking).
    cg_materialize: str = "auto"
    profile_dir: str = ""  # capture a jax.profiler trace of the solve
    nt_method: str = "eigh"  # 'eigh' (no SVD codepath) or 'svd' (reference)
    # Eigensolver for NT scaling, preconditioner prep and 'exact'
    # steplengths:
    # 'xla': jnp.linalg.eigh in f64 (LAPACK on the CPU, cuSOLVER on GPUs);
    # 'jacobi': XLA-level parallel-Jacobi eigensolver (ops/eigh.py; high
    #   relative accuracy on graded spectra, cost grows with m * sweeps
    #   sequential rounds);
    # 'mixed': f32 eigh seed + f64 GEMM-only refinement (ops/eigh.py);
    # 'auto': resolved per platform (AUTO_BACKENDS below) to a size rule
    # that picks one of the three per block size.
    eigh_backend: str = "auto"
    # Large-GEMM backend for the rank-1 Schur assembly: 'f64' (default)
    # plain f64 GEMMs; 'int8' the exact integer Ozaki scheme
    # (ops/int8gemm.py) — f64-equivalent accuracy, oracle-tested in
    # tests/test_int8gemm.py. Opt-in: no measured win yet.
    gemm_backend: str = "f64"
    # Cholesky backend for the large factorizations (Schur matrix H, NT
    # scaling's chol(X)): 'f64' the blocked f64 factorization; 'mixed' f32
    # panels + f64 Newton refinement with per-panel f64 fallback
    # (ops/mixed_chol.py, identical NaN/shift semantics); 'auto' resolves
    # to 'f64' on every platform (AUTO_BACKENDS).
    chol_backend: str = "auto"
    # High-precision mode (the reference's MultiFloats Float64xN equivalent,
    # `README.md:37-54`): 'f64' plain float64; 'dd' double-double — Schur
    # assembly, RHS/residual contractions, and Schur-solve iterative
    # refinement run in ~2x working precision via error-free transforms and
    # Ozaki-scheme sliced GEMMs (ops/dd.py, ops/ozaki.py). Works on BOTH
    # linear-system paths (kit=0 direct, and kit=1 where PCG is wrapped in
    # dd iterative refinement, matching the reference's Float64xN-typed CG,
    # `src/predictor_corrector.jl:131-134`); pushes the attainable DIMACS
    # floor ~3 digits below plain f64 (theta1: 9.3e-14 vs 9.7e-10) at a
    # constant-factor FLOP cost (all GEMM-shaped).
    # 'dd2' additionally STORES the iterates (X, S, y, LP variables) as
    # double-double pairs and runs every residual/update on the pairs —
    # the x4-class tier: the DIMACS floor is no longer pinned by f64
    # iterate storage (direct path only; see docs/precision.md).
    # Both need error-free transforms that the platform's compiler keeps
    # exact; validated() refuses them where it does not (AUTO_BACKENDS).
    precision: str = "f64"
    # Schur-assembly precision schedule. 'f64': always exact. 'f32': assemble
    # H with f32 GEMMs (ops/schur.py schur_group_mixed; requested at HIGHEST
    # precision, so never TF32) while total DIMACS > 1e-3, then rebuild with
    # the exact f64 assembly for the endgame; residuals/NT/DIMACS stay f64
    # throughout. Sparse-stored groups keep the exact gather path. 'auto'
    # resolves to 'f64' on every platform (AUTO_BACKENDS): no measured win
    # yet. Reference cost profile: `src/makeBBBB.jl:24-36`; the switch
    # mirrors the reference's hybrid-preconditioner rebuild mechanics
    # (`src/Solvers.jl:339-347`).
    assembly_precision: str = "f64"
    # NT-scaling arithmetic for the dd2 tier. The measured dd2 wall
    # (docs/precision.md "the f64 NT wall") is the f64 NT stack: past
    # mu ~ 1e-14 the congruent spectrum eig(L_x' S L_x) sinks below the
    # f64 formation noise and the scaling basis is noise. 'dd' runs the
    # NT factorizations natively in double-double (ops/dd_linalg.py:
    # dd Cholesky + GEMM-anchored dd Jacobi warm-started from the f64
    # eigenbasis) — the equivalent of the reference's type-generic
    # `prepare_W` at Float64x4 (`src/prepare_W.jl:41-45`,
    # `src/Solvers.jl:18`). 'f64' keeps the plain NT stack (the
    # dd2-without-dd-NT configuration whose floor the table in
    # docs/precision.md records). 'auto' = 'f64' unless precision='dd2',
    # where the platform's table entry decides (AUTO_BACKENDS).
    nt_precision: str = "auto"

    def validated(self, platform: Optional[str] = None) -> "Options":
        """Range-check options, auto-correcting out-of-range values with a
        warning (reference `src/Solvers.jl:263-291`), then resolve every
        'auto' backend for ``platform`` (default: JAX's default backend)."""
        o = dataclasses.replace(self)
        if o.kit < 0 or o.kit > 1:
            o.kit = 0
            _warn(f"Parameter kit out of range, setting kit = {o.kit}")
        if o.tol_cg < o.tol_cg_min and o.kit == 1:
            o.tol_cg = o.tol_cg_min
            _warn(f"Parameter tol_cg smaller than tol_cg_min, setting tol_cg = {o.tol_cg:.1e}")
        if o.tol_cg_min > o.eDIMACS and o.kit == 1:
            o.tol_cg_min = o.eDIMACS
            _warn(f"Parameter tol_cg_min switched to eDIMACS = {o.eDIMACS:.1e}")
        if o.kit == 1 and (o.preconditioner < 0 or o.preconditioner > 4):
            o.preconditioner = 1
            _warn(f"Parameter preconditioner out of range, setting preconditioner = {o.preconditioner}")
        if o.erank < 0:
            o.erank = 1
            _warn(f"Parameter erank negative, setting erank = {o.erank}")
        if o.datarank < -1:
            o.datarank = 0
            _warn(f"Parameter datarank out of range, setting datarank = {o.datarank}")
        if o.datasparsity is not None and o.datasparsity < 0:
            o.datasparsity = None
            _warn("Parameter datasparsity negative, using automatic selection")
        if o.initpoint < 0 or o.initpoint > 1:
            o.initpoint = 1
            _warn(f"Parameter initpoint out of range, setting initpoint = {o.initpoint}")
        if o.dtype not in ("float32", "float64"):
            raise ValueError(f"dtype must be 'float32' or 'float64', got {o.dtype!r}")
        if o.nt_method not in ("eigh", "svd"):
            raise ValueError(f"nt_method must be 'eigh' or 'svd', got {o.nt_method!r}")
        _check_choice("step_eig", o.step_eig, STEP_EIG_CHOICES)
        _check_eigh_backend(o.eigh_backend)
        if o.gemm_backend not in ("f64", "int8"):
            raise ValueError(
                f"gemm_backend must be 'f64' or 'int8', got {o.gemm_backend!r}"
            )
        if o.chol_backend not in ("auto", "f64", "mixed"):
            raise ValueError(
                f"chol_backend must be 'auto', 'f64', or 'mixed', got "
                f"{o.chol_backend!r}"
            )
        if o.cg_materialize not in ("auto", "never", "always"):
            raise ValueError(
                "cg_materialize must be 'auto', 'never', or 'always', got "
                f"{o.cg_materialize!r}"
            )
        if o.precision not in ("f64", "dd", "dd2"):
            raise ValueError(
                f"precision must be 'f64', 'dd', or 'dd2', got {o.precision!r}"
            )
        if o.assembly_precision not in ("auto", "f64", "f32"):
            raise ValueError(
                f"assembly_precision must be 'auto', 'f64', or 'f32', got "
                f"{o.assembly_precision!r}"
            )
        if o.assembly_precision == "f32" and o.precision != "f64":
            raise ValueError(
                "assembly_precision='f32' conflicts with high-precision "
                "modes (precision='dd'/'dd2')"
            )
        if o.nt_precision not in ("auto", "f64", "dd"):
            raise ValueError(
                f"nt_precision must be 'auto', 'f64', or 'dd', got "
                f"{o.nt_precision!r}"
            )
        if o.nt_precision == "dd" and o.precision != "dd2":
            raise ValueError(
                "nt_precision='dd' (native dd NT scaling) requires "
                "precision='dd2' (dd-stored iterates feed the dd "
                "factorizations)"
            )
        if o.precision in ("dd", "dd2") and o.dtype != "float64":
            raise ValueError(f"precision={o.precision!r} requires dtype='float64'")
        if o.pad_multiple < 1:
            o.pad_multiple = 1
        return resolve_backends(o, platform)

    @classmethod
    def from_dict(cls, options: Optional[Dict[str, Any]] = None) -> "Options":
        """Build from a flat string-keyed dict (reference `load`); unknown
        keys raise, matching the MOI adapter's attribute validation."""
        options = dict(options or {})
        fields = {f.name for f in dataclasses.fields(cls)}
        removed = sorted(set(options) & set(REMOVED_OPTIONS))
        if removed:
            raise ValueError(
                "; ".join(f"option {k!r} was removed: {REMOVED_OPTIONS[k]}"
                          for k in removed)
            )
        unknown = set(options) - fields
        if unknown:
            raise ValueError(f"Unknown option(s): {sorted(unknown)}; known: {sorted(fields)}")
        return cls(**options)


def _warn(msg: str) -> None:
    warnings.warn(msg, stacklevel=3)


STEP_EIG_CHOICES = ("auto", "exact", "chol", "lanczos")
EIGH_BACKEND_CHOICES = ("auto", "xla", "jacobi", "mixed")

# Values and options that are gone, with the reason the error gives.
_PALLAS_GONE = (
    "the Pallas Jacobi kernel was removed; use 'auto' or one of the "
    "remaining choices"
)
REMOVED_VALUES = {
    ("step_eig", "pallas"): _PALLAS_GONE,
    ("eigh_backend", "pallas"): _PALLAS_GONE,
}
REMOVED_OPTIONS = {
    "cg_kernel": (
        "the fused Pallas CG kernels were removed; the materialized kit=1 "
        "path always runs the f64 split-preconditioned CG (ops/cg.py)"
    ),
}


def _check_eigh_backend(value) -> None:
    """A choice, or a size rule ((max_m, solver), ..., (None, solver)) as
    'auto' resolves to (ops/eigh.py eigh_backend_for)."""
    if isinstance(value, tuple):
        ok = (
            len(value) > 0
            and all(isinstance(e, tuple) and len(e) == 2 for e in value)
            and all(s in EIGH_BACKEND_CHOICES[1:] for _, s in value)
            and value[-1][0] is None
            and all(isinstance(mx, int) for mx, _ in value[:-1])
        )
        if not ok:
            raise ValueError(f"malformed eigh_backend size rule {value!r}")
        return
    _check_choice("eigh_backend", value, EIGH_BACKEND_CHOICES)


def _check_choice(name: str, value: str, choices) -> None:
    gone = REMOVED_VALUES.get((name, value))
    if gone is not None:
        raise ValueError(f"{name}={value!r} was removed: {gone}")
    if value not in choices:
        raise ValueError(
            f"{name} must be one of {', '.join(map(repr, choices))}; "
            f"got {value!r}"
        )


# What each 'auto' option becomes on each JAX platform. This table is the
# only platform decision in the package. The GPU row was set from on-card
# timings and checks (PERF.md "Bring-up findings"); the CPU row keeps the
# choices the CPU test suite was built on.
#   eigh_backend   eigensolver for NT scaling / preconditioner / 'exact',
#                  as a size rule ((max_m, solver), ..., (None, solver))
#   step_eig       steplength spectra method
#   chol_backend   large factorizations
#   assembly_precision   Schur assembly arithmetic
#   nt_precision   NT arithmetic under precision='dd2' (f64 otherwise)
#   dd_exact       whether the compiler keeps TwoSum/TwoProd exact; where
#                  it does not (a string gives the reason), precision='dd'
#                  and 'dd2' are refused
#   dd_nt_compiler_options   jit compiler options for the chunk that runs
#                  nt_precision='dd' (ipm/step.py jitted_chunk)
#   persistent_cache   keep compiled executables on disk across processes
#                  (loraine_tpu/__init__.py)
AUTO_BACKENDS = {
    "cpu": {
        # the XLA-level Jacobi below m=192 (small relative error on graded
        # spectra), the f32-seed + f64-refinement solver above it
        "eigh_backend": ((192, "jacobi"), (None, "mixed")),
        "step_eig": "exact",
        "chol_backend": "f64",
        "assembly_precision": "f64",
        # XLA:CPU's compile of the dd Jacobi graph blows up in memory
        # (62 GB RSS at m >= 16): dd NT stays an explicit opt-in there
        "nt_precision": "f64",
        "dd_exact": True,
        # the same blow-up hits the explicit nt_precision='dd' chunk at
        # XLA:CPU's default opt level; level 1 compiles it
        "dd_nt_compiler_options": {"xla_backend_optimization_level": 1},
        "persistent_cache": False,
    },
    "gpu": {
        # cuSOLVER f64 at small and large m, the f32-seed + f64-refinement
        # solver in between (timed on an H100 at m = 5..801, PERF.md); the
        # XLA-level Jacobi loses at every size on the card
        "eigh_backend": ((64, "xla"), (512, "mixed"), (None, "xla")),
        "step_eig": "exact",
        "chol_backend": "f64",
        "assembly_precision": "f64",
        "nt_precision": "f64",
        "dd_exact": True,
        "dd_nt_compiler_options": None,
        "persistent_cache": True,
    },
}


def backend_table(platform: Optional[str] = None) -> Dict[str, Any]:
    """The AUTO_BACKENDS row for ``platform`` (default: JAX's default
    backend). An unknown platform is an error, not a default."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    table = AUTO_BACKENDS.get(platform)
    if table is None:
        raise ValueError(
            f"no backend choices for platform {platform!r}; known: "
            f"{sorted(AUTO_BACKENDS)}"
        )
    return table


def resolve_backends(opts: "Options", platform: Optional[str] = None) -> "Options":
    """Return a copy of ``opts`` with every 'auto' backend option replaced
    by the concrete choice for ``platform`` ('cpu', 'gpu'; default: JAX's
    default backend). An unknown platform is an error, not a default."""
    table = backend_table(platform)
    o = dataclasses.replace(opts)
    if o.precision in ("dd", "dd2") and table["dd_exact"] is not True:
        raise ValueError(
            f"precision={o.precision!r} is not available on this platform: "
            f"{table['dd_exact']}"
        )
    for name in ("eigh_backend", "step_eig", "chol_backend",
                 "assembly_precision"):
        if getattr(o, name) == "auto":
            setattr(o, name, table[name])
    if o.nt_precision == "auto":
        o.nt_precision = table["nt_precision"] if o.precision == "dd2" else "f64"
    return o


DEFAULT_OPTIONS = Options()
