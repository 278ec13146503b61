"""loraine_tpu: a low-rank interior-point SDP solver in JAX.

A from-scratch JAX/XLA framework with the capabilities of Loraine.jl
(primal-dual predictor-corrector interior point method for linear SDPs with
low-rank structure exploitation), built as batched block groups, einsum
Schur assembly, jit-compiled iterations, and mesh sharding for multi-device
scale-out.

Quick start::

    import loraine_tpu as lt
    res = lt.solve_sdpa("theta1.dat-s", {"eDIMACS": 1e-6})
    print(res.objective)

or from raw data::

    prob = lt.problem_from_dense(As, Cs, b)
    res = lt.solve(prob, {"kit": 0})
"""
import os as _os

import jax as _jax

# The IPM requires float64 for late iterations (the reference goes further
# with MultiFloats Float64xN); enable x64 before any arrays are created.
_jax.config.update("jax_enable_x64", True)

_persistent_cache_enabled = False

# <checkout>/.jax_cache: fixed, so a later process finds what an earlier
# one compiled (the path is part of the cache key)
DEFAULT_CACHE_DIR = _os.path.abspath(
    _os.path.join(_os.path.dirname(__file__), "..", ".jax_cache")
)


def _enable_persistent_cache() -> None:
    """Persistent compilation cache for accelerator runs: the fused IPM
    chunk takes tens of seconds to compile per problem shape, and each new
    process would pay that again. When ``JAX_COMPILATION_CACHE_DIR`` is set,
    JAX already reads it and nothing is set here; otherwise the cache goes
    to `DEFAULT_CACHE_DIR`. Platforms whose table row says no (the CPU:
    the XLA:CPU AOT loader warns about feature mismatches when reloading
    CPU executables, and CPU compiles are cheap anyway) skip it. Called
    lazily (first Solver.solve) so backend selection has settled."""
    from .config import backend_table

    global _persistent_cache_enabled
    if _persistent_cache_enabled:
        return
    _persistent_cache_enabled = True
    if not backend_table()["persistent_cache"]:
        return
    if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        _jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    # cache every executable: the chunk's many small helper programs
    # (initial point, result extraction) each cost a GPU compile too
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

from . import modeling
from .config import Options, DEFAULT_OPTIONS
from .io.sdpa import SDPAData, read_sdpa, write_sdpa
from .io.poema import read_poema_json, write_poema_json, read_mat_dict
from .problem import (
    BlockGroup,
    SDPProblem,
    problem_from_dense,
    problem_from_dict,
    problem_from_sdpa,
)
from .ipm.admm import ADMMResult, solve_admm
from .ipm.solver import Result, Solver, load_problem, solve, solve_json, solve_sdpa
from .ipm.state import IPMState
from .utils.checkpoint import load_state, save_state

__version__ = "0.1.0"

__all__ = [
    "modeling",
    "Options",
    "DEFAULT_OPTIONS",
    "SDPAData",
    "read_sdpa",
    "write_sdpa",
    "BlockGroup",
    "SDPProblem",
    "problem_from_dense",
    "problem_from_dict",
    "problem_from_sdpa",
    "read_poema_json",
    "write_poema_json",
    "read_mat_dict",
    "Result",
    "Solver",
    "solve",
    "solve_sdpa",
    "load_problem",
    "solve_json",
    "solve_admm",
    "ADMMResult",
    "IPMState",
    "save_state",
    "load_state",
]
