#!/usr/bin/env python
"""Per-phase device timing for one IPM step on a given problem.

    python benchmarks/profile_phases.py tests/data/maxG11.dat-s --datarank -1

Times, with block_until_ready and warm jit caches, on JAX's default device:
  - nt_scale per group
  - Schur assembly + Cholesky solve
  - steplength eigmin path
  - one full fused step
  - full fused step WITHOUT fetching stats (dispatch-to-dispatch)
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import loraine_tpu as lt
from loraine_tpu.config import Options
from loraine_tpu.ipm.initial import initial_point
from loraine_tpu.ipm.step import jitted_step
from loraine_tpu.ops.nt_scaling import nt_scale
from loraine_tpu.ops.linalg import chol_reg, cho_solve
from loraine_tpu.ops.schur import schur_group
from loraine_tpu.problem import problem_from_sdpa


def timeit(fn, n=10):
    fn()  # warm
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("path")
    ap.add_argument("--iters", type=int, default=5, help="IPM iterations to advance before timing")
    ap.add_argument("--datarank", type=int, default=0)
    ap.add_argument("--kit", type=int, default=0)
    args = ap.parse_args()

    lt._enable_persistent_cache()
    opts = Options.from_dict({"kit": args.kit, "datarank": args.datarank, "verb": 0}).validated()
    problem = problem_from_sdpa(args.path, datarank=opts.datarank)
    state = initial_point(problem, opts)
    step = jitted_step(opts, opts.preconditioner if args.kit else -1)
    tol = jnp.asarray(1e-2, dtype=problem.b.dtype)

    # advance to a mid-solve iterate
    for _ in range(args.iters):
        state, stats = step(problem, state, tol)
    jax.block_until_ready(state)

    # 1. nt_scale per group
    for gi, (g, X, S) in enumerate(zip(problem.groups, state.X, state.S)):
        nt_fn = jax.jit(lambda X, S: nt_scale(X, S, method=opts.nt_method,
                                              eigh_backend=opts.eigh_backend,
                                              chol_backend=opts.chol_backend))
        dt = timeit(lambda: nt_fn(X, S))
        print(f"nt_scale group{gi} nb={X.shape[0]} m={X.shape[-1]}: {dt*1e3:9.2f} ms")

    # 2. Schur assembly (per group) + chol + solve
    nts = [nt_scale(X, S, method=opts.nt_method, eigh_backend=opts.eigh_backend,
                    chol_backend=opts.chol_backend)
           for X, S in zip(state.X, state.S)]
    for gi, (g, nt) in enumerate(zip(problem.groups, nts)):
        sg = jax.jit(lambda W, G, g=g: schur_group(g, W, G))
        dt = timeit(lambda: sg(nt.W, nt.G))
        print(f"schur group{gi}          : {dt*1e3:9.2f} ms")

    H = sum(schur_group(g, nt.W, nt.G) for g, nt in zip(problem.groups, nts))
    H = 0.5 * (H + H.T)
    ch = jax.jit(lambda H: chol_reg(H, 1e-4, 1000).L)
    dt = timeit(lambda: ch(H))
    print(f"chol_reg H n={problem.n}      : {dt*1e3:9.2f} ms")
    L = ch(H)
    cs = jax.jit(lambda L, b: cho_solve(L, b))
    dt = timeit(lambda: cs(L, problem.b))
    print(f"cho_solve                 : {dt*1e3:9.2f} ms")

    # 3. steplength eigmin (the _group_dirs tail): the step's own
    # steplength_eigmin on a [2nb, m, m] stack
    from loraine_tpu.ipm.step import steplength_eigmin

    em = jax.jit(steplength_eigmin(opts))
    for gi, (g, nt, X) in enumerate(zip(problem.groups, nts, state.X)):
        m = X.shape[-1]
        Mtest = jnp.concatenate([X / jnp.max(jnp.abs(X)), X / jnp.max(jnp.abs(X))], axis=0)
        dt = timeit(lambda: em(Mtest))
        print(f"steplength {opts.step_eig}/{opts.eigh_backend} g{gi} "
              f"[{Mtest.shape[0]},{m}]: {dt*1e3:9.2f} ms")

    # 4. full step, with and without stats fetch
    def one_fetch():
        s2, st2 = step(problem, state, tol)
        jax.device_get(st2)
        return s2
    dt = timeit(one_fetch, n=5)
    print(f"full step + stats fetch   : {dt*1e3:9.2f} ms")

    def chain(k=5):
        s = state
        for _ in range(k):
            s, st2 = step(problem, s, tol)
        jax.block_until_ready(st2)
        return s
    f0 = time.perf_counter(); chain(); d1 = time.perf_counter() - f0
    f0 = time.perf_counter(); chain(); d2 = time.perf_counter() - f0
    print(f"full step chained (no per-iter fetch): {min(d1,d2)/5*1e3:9.2f} ms/step")


if __name__ == "__main__":
    main()
