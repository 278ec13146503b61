#!/usr/bin/env python
"""Multi-device scaling measurement (BASELINE.md north star: iterations/s
at 1 device / N devices, >= 70% scaling efficiency target).

Runs the jitted IPM step for a many-block SDP on meshes of increasing size
and reports steady-state step times + scaling efficiency, on whatever
devices JAX sees. On the GPUs of one host (all-to-all NVLink) it measures
the real collectives through NCCL:

    python benchmarks/scaling.py

Rehearsed on virtual CPU devices, it checks the sharding mechanics and the
collective accounting only (the times say nothing about a GPU):

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python benchmarks/scaling.py
"""
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
                "pred": 1, "s8": 1, "u8": 1, "c64": 8, "c128": 16}


def collective_bytes(compiled_text: str) -> dict:
    """Static collective-traffic accounting from compiled HLO: counts and
    output bytes of every cross-device op. Bytes/step are a property of the
    program, so a virtual-CPU rehearsal already gives them; wall-clock
    there says nothing about the interconnect."""
    out = {}
    # HLO line shapes:
    #   `%name = f64[128,64]{1,0} all-gather(%operand), ...`
    #   `%name = (f64[128]{0}, f64[64]{0}) all-reduce-start(%a, %b), ...`
    shape = r"(\w+)\[([\d,]*)\]\S*"
    pat = re.compile(
        r"=\s*(" + shape + r"|\((?:[^()]*)\))\s+"
        r"(all-gather|all-reduce|reduce-scatter|"
        r"collective-permute|all-to-all)(?:-start)?\("
    )
    one = re.compile(shape)
    for m in pat.finditer(compiled_text):
        shapes_txt, op = m.group(1), m.group(4)
        size = 0
        for sm in one.finditer(shapes_txt):
            dt, dims = sm.group(1), sm.group(2)
            s = _DTYPE_BYTES.get(dt, 8)
            for d in filter(None, dims.split(",")):
                s *= int(d)
            size += s
        rec = out.setdefault(op, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += size
    return out


def schur_axis_cg(sizes):
    """Distributed Schur solve (kit=1 CG sharded over the constraint axis):
    n >= 2000, single large-n dense data stack. H is never formed; each CG
    matvec contracts the sharded [n, m, m] data shard-locally and psums only
    [nb, m, m] partials (see ipm/step.py build_step `mesh`). Without the
    AT layout + sharding constraints this path was 20x SLOWER sharded than
    unsharded (XLA:CPU turned the partitioned vec@mat dot into a
    single-threaded strided loop fusion inside the CG while-loop).

    NOTE on efficiency numbers: virtual CPU devices share the host's
    physical cores, so there wall-clock speedup is bounded by the core
    count, not the device count — such a run validates that sharded step
    time does not DEGRADE and that per-device memory shrinks; real scaling
    needs real GPUs.
    """
    import jax
    import jax.numpy as jnp

    import loraine_tpu as lt
    from loraine_tpu.ipm.initial import initial_point
    from loraine_tpu.ipm.step import build_step
    from loraine_tpu.parallel.mesh import make_mesh, shard_problem, shard_state

    rng = np.random.default_rng(1)
    n, m = 2048, 64
    A = rng.standard_normal((n, m, m))
    A = (A + A.transpose(0, 2, 1)) / 2
    C = rng.standard_normal((m, m))
    C = C @ C.T + m * np.eye(m)
    prob = lt.problem_from_dense([A], [C], rng.standard_normal(n))
    opts = lt.Options(verb=0, kit=1, preconditioner=1,
                      cg_materialize="never").validated()
    st0 = initial_point(prob, opts)
    tol = jnp.asarray(1e-2, dtype=prob.b.dtype)
    results = []
    base = None
    for nd in sizes:
        mesh = make_mesh((1, nd), jax.devices()[:nd])
        step = jax.jit(build_step(opts, 1, mesh=mesh if nd > 1 else None))
        sp = shard_problem(prob, mesh)
        ss = shard_state(st0, prob, mesh)
        compiled = step.lower(sp, ss, tol).compile()
        out = compiled(sp, ss, tol)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(3):
            out = compiled(sp, ss, tol)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 3
        if base is None:
            base = dt
        results.append({
            "case": "schur-cg-n2048", "devices": nd,
            "step_ms": round(dt * 1e3, 1),
            "vs_1dev": round(base / dt, 2),
            "bytes_per_device_mb": round(2 * A.nbytes / nd / 1e6, 1),
            "collectives": collective_bytes(compiled.as_text()) if nd > 1 else {},
        })
        print(json.dumps(results[-1]), flush=True)
    return results


def schur_axis_direct(sizes):
    """Distributed DIRECT Schur solve (kit=0, n >= 2000): H is assembled
    with rows sharded over the schur axis and factorized by the distributed
    blocked Cholesky + tri_inv (ops/linalg.py `shard=`): the b x b panel
    work replicates (tiny), every O(n^3) GEMM runs shard-local, and GSPMD
    moves one [*, b] panel per step — H is never gathered whole (the
    round-2 fallback this replaces). Reported bytes/device cover the
    dominant per-device arrays (data shard + H/L/Li row shards)."""
    import jax
    import jax.numpy as jnp

    import loraine_tpu as lt
    from loraine_tpu.ipm.initial import initial_point
    from loraine_tpu.ipm.step import build_step
    from loraine_tpu.parallel.mesh import make_mesh, shard_problem, shard_state

    rng = np.random.default_rng(2)
    n, m = 2048, 64
    A = rng.standard_normal((n, m, m))
    A = (A + A.transpose(0, 2, 1)) / 2
    C = rng.standard_normal((m, m))
    C = C @ C.T + m * np.eye(m)
    prob = lt.problem_from_dense([A], [C], rng.standard_normal(n))
    opts = lt.Options(verb=0, kit=0).validated()
    st0 = initial_point(prob, opts)
    tol = jnp.asarray(1e-2, dtype=prob.b.dtype)
    results = []
    base = None
    for nd in sizes:
        mesh = make_mesh((1, nd), jax.devices()[:nd])
        step = jax.jit(build_step(opts, -1, mesh=mesh if nd > 1 else None))
        sp = shard_problem(prob, mesh)
        ss = shard_state(st0, prob, mesh)
        compiled = step.lower(sp, ss, tol).compile()
        out = compiled(sp, ss, tol)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(3):
            out = compiled(sp, ss, tol)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 3
        if base is None:
            base = dt
        h_bytes = 3 * (n * n // nd) * 8  # H + L + Li row shards
        results.append({
            "case": "schur-direct-n2048", "devices": nd,
            "step_ms": round(dt * 1e3, 1),
            "vs_1dev": round(base / dt, 2),
            "bytes_per_device_mb": round((A.nbytes / nd + h_bytes) / 1e6, 1),
            "collectives": collective_bytes(compiled.as_text()) if nd > 1 else {},
        })
        print(json.dumps(results[-1]), flush=True)
    return results


def maxg_direct(sizes, n=4096, edges_per_vertex=6):
    """Large-n distributed direct path on a REAL problem class (round-4
    VERDICT #8): a maxG-class cut relaxation (SDPLIB maxG11/maxG32 regime:
    one n x n block, n constraints, rank-1 data e_j e_j^T) at n=4096 —
    larger than every shipped SDPLIB instance. kit=0 with H rows sharded
    over the schur axis: rank-1 assembly ((B G)(B G)^T)**2 runs shard-
    local over H rows, the distributed blocked Cholesky + tri_inv
    factorizes without ever gathering H (ops/linalg.py shard=). Reports
    per-device memory for the dominant arrays (B factor + H/L/Li row
    shards) and static collective bytes/step from compiled HLO."""
    import jax
    import jax.numpy as jnp

    import loraine_tpu as lt
    from loraine_tpu.ipm.initial import initial_point
    from loraine_tpu.ipm.step import build_step
    from loraine_tpu.models.maxcut import maxcut_problem
    from loraine_tpu.parallel.mesh import make_mesh, shard_problem, shard_state

    rng = np.random.default_rng(7)
    W = np.zeros((n, n))
    for _ in range(n * edges_per_vertex // 2):
        i, j = rng.integers(0, n, 2)
        if i != j:
            w = 1.0 + rng.random()
            W[i, j] += w
            W[j, i] += w
    prob = maxcut_problem(W, datarank=-1)
    assert any(g.is_rank1 for g in prob.groups)
    opts = lt.Options(verb=0, kit=0).validated()
    st0 = initial_point(prob, opts)
    tol = jnp.asarray(1e-2, dtype=prob.b.dtype)
    b_bytes = n * n * 8  # rank-1 factor stack B [1, n, n]
    results = []
    base = None
    for nd in sizes:
        mesh = make_mesh((1, nd), jax.devices()[:nd])
        step = jax.jit(build_step(opts, -1, mesh=mesh if nd > 1 else None))
        sp = shard_problem(prob, mesh)
        ss = shard_state(st0, prob, mesh)
        compiled = step.lower(sp, ss, tol).compile()
        out = compiled(sp, ss, tol)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(2):
            out = compiled(sp, ss, tol)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / 2
        if base is None:
            base = dt
        h_bytes = 3 * (n * n // nd) * 8  # H + L + Li row shards
        results.append({
            "case": f"maxg-direct-n{n}", "devices": nd,
            "step_ms": round(dt * 1e3, 1),
            "vs_1dev": round(base / dt, 2),
            "bytes_per_device_mb": round((b_bytes / nd + h_bytes) / 1e6, 1),
            "collectives": collective_bytes(compiled.as_text()) if nd > 1 else {},
        })
        print(json.dumps(results[-1]), flush=True)
    return results


def main():
    import jax
    import jax.numpy as jnp

    import loraine_tpu as lt
    from loraine_tpu.ipm.initial import initial_point
    from loraine_tpu.ipm.step import build_step
    from loraine_tpu.parallel.mesh import make_mesh, shard_problem, shard_state

    rng = np.random.default_rng(0)
    nb, n, m = 16, 64, 32
    As, Cs = [], []
    for _ in range(nb):
        A = rng.standard_normal((n, m, m))
        As.append((A + A.transpose(0, 2, 1)) / 2)
        C = rng.standard_normal((m, m))
        Cs.append(C @ C.T + m * np.eye(m))
    b = rng.standard_normal(n)
    problem = lt.problem_from_dense(As, Cs, b)
    opts = lt.Options(verb=0).validated()
    state0 = initial_point(problem, opts)
    step = jax.jit(build_step(opts, -1))
    tol = jnp.asarray(1e-2, dtype=problem.b.dtype)

    ndev = len(jax.devices())
    results = []
    base = None
    sizes = [s for s in (1, 2, 4, 8, 16, 32) if s <= ndev]
    for nd in sizes:
        blocks_ax = min(nd, nb)
        mesh = make_mesh((blocks_ax, nd // blocks_ax), jax.devices()[:nd]) \
            if nd % blocks_ax == 0 else make_mesh((1, nd), jax.devices()[:nd])
        sp = shard_problem(problem, mesh)
        ss = shard_state(state0, problem, mesh)
        out = step(sp, ss, tol)
        jax.block_until_ready(out)  # compile
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            out = step(sp, ss, tol)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        if base is None:
            base = dt
        eff = base / (dt * nd)
        results.append({"devices": nd, "step_ms": round(dt * 1e3, 2),
                        "speedup": round(base / dt, 2), "efficiency": round(eff, 3)})
        print(json.dumps(results[-1]), flush=True)
    results += schur_axis_cg([s for s in (1, 2, 4, 8) if s <= ndev])
    results += schur_axis_direct([s for s in (1, 2, 4, 8) if s <= ndev])
    # the n=4096 maxG-class case costs ~6 min/step on a shared-core virtual
    # CPU mesh (it is sized for real chips); opt in via env
    if os.environ.get("LORAINE_SCALING_MAXG", "0") != "0":
        results += maxg_direct([s for s in (1, 8) if s <= ndev])
    return results


if __name__ == "__main__":
    main()
