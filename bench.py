#!/usr/bin/env python
"""Benchmark entry point.

Solves the bench problems on the default JAX device:

  theta1    — SDPA input, direct solver kit=0, single small block
  tru9      — multi-block + LP cone (truss topology), direct, sparse data
  vib9      — vibration truss: 2 LMI blocks + LP cone, direct, sparse data
  control1  — control/arch class, iterative kit=1 + H_alpha preconditioner
  maxG11    — rank-one data compression (datarank=-1)
  thetaG11  — rank-one data compression, larger n
  (the sharded configuration is measured separately by benchmarks/scaling.py
   and gated by __graft_entry__.dryrun_multichip)

Each case solves to DIMACS 1e-5-or-better and reports steady-state IPM
iteration throughput (compile excluded by a warm-up solve), together with
the device it ran on.

Each case runs in its OWN child process, one after another, and the parent
never imports JAX: a JAX process reserves most of a GPU's memory when it
first touches the card, so two live JAX processes cannot share one, and a
case that dies takes only its own row with it.

Prints ONE JSON line: {"device": {...}, "per_problem": {...}}. The summary
metric is the next benchmark's design (ROADMAP Speed item 1).

Per-problem flop accounting (loraine_tpu/utils/flops.py): gflops_per_iter is
the modeled f64 flop budget of one IPM iteration (Schur assembly +
factorization + NT scaling + steplength spectra).
"""
import argparse
import json
import os
import subprocess
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))

CASES = [
    ("theta1", "tests/data/theta1.dat-s",
     {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0}),
    ("control1-cg", "tests/data/control1.dat-s",
     {"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-6,
      "initpoint": 1, "verb": 0}),
    ("tru9", "tests/data/tru9.dat-s",
     {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "verb": 0}),
    ("vib9", "tests/data/vib9.dat-s",
     {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "verb": 0}),
    ("maxG11", "tests/data/maxG11.dat-s",
     {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "datarank": -1, "verb": 0}),
    ("thetaG11", "tests/data/thetaG11.dat-s",
     {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "datarank": -1, "verb": 0}),
]

EXTRA_CASES = [
    ("control1", "tests/data/control1.dat-s",
     {"kit": 0, "eDIMACS": 1e-5, "initpoint": 1, "verb": 0}),
    ("theta1-cg", "tests/data/theta1.dat-s",
     {"kit": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-5, "preconditioner": 1,
      "initpoint": 1, "verb": 0}),
]

# Marker framing the per-case JSON row on the child's stdout so the parent
# can pick it out of any library noise.
ROW_MARK = "@@BENCH_ROW@@ "


def bench_case(name, path, opts):
    # warm-up solve compiles the step for this problem shape; the second
    # solve reuses the in-process jit cache, so its iteration times are
    # steady-state device times.
    import loraine_tpu as lt

    r1 = lt.solve_sdpa(path, dict(opts))
    if r1.status != 1:
        print(f"# {name}: warm-up status {r1.status_name}", file=sys.stderr)
    t0 = time.time()
    r2 = lt.solve_sdpa(path, dict(opts))
    wall = time.time() - t0
    # drop the first iteration (may still include some re-trace overhead)
    times = r2.iteration_times[1:] or r2.iteration_times
    per_iter = sum(times) / len(times)
    ips = 1.0 / per_iter
    print(
        f"# {name}: status={r2.status_name} iters={r2.iterations} "
        f"dimacs={r2.dimacs:.2e} obj={r2.objective:.6f} wall={wall:.2f}s "
        f"it/s={ips:.2f}",
        file=sys.stderr,
    )
    return ips, wall, r2


def run_case_child(name):
    """Child-process mode: run ONE case and print its JSON row (marked)."""
    import jax

    import loraine_tpu as lt
    from loraine_tpu.utils.flops import iteration_flops

    matches = [c for c in CASES + EXTRA_CASES if c[0] == name]
    if not matches:
        print(f"# unknown case {name!r}", file=sys.stderr)
        sys.exit(2)
    _, path, opts = matches[0]
    ips, wall, r = bench_case(name, path, opts)
    dev = jax.devices()[0]
    row = {
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "iters_per_sec": round(ips, 3),
        "wall_s": round(wall, 2),
        "iterations": r.iterations,
        "status": r.status_name,
        "dimacs": float(f"{r.dimacs:.3e}"),
    }
    # flop accounting: modeled per-iteration budget
    try:
        problem = lt.load_problem(path, dict(opts))
        kit = int(opts.get("kit", 0))
        cg_per_ipm = (
            r.cg_iterations / max(1, r.iterations) if kit == 1 else 0.0
        )
        fl = iteration_flops(problem, kit=kit, cg_iters_per_ipm=cg_per_ipm)
        row["gflops_per_iter"] = round(fl["total"] / 1e9, 2)
    except Exception as e:
        print(f"# {name} flop model failed: {e}", file=sys.stderr)
    print(ROW_MARK + json.dumps(row), flush=True)


def run_case_isolated(name, timeout):
    """Run one case in a fresh subprocess (sequential: one JAX process on
    the device at a time) and return its row dict, or an error row."""
    cmd = [sys.executable, os.path.abspath(__file__), "--case", name]
    try:
        proc = subprocess.run(
            cmd, cwd=_HERE, timeout=timeout,
            stdout=subprocess.PIPE, stderr=None, text=True,
        )
    except subprocess.TimeoutExpired:
        print(f"# {name} failed: timeout after {timeout:.0f}s", file=sys.stderr)
        return {"status": "BENCH_TIMEOUT"}
    for line in (proc.stdout or "").splitlines():
        if line.startswith(ROW_MARK):
            return json.loads(line[len(ROW_MARK):])
    print(f"# {name} failed: subprocess exited rc={proc.returncode} "
          f"with no result row", file=sys.stderr)
    return {"status": "BENCH_CRASH", "rc": proc.returncode}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="run extra cases")
    ap.add_argument("--case", help="(internal) run one named case in-process")
    ap.add_argument(
        "--budget", type=float, default=3600.0,
        help="wall-clock budget (s); remaining cases are skipped once "
        "exceeded")
    ap.add_argument(
        "--case-timeout", type=float, default=1800.0,
        help="per-case subprocess timeout (s)")
    args = ap.parse_args()

    if args.case:
        run_case_child(args.case)
        return

    # Parent: pure orchestration. Do NOT touch jax here — each child owns
    # the device while it runs.
    cases = CASES + (EXTRA_CASES if args.full else [])
    per_problem = {}
    device = None
    t_start = time.time()
    for name, path, opts in cases:
        elapsed = time.time() - t_start
        if elapsed > args.budget:
            print(f"# budget exceeded, skipping {name}", file=sys.stderr)
            continue
        timeout = min(args.case_timeout, args.budget - elapsed + 60.0)
        row = run_case_isolated(name, timeout)
        device = row.pop("device", device)
        per_problem[name] = row

    print(json.dumps({"device": device, "per_problem": per_problem}))


if __name__ == "__main__":
    main()
