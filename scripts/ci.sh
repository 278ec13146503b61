#!/usr/bin/env bash
# Local CI gate — mirrors .github/workflows/ci.yml (which mirrors the
# reference's CI: buildpkg -> runtest -> report, Loraine.jl
# .github/workflows/ci.yml:7-43) so the gate is actually executable in
# this environment. Runs the full suite on the CPU backend with 8 virtual
# devices, the multi-chip dryrun, and the graft-entry compile check.
# Fails loudly on the first red step. Nothing here needs a GPU; on a
# machine with one, `python chip_smoke.py` is the device gate.
set -euo pipefail
cd "$(dirname "$0")/.."

echo "== [1/4] test suite (CPU, 8 virtual devices; slow marked tests excluded) =="
JAX_PLATFORMS=cpu python -m pytest tests/ -q \
  -W "error::DeprecationWarning:loraine_tpu"

echo "== [2/4] slow tests (fresh process: the dd chunk compiles have aborted"
echo "   XLA:CPU when built late in a long-lived suite process) =="
JAX_PLATFORMS=cpu python -m pytest tests/ -q -m slow

echo "== [3/4] multi-chip dryrun (8 virtual devices) =="
JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python -c "import __graft_entry__ as g; g.dryrun_multichip(8)"

echo "== [4/4] graft entry compile check =="
JAX_PLATFORMS=cpu python - <<'EOF'
import jax, __graft_entry__ as g
fn, args = g.entry()
jax.jit(fn).lower(*args).compile()
print("entry() compiles")
EOF

echo "CI green."
