"""Multi-device distribution: mesh + sharding annotations.

The reference is single-process with no distributed backend (SURVEY section 2
rows 19-21); this module is the greenfield equivalent. Strategy
(scaling-book recipe): pick a mesh, annotate shardings on the data, jit the
unchanged step, and let XLA insert the collectives:

- axis ``blocks``: shards stacked LMI blocks ``[nb, ...]`` — per-block NT
  scaling/eigh/chol run fully parallel; per-block Schur contributions are
  psum-reduced by XLA when the ``jk``-output einsum contracts the sharded
  ``b`` axis.
- axis ``schur``: shards the constraint axis ``n`` of the data operator —
  the T = W A W stage of Schur assembly is row-parallel; H rows materialize
  sharded and stay sharded through the DISTRIBUTED blocked Cholesky +
  tri_inv (ops/linalg.py ``shard=``: panel work replicated, all O(n^3)
  GEMMs shard-local, one [*, b] panel broadcast per step).

Small state (y, H factors) is replicated; X/S/W shard with their blocks.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..problem import SDPProblem
from ..ipm.state import IPMState

__all__ = ["make_mesh", "auto_mesh", "shard_problem", "shard_state"]


def make_mesh(shape: Sequence[int], devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Create a ('blocks', 'schur') mesh of the given shape."""
    devices = list(devices if devices is not None else jax.devices())
    nb, ns = shape
    if nb * ns != len(devices):
        raise ValueError(f"mesh shape {shape} needs {nb * ns} devices, have {len(devices)}")
    return Mesh(np.array(devices).reshape(nb, ns), ("blocks", "schur"))


def auto_mesh(problem: SDPProblem, devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Heuristic mesh: give the blocks axis as many devices as there are
    blocks to go around; the rest shard the constraint (schur) axis."""
    devices = list(devices if devices is not None else jax.devices())
    ndev = len(devices)
    max_nb = max((g.nb for g in problem.groups), default=1)
    blocks = 1
    for cand in range(min(ndev, max_nb), 0, -1):
        if ndev % cand == 0 and max_nb % cand == 0:
            blocks = cand
            break
    return make_mesh((blocks, ndev // blocks), devices)


def _put(x, mesh: Mesh, spec: P):
    return jax.device_put(x, NamedSharding(mesh, spec))


def shard_problem(problem: SDPProblem, mesh: Mesh) -> SDPProblem:
    """Place problem data on the mesh. Data is static per solve, so this is a
    one-time layout: A/B shard over (blocks, schur); C and NT-sized arrays
    over blocks; b and the LP data replicate.

    Axes that do not divide evenly fall back to replication for that
    dimension (device_put rejects uneven shards); the step still runs, with
    whatever parallelism the remaining annotations provide."""
    schur_ok = problem.n % mesh.shape["schur"] == 0
    saxname = "schur" if schur_ok else None
    groups = []
    for g in problem.groups:
        bspec = P("blocks") if g.nb % mesh.shape["blocks"] == 0 else P()
        baxis = bspec == P("blocks")
        baxname = "blocks" if baxis else None
        groups.append(
            type(g)(
                C=_put(g.C, mesh, P("blocks") if baxis else P()),
                A=None if g.A is None else _put(
                    g.A, mesh, P(baxname, saxname, None, None)
                ),
                AT=None if g.AT is None else _put(
                    g.AT, mesh, P(baxname, None, saxname)
                ),
                B=None if g.B is None else _put(g.B, mesh, P(baxname, saxname, None)),
                Bsgn=None if g.Bsgn is None else _put(g.Bsgn, mesh, P(baxname, saxname)),
                Arows=None if g.Arows is None else _put(g.Arows, mesh, P(baxname, saxname, None)),
                Acols=None if g.Acols is None else _put(g.Acols, mesh, P(baxname, saxname, None)),
                Avals=None if g.Avals is None else _put(g.Avals, mesh, P(baxname, saxname, None)),
                # mixed-assembly f32 copy shards like the COO (row axis on
                # schur): its GEMM consumers contract shard-local H rows
                A_flat32=None if g.A_flat32 is None else _put(
                    g.A_flat32, mesh, P(baxname, saxname, None)
                ),
                # dd2 per-cell adjoint layout: cell axis stays local (the
                # scatter target is per-block), so only blocks shards
                Acell=None if g.Acell is None else _put(
                    g.Acell, mesh, P(baxname, None)
                ),
                Acell_j=None if g.Acell_j is None else _put(
                    g.Acell_j, mesh, P(baxname, None, None)
                ),
                Acell_v=None if g.Acell_v is None else _put(
                    g.Acell_v, mesh, P(baxname, None, None)
                ),
                m=g.m,
                nb=g.nb,
                orig_sizes=g.orig_sizes,
                orig_indices=g.orig_indices,
                # host-side metadata must survive resharding: the initial
                # point (initpoint=1) sizes X/S from these norms — dropping
                # them produced zero-size state arrays
                data_norms=g.data_norms,
                C_norms=g.C_norms,
            )
        )
    return type(problem)(
        groups=tuple(groups),
        b=_put(problem.b, mesh, P()),
        C_lin=None if problem.C_lin is None else _put(problem.C_lin, mesh, P()),
        d_lin=None if problem.d_lin is None else _put(problem.d_lin, mesh, P()),
        n=problem.n,
        nlin=problem.nlin,
        nlmi=problem.nlmi,
        b_const=problem.b_const,
        sum_msizes=problem.sum_msizes,
    )


def shard_state(state: IPMState, problem: SDPProblem, mesh: Mesh) -> IPMState:
    Xs, Ss = [], []
    specs = []
    for g, X, S in zip(problem.groups, state.X, state.S):
        spec = P("blocks") if g.nb % mesh.shape["blocks"] == 0 else P()
        specs.append(spec)
        Xs.append(_put(X, mesh, spec))
        Ss.append(_put(S, mesh, spec))
    # dd2 iterate tails shard exactly like their hi words — dropping them
    # here would silently degrade a dd2 state to dd-class
    X_lo = S_lo = None
    if state.X_lo is not None:
        X_lo = tuple(_put(t, mesh, spec) for t, spec in zip(state.X_lo, specs))
        S_lo = tuple(_put(t, mesh, spec) for t, spec in zip(state.S_lo, specs))
    return IPMState(
        X=tuple(Xs),
        S=tuple(Ss),
        y=_put(state.y, mesh, P()),
        X_lin=None if state.X_lin is None else _put(state.X_lin, mesh, P()),
        S_lin=None if state.S_lin is None else _put(state.S_lin, mesh, P()),
        sigma=_put(state.sigma, mesh, P()),
        X_lo=X_lo,
        S_lo=S_lo,
        y_lo=None if state.y_lo is None else _put(state.y_lo, mesh, P()),
        X_lin_lo=None if state.X_lin_lo is None else _put(state.X_lin_lo, mesh, P()),
        S_lin_lo=None if state.S_lin_lo is None else _put(state.S_lin_lo, mesh, P()),
    )
