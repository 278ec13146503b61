"""Sparse-data storage path: gather-based contractions vs the dense oracle,
and end-to-end solves routed through sparse storage (the batched
equivalent of the reference's three-regime sparse Schur assembly)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import loraine_tpu as lt
from loraine_tpu.ops.schur import Aadj, Aop, schur_group


def _sparse_random(seed=0, nb=2, n=40, m=12, nnz=3):
    rng = np.random.default_rng(seed)
    As = []
    for _ in range(nb):
        A = np.zeros((n, m, m))
        for j in range(n):
            for _ in range(nnz):
                r, c = rng.integers(0, m, 2)
                v = rng.standard_normal()
                A[j, r, c] += v
                if r != c:
                    A[j, c, r] += v
        As.append(A)
    Cs = []
    for _ in range(nb):
        C = rng.standard_normal((m, m))
        Cs.append(C @ C.T + m * np.eye(m))
    b = rng.standard_normal(n)
    return As, Cs, b


def test_sparse_contractions_match_dense():
    As, Cs, b = _sparse_random()
    pd = lt.problem_from_dense(As, Cs, b, storage="dense", pad_multiple=4)
    ps = lt.problem_from_dense(As, Cs, b, storage="sparse", pad_multiple=4)
    (gd,), (gs,) = pd.groups, ps.groups
    assert gs.is_sparse and not gd.is_sparse

    rng = np.random.default_rng(1)
    W = rng.standard_normal((gd.nb, gd.m, gd.m))
    W = jnp.asarray(W @ W.transpose(0, 2, 1) + gd.m * np.eye(gd.m))
    G = jnp.linalg.cholesky(W)
    X = W  # any symmetric batch
    y = jnp.asarray(rng.standard_normal(pd.n))

    np.testing.assert_allclose(np.asarray(Aop(gs, X)), np.asarray(Aop(gd, X)), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(Aadj(gs, y)), np.asarray(Aadj(gd, y)), rtol=1e-10, atol=1e-12)
    Hs = schur_group(gs, W, G)
    Hd = schur_group(gd, W, G)
    np.testing.assert_allclose(np.asarray(Hs), np.asarray(Hd), rtol=1e-9, atol=1e-9)


def test_sparse_solve_matches_dense_e2e():
    As, Cs, b = _sparse_random(seed=5)
    pd = lt.problem_from_dense(As, Cs, b, storage="dense")
    ps = lt.problem_from_dense(As, Cs, b, storage="sparse")
    rd = lt.solve(pd, {"kit": 0, "eDIMACS": 1e-7, "verb": 0})
    rs = lt.solve(ps, {"kit": 0, "eDIMACS": 1e-7, "verb": 0})
    assert rd.status == rs.status == 1
    np.testing.assert_allclose(rs.objective, rd.objective, rtol=1e-7)
    assert rs.iterations == rd.iterations


def test_sparse_iterative_with_alpha():
    As, Cs, b = _sparse_random(seed=7, nb=1, n=30, m=10)
    ps = lt.problem_from_dense(As, Cs, b, storage="sparse")
    rs = lt.solve(
        ps,
        {"kit": 1, "preconditioner": 1, "eDIMACS": 1e-5, "tol_cg_min": 1e-6, "verb": 0},
    )
    pd = lt.problem_from_dense(As, Cs, b, storage="dense")
    rd = lt.solve(pd, {"kit": 0, "eDIMACS": 1e-7, "verb": 0})
    assert rs.status == 1
    np.testing.assert_allclose(rs.objective, rd.objective, rtol=1e-4)


def test_tru3_auto_routes_and_solves(data_dir):
    # tru3: many tiny-support matrices; auto storage should pick sparse when
    # n >= 256 (tru3 has n=544)... verify whatever auto picks solves right
    prob = lt.problem_from_sdpa(str(data_dir / "tru3.dat-s"))
    res = lt.solve(prob, {"kit": 0, "eDIMACS": 1e-7, "initpoint": 1, "verb": 0})
    assert res.status == 1
    prob_sparse = lt.problem_from_sdpa(str(data_dir / "tru3.dat-s"), storage="sparse")
    assert all(g.is_sparse for g in prob_sparse.groups)
    res_s = lt.solve(prob_sparse, {"kit": 0, "eDIMACS": 1e-7, "initpoint": 1, "verb": 0})
    assert res_s.status == 1
    np.testing.assert_allclose(res_s.objective, res.objective, rtol=1e-6)


def test_datasparsity_option_drives_storage_split(tmp_path):
    """`datasparsity` is the nnz threshold for the dense/sparse kernel split
    (reference `src/model.jl:153-174`, docs/src/Loraine_options.md:52-56):
    0 forces dense, an explicit k makes matrices with nnz <= k sparse at any
    n, and the default (None) keeps the calibrated auto heuristic."""
    from loraine_tpu.config import Options
    from loraine_tpu.problem import problem_from_sdpa

    # tru3: sparse truss data (small support per matrix), n < 256 so the
    # auto heuristic keeps it dense, but an explicit threshold flips it
    path = "tests/data/tru3.dat-s"

    def storage_for(opts):
        p = lt.load_problem(path, opts)
        return [g.is_sparse for g in p.groups]

    assert not any(storage_for({}))  # auto cost model: tiny n -> dense
    assert not any(storage_for({"datasparsity": 0}))  # force dense
    assert all(storage_for({"datasparsity": 64}))  # explicit threshold
    assert not any(storage_for({"datasparsity": 1}))  # threshold below nnz

    # solves agree across the split
    r_dense = lt.solve_sdpa(path, {"verb": 0, "eDIMACS": 1e-6, "datasparsity": 0})
    r_sparse = lt.solve_sdpa(path, {"verb": 0, "eDIMACS": 1e-6, "datasparsity": 64})
    assert r_dense.status == r_sparse.status == 1
    np.testing.assert_allclose(r_dense.objective, r_sparse.objective, rtol=1e-6)


def test_kojima_cost_model_reproduces_shipped_decisions():
    """The modeled-cost auto-selection (problem.py pick_storage; Kojima et
    al. cost-comparison idea, reference `src/model.jl:234-287` carried
    commented-out) reproduces the measured-good storage choices for every
    shipped SDPLIB instance. Stats (n, per-block (m0, smax)) are the parsed
    values of the .dat-s files (see also the e2e check below)."""
    from loraine_tpu.problem import pick_storage

    cases = {
        # file: (n, [(m0, smax)...], expected)
        "theta1": (104, [(50, 50)], "dense"),
        "control1": (21, [(5, 2), (10, 36)], "dense"),
        "tru3": (36, [(13, 16)], "dense"),
        "vib3": (36, [(12, 16), (13, 16)], "dense"),
        "tru9": (3240, [(145, 16)], "sparse"),
        "vib9": (3240, [(144, 16), (145, 16)], "sparse"),
        "maxG11": (800, [(800, 1)], "sparse"),
        "thetaG11": (2401, [(801, 9)], "sparse"),
    }
    for name, (n, stats, expected) in cases.items():
        assert pick_storage(n, stats) == expected, name


def test_kojima_cost_model_formulas():
    from loraine_tpu.problem import (
        GATHER_PENALTY, SPARSE_OVERHEAD, schur_cost_dense, schur_cost_sparse,
        pick_storage,
    )

    # formulas match their definitions
    assert schur_cost_dense(10, 4, nb=2) == 2 * (10 * 64 + 100 * 16)
    assert schur_cost_sparse(10, 4, 3, nb=2) == 2 * (
        10 * 3 * 16 + GATHER_PENALTY * 100 * 3
    )
    # monotonicity: denser data (larger s) penalizes the sparse path...
    assert schur_cost_sparse(500, 64, 32) > schur_cost_sparse(500, 64, 4)
    # ...larger blocks (m^3 vs m^2 terms) penalize the dense path faster
    d_ratio = schur_cost_dense(500, 128) / schur_cost_dense(500, 64)
    s_ratio = schur_cost_sparse(500, 128, 8) / schur_cost_sparse(500, 64, 8)
    assert d_ratio > s_ratio
    # the fixed overhead keeps tiny problems dense even for very sparse data
    assert pick_storage(32, [(16, 2)]) == "dense"
    assert SPARSE_OVERHEAD > schur_cost_dense(32, 16)


def test_kojima_cost_model_e2e_matches_loader(data_dir):
    """load_problem (datasparsity=None -> cost model) agrees with the
    direct pick_storage calls on the real files (dense cases checked here;
    the large sparse-path files are exercised by the bench/slow tests)."""
    for name, kind in [("theta1", False), ("control1", False),
                       ("tru3", False), ("vib3", False)]:
        p = lt.load_problem(str(data_dir / f"{name}.dat-s"), {})
        assert all(g.is_sparse == kind for g in p.groups), name
