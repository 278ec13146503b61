"""Schur assembly and data-operator contractions vs naive dense oracles
(the reference enforces these only end-to-end; we unit-test per kernel,
SURVEY section 4 requirement)."""
import jax
import jax.numpy as jnp
import numpy as np

from loraine_tpu.problem import BlockGroup
from loraine_tpu.ops.schur import Aop, Aadj, schur_group, schur_lp


def _random_group(key, nb, n, m, rank1=False):
    ka, kc, kb = jax.random.split(key, 3)
    if rank1:
        B = jax.random.normal(kb, (nb, n, m), dtype=jnp.float64)
        sgn = jnp.where(jax.random.bernoulli(ka, 0.5, (nb, n)), 1.0, -1.0)
        A = jnp.einsum("bj,bjm,bjp->bjmp", sgn, B, B)
    else:
        A = jax.random.normal(ka, (nb, n, m, m), dtype=jnp.float64)
        A = (A + jnp.swapaxes(A, -1, -2)) / 2
        B = sgn = None
    C = jax.random.normal(kc, (nb, m, m), dtype=jnp.float64)
    C = (C + jnp.swapaxes(C, -1, -2)) / 2
    g = BlockGroup(
        C=C, A=None if rank1 else A, B=B, Bsgn=sgn,
        Arows=None, Acols=None, Avals=None,
        m=m, nb=nb, orig_sizes=(m,) * nb, orig_indices=tuple(range(nb)),
    )
    return g, A


def _random_spd(key, nb, m):
    a = jax.random.normal(key, (nb, m, m), dtype=jnp.float64)
    return a @ jnp.swapaxes(a, -1, -2) + m * jnp.eye(m, dtype=jnp.float64)


def test_aop_aadj_adjoint():
    key = jax.random.PRNGKey(1)
    g, A = _random_group(key, 2, 7, 6)
    X = _random_spd(jax.random.PRNGKey(2), 2, 6)
    y = jax.random.normal(jax.random.PRNGKey(3), (7,), dtype=jnp.float64)
    # <Aadj(y), X> == <y, Aop(X)>
    lhs = jnp.sum(Aadj(g, y) * X)
    rhs = jnp.dot(y, Aop(g, X))
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-12)


def test_schur_dense_vs_oracle():
    key = jax.random.PRNGKey(4)
    nb, n, m = 2, 5, 6
    g, A = _random_group(key, nb, n, m)
    W = _random_spd(jax.random.PRNGKey(5), nb, m)
    # G only used for rank-1; pass a Cholesky-like factor
    G = jnp.linalg.cholesky(W)
    H = schur_group(g, W, G)
    oracle = np.zeros((n, n))
    An, Wn = np.asarray(A), np.asarray(W)
    for b in range(nb):
        for j in range(n):
            for k in range(n):
                oracle[j, k] += np.trace(An[b, j] @ Wn[b] @ An[b, k] @ Wn[b])
    np.testing.assert_allclose(np.asarray(H), oracle, rtol=1e-10)


def test_schur_rank1_matches_dense():
    key = jax.random.PRNGKey(6)
    nb, n, m = 2, 5, 6
    g1, A = _random_group(key, nb, n, m, rank1=True)
    gdense = BlockGroup(
        C=g1.C, A=A, B=None, Bsgn=None,
        Arows=None, Acols=None, Avals=None, m=m, nb=nb,
        orig_sizes=g1.orig_sizes, orig_indices=g1.orig_indices,
    )
    Wf = _random_spd(jax.random.PRNGKey(7), nb, m)
    G = jnp.linalg.cholesky(Wf)
    W = G @ jnp.swapaxes(G, -1, -2)
    H1 = schur_group(g1, W, G)
    H2 = schur_group(gdense, W, G)
    np.testing.assert_allclose(np.asarray(H1), np.asarray(H2), rtol=1e-9)
    # operators agree too
    X = _random_spd(jax.random.PRNGKey(8), nb, m)
    np.testing.assert_allclose(np.asarray(Aop(g1, X)), np.asarray(Aop(gdense, X)), rtol=1e-9)
    y = jax.random.normal(jax.random.PRNGKey(9), (n,), dtype=jnp.float64)
    np.testing.assert_allclose(np.asarray(Aadj(g1, y)), np.asarray(Aadj(gdense, y)), rtol=1e-9, atol=1e-9)


def test_schur_lp_oracle():
    key = jax.random.PRNGKey(10)
    C_lin = jax.random.normal(key, (5, 3), dtype=jnp.float64)
    w = jnp.abs(jax.random.normal(jax.random.PRNGKey(11), (3,), dtype=jnp.float64))
    H = schur_lp(C_lin, w)
    oracle = np.asarray(C_lin) @ np.diag(np.asarray(w)) @ np.asarray(C_lin).T
    np.testing.assert_allclose(np.asarray(H), oracle, rtol=1e-12)


def test_dense_chunked_assembly_matches_fused():
    """_schur_dense_chunked (the bounded-memory dense path for large
    constraint counts; used when nb*n*m^2 exceeds the HBM-safe threshold)
    produces the same H as the fused three-einsum path."""
    import numpy as np
    import jax.numpy as jnp

    import loraine_tpu as lt
    from loraine_tpu.ops.schur import _schur_dense_chunked

    rng = np.random.default_rng(0)
    nb, n, m = 2, 50, 12
    A = rng.standard_normal((nb, n, m, m))
    A = A + A.transpose(0, 1, 3, 2)
    p = lt.problem_from_dense(
        list(A), [np.eye(m) * m] * nb, np.zeros(n), storage="dense",
        pad_multiple=1,
    )
    g = p.groups[0]
    W = rng.standard_normal((g.nb, g.m, g.m))
    W = jnp.asarray(W @ W.transpose(0, 2, 1) + g.m * np.eye(g.m))
    T = jnp.einsum("bpa,bjaq->bjpq", W, g.A)
    T = jnp.einsum("bjpq,bqr->bjpr", T, W)
    H_ref = jnp.einsum("bjpq,bkpq->jk", g.A, T)
    H_chunk = _schur_dense_chunked(g, W)
    np.testing.assert_allclose(
        np.asarray(H_chunk), np.asarray(H_ref),
        rtol=1e-9, atol=1e-9 * float(jnp.abs(H_ref).max()),
    )


def test_mixed_assembly_matches_f64():
    """schur_group_mixed (f32 fast assembly) tracks the exact H to
    f32-accumulate class (~1e-5 relative) on all three storages, and
    schur_lp_mixed on the LP block."""
    import numpy as np
    import jax.numpy as jnp

    import loraine_tpu as lt
    from loraine_tpu.ops.schur import (
        schur_group, schur_group_mixed, schur_lp, schur_lp_mixed,
    )

    rng = np.random.default_rng(2)

    def relerr(Hm, H):
        H, Hm = np.asarray(H), np.asarray(Hm)
        return np.abs(Hm - H).max() / np.abs(H).max()

    # dense
    nb, n, m = 2, 40, 12
    A = rng.standard_normal((nb, n, m, m)); A = A + A.transpose(0, 1, 3, 2)
    p = lt.problem_from_dense(list(A), [np.eye(m) * m] * nb, np.zeros(n),
                              storage="dense", pad_multiple=1)
    g = p.groups[0]
    W = rng.standard_normal((g.nb, g.m, g.m))
    W = jnp.asarray(W @ W.transpose(0, 2, 1) + g.m * np.eye(g.m))
    G = jnp.linalg.cholesky(W)
    assert relerr(schur_group_mixed(g, W, G), schur_group(g, W, G)) < 1e-5

    # sparse: schur_group_mixed keeps sparse groups on the exact f64
    # gather path; the two f32 formulations it does not dispatch
    # (_schur_sparse_mixed, _schur_sparse_f32gather) stay numerically
    # correct
    As = np.zeros((n, m, m))
    for j in range(n):
        r, c = rng.integers(0, m, 2)
        v = rng.standard_normal(); As[j, r, c] += v
        if r != c: As[j, c, r] += v
        As[j, j % m, j % m] += 1.0
    ps = lt.problem_from_dense([As], [np.eye(m) * m], np.zeros(n),
                               storage="sparse", pad_multiple=1)
    assert ps.groups[0].A_flat32 is None  # never built on load
    gs = ps.groups[0]
    Ws = W[:1]
    assert relerr(schur_group_mixed(gs, Ws, G[:1]), schur_group(gs, Ws, G[:1])) < 1e-5
    from loraine_tpu.ops.schur import _schur_sparse_f32gather, _schur_sparse_mixed
    from loraine_tpu.problem import ensure_a_flat32
    ps2 = ensure_a_flat32(ps)
    gs2 = ps2.groups[0]
    assert gs2.A_flat32 is not None
    assert relerr(_schur_sparse_mixed(gs2, Ws), schur_group(gs2, Ws, G[:1])) < 1e-5
    assert relerr(_schur_sparse_f32gather(gs, Ws), schur_group(gs, Ws, G[:1])) < 1e-5

    # rank-1
    V = rng.standard_normal((n, m))
    Ar = np.einsum("jp,jq->jpq", V, V)
    pr = lt.problem_from_dense([Ar], [np.eye(m) * m], np.zeros(n),
                               datarank=-1, pad_multiple=1)
    gr = pr.groups[0]
    assert gr.is_rank1
    assert relerr(schur_group_mixed(gr, Ws, G[:1]), schur_group(gr, Ws, G[:1])) < 1e-4

    # LP block
    C_lin = rng.standard_normal((n, 17))
    w = np.abs(rng.standard_normal(17)) + 0.1
    assert relerr(schur_lp_mixed(jnp.asarray(C_lin), jnp.asarray(w)),
                  schur_lp(jnp.asarray(C_lin), jnp.asarray(w))) < 1e-5


def test_mixed_assembly_e2e_and_validation():
    import pytest as _pytest

    import loraine_tpu as lt

    r64 = lt.solve_sdpa("tests/data/theta1.dat-s",
                        {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0})
    r32 = lt.solve_sdpa("tests/data/theta1.dat-s",
                        {"kit": 0, "eDIMACS": 1e-6, "initpoint": 1, "verb": 0,
                         "assembly_precision": "f32"})
    assert r32.status == 1
    assert abs(r32.objective - r64.objective) < 1e-6
    assert abs(r32.iterations - r64.iterations) <= 2
    with _pytest.raises(ValueError):
        lt.Options(assembly_precision="f32", precision="dd").validated()
    with _pytest.raises(ValueError):
        lt.Options(assembly_precision="bogus").validated()
