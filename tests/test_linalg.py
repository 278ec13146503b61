"""Oracle tests for the blocked-linear-algebra kernels (ops/linalg.py)."""
import numpy as np
import jax.numpy as jnp
import pytest

from loraine_tpu.ops.linalg import chol_blocked, chol_reg, tri_inv, cho_solve_inv

rng = np.random.default_rng(11)


@pytest.mark.parametrize("n", [16, 128, 129, 257, 800])
def test_chol_blocked_matches_dense_oracle(n):
    A = rng.standard_normal((2, n, n))
    M = A @ np.swapaxes(A, -1, -2) + n * np.eye(n)
    L = np.asarray(chol_blocked(jnp.asarray(M)))
    Lref = np.linalg.cholesky(M)
    assert np.allclose(np.triu(L, 1), 0.0)
    scale = np.max(np.abs(Lref))
    assert np.max(np.abs(L - Lref)) <= 1e-12 * scale
    assert np.max(np.abs(L @ np.swapaxes(L, -1, -2) - M)) <= 1e-12 * np.max(np.abs(M))


def test_chol_blocked_nan_on_indefinite_batch_element():
    """NaN propagation semantics: chol_reg's retry loop keys on NaNs, so an
    indefinite element must produce them while clean elements stay clean."""
    B = rng.standard_normal((2, 200, 200))
    M = B @ np.swapaxes(B, -1, -2)
    M[0] -= (np.linalg.eigvalsh(M[0])[-1] + 1.0) * np.eye(200)
    L = np.asarray(chol_blocked(jnp.asarray(M)))
    assert np.isnan(L[0]).any()
    assert not np.isnan(L[1]).any()
    r = chol_reg(jnp.asarray(M), float(np.max(np.abs(M))), 1000)
    assert bool(r.ok)


def test_chol_blocked_graded_spd():
    """Graded SPD (IPM-late-iteration class): factorization stays accurate
    relative to the row scale."""
    n = 300
    d = np.logspace(0, -12, n)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    M = (Q * d) @ Q.T
    M = 0.5 * (M + M.T)
    L = np.asarray(chol_blocked(jnp.asarray(M)))
    resid = np.max(np.abs(L @ L.T - M)) / np.max(np.abs(M))
    assert resid <= 1e-13


def test_tri_inv_and_solve_roundtrip():
    n = 500
    A = rng.standard_normal((n, n))
    M = A @ A.T + n * np.eye(n)
    L = np.asarray(chol_blocked(jnp.asarray(M)))
    Li = np.asarray(tri_inv(jnp.asarray(L)))
    assert np.max(np.abs(Li @ L - np.eye(n))) <= 1e-10
    b = rng.standard_normal(n)
    x = np.asarray(cho_solve_inv(jnp.asarray(Li), jnp.asarray(b)))
    assert np.max(np.abs(M @ x - b)) / np.max(np.abs(b)) <= 1e-8


def test_distributed_chol_tri_inv_match_unsharded():
    """The shard= panel loops (distributed blocked Cholesky + tri_inv over
    the schur axis, ops/linalg.py) must agree with the unsharded f64 path
    to factorization-roundoff — the unit-level companion of the e2e
    dryrun gate 5 (__graft_entry__.py)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from loraine_tpu.ops.linalg import chol_blocked, tri_inv

    n = 256  # > one 128-panel, so the distributed column loop is exercised
    rng = np.random.default_rng(7)
    A = rng.standard_normal((n, n))
    M = A @ A.T + n * np.eye(n)

    mesh = Mesh(np.array(jax.devices()).reshape(1, 8), ("blocks", "schur"))

    def row_shard(x):
        return jax.lax.with_sharding_constraint(
            x, NamedSharding(mesh, P("schur", None))
        )

    Mj = jax.device_put(jnp.asarray(M), NamedSharding(mesh, P("schur", None)))
    L_ref = chol_blocked(jnp.asarray(M))
    Li_ref = tri_inv(L_ref)

    f = jax.jit(lambda X: tri_inv(chol_blocked(X, shard=row_shard),
                                  shard=row_shard))
    Li_d = f(Mj)
    L_d = jax.jit(lambda X: chol_blocked(X, shard=row_shard))(Mj)

    np.testing.assert_allclose(np.asarray(L_d), np.asarray(L_ref),
                               rtol=0, atol=1e-10 * float(jnp.abs(L_ref).max()))
    np.testing.assert_allclose(np.asarray(Li_d), np.asarray(Li_ref),
                               rtol=0, atol=1e-9 * float(jnp.abs(Li_ref).max()))
    # the inverse actually inverts: ||I - Li L|| at roundoff class
    resid = np.abs(np.asarray(Li_d) @ np.asarray(L_d) - np.eye(n)).max()
    assert resid < 1e-10


@pytest.mark.parametrize("n", [16, 104, 128, 300, 513])
def test_tri_inv(n):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    H = A @ A.T + n * np.eye(n)
    L = np.linalg.cholesky(H)
    Li = np.asarray(tri_inv(jnp.asarray(L)))
    assert np.max(np.abs(Li @ L - np.eye(n))) < 1e-13
    b = rng.standard_normal(n)
    x = np.asarray(cho_solve_inv(jnp.asarray(Li), jnp.asarray(b)))
    assert np.linalg.norm(H @ x - b) / np.linalg.norm(b) < 1e-12


def test_tri_inv_batched():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((3, 60, 60))
    H = A @ A.transpose(0, 2, 1) + 60 * np.eye(60)
    L = np.linalg.cholesky(H)
    Li = np.asarray(tri_inv(jnp.asarray(L)))
    assert np.max(np.abs(Li @ L - np.eye(60))) < 1e-13
