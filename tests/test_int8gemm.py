"""Oracle tests for the int8 Ozaki GEMM (ops/int8gemm.py).

Accuracy contract: matmul_f64_int8 must match a float128 (longdouble)
reference at least as well as a plain f64 GEMM does — the slicing is an
error-free transform down to 2^-60 * |A||B|, below f64's own rounding.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from loraine_tpu.ops.int8gemm import matmul_f64_int8


def _err(approx, A, B):
    """Componentwise error vs a longdouble reference, normalized by the
    magnitude-sum bound |A| |B| (the natural scale for GEMM rounding)."""
    ref = np.asarray(A, np.longdouble) @ np.asarray(B, np.longdouble)
    scale = np.abs(A) @ np.abs(B) + 1e-300
    return float(np.max(np.abs((np.asarray(approx, np.longdouble) - ref) / scale)))


@pytest.mark.parametrize("shape", [(17, 23, 9), (64, 64, 64), (128, 40, 96)])
def test_random_matches_longdouble(shape):
    m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    A = rng.standard_normal((m, k))
    B = rng.standard_normal((k, n))
    out = matmul_f64_int8(jnp.asarray(A), jnp.asarray(B))
    e_int8 = _err(out, A, B)
    e_f64 = _err(A @ B, A, B)
    assert e_int8 <= max(2 * e_f64, 2 ** -52), (e_int8, e_f64)


def test_graded_rows_and_columns():
    # per-row/column exponent alignment must survive 1e+/-100 grading
    rng = np.random.default_rng(0)
    A = rng.standard_normal((32, 48)) * np.logspace(-100, 100, 32)[:, None]
    B = rng.standard_normal((48, 16)) * np.logspace(80, -80, 16)[None, :]
    out = matmul_f64_int8(jnp.asarray(A), jnp.asarray(B))
    assert _err(out, A, B) <= 2 ** -50


def test_batched():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((3, 20, 30))
    B = rng.standard_normal((3, 30, 10))
    out = np.asarray(matmul_f64_int8(jnp.asarray(A), jnp.asarray(B)))
    for i in range(3):
        assert _err(out[i], A[i], B[i]) <= 2 ** -50


def test_zeros_and_signs():
    A = np.array([[0.0, -1.5, 0.0], [2.0**-500, 0.0, -(2.0**300)]])
    B = np.array([[1.0, -2.0], [0.5, 0.0], [-1.0, 4.0]])
    out = np.asarray(matmul_f64_int8(jnp.asarray(A), jnp.asarray(B)))
    ref = A @ B
    np.testing.assert_allclose(out, ref, rtol=1e-14, atol=1e-290)


def test_cancellation_beats_f64():
    # adversarial cancellation: sum of large +/- pairs with a tiny residual.
    # the exact int32 accumulation must recover the residual at least as
    # well as f64 (which loses it to intermediate rounding at k=2^14)
    k = 1 << 14
    rng = np.random.default_rng(2)
    big = rng.standard_normal(k // 2) * 1e8
    A = np.concatenate([big, -big])[None, :]  # exact cancellation
    A[0, -1] += 1.0  # tiny residual
    B = np.ones((k, 1))
    out = float(np.asarray(matmul_f64_int8(jnp.asarray(A), jnp.asarray(B)))[0, 0])
    np.testing.assert_allclose(out, 1.0, rtol=1e-6)


def test_rejects_f32():
    with pytest.raises(TypeError):
        matmul_f64_int8(jnp.ones((2, 2), jnp.float32), jnp.ones((2, 2), jnp.float32))
