"""Schur-complement assembly and data-operator contractions, batched.

The Schur ("Hessian") matrix of the IPM normal equations is

    H[j,k] = sum_i  < A_j^{(i)},  W_i A_k^{(i)} W_i >
             + (C_lin diag(x_lin / s_lin) C_lin^T)[j,k]

The reference assembles this with a three-regime sparse loop
(`src/makeBBBB.jl:24-218`); here two batched GEMM contractions per
block group (dense data) or the rank-one compression

    H = sum_blocks ((B G)(B G)^T) ** 2        (elementwise square)

matching `makeBBBB_rank1` (`src/makeBBBB.jl:1-20`, O(n m^2 + n^2 m) per
block instead of O(n m^3 + n^2 m^2)).

Also provides the primal/adjoint data operators

    Aop(group, X)  = [ sum_b <A_j^{(b)}, X_b> ]_j          ([n])
    Aadj(group, y) = sum_j y_j A_j^{(b)}                    ([nb, m, m])

used for residuals, the matrix-free CG operator (`MyA`,
`src/Solvers.jl:572-614`), and right-hand sides (`makeRHS`,
`src/makeBBBB.jl:221-228`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..problem import BlockGroup
from .dd import DD, dd_add, dd_mul_f64, dd_sum, two_prod, two_sum
from .ozaki import acc_matmul, acc_matvec

# f32 products of the mixed assembly run at full f32 precision, never TF32
_HIGHEST = lax.Precision.HIGHEST

__all__ = [
    "Aop",
    "Aadj",
    "Aadj_dd",
    "schur_group",
    "schur_group_mixed",
    "schur_lp",
    "schur_lp_mixed",
    "lp_weight",
    "Aop_dd",
    "schur_group_dd",
    "schur_lp_dd",
]


def Aop(group: BlockGroup, X: jax.Array) -> jax.Array:
    """[n] <- sum over the group's blocks of <A_j, X_b>."""
    if group.is_rank1:
        BX = jnp.einsum("bjm,bmp->bjp", group.B, X)
        vals = jnp.einsum("bjp,bjp->bj", BX, group.B)
        return jnp.sum(group.Bsgn * vals, axis=0)
    if group.is_sparse:
        # <A_j, X> = sum_t v_t X[r_t, c_t] (COO fully expanded)
        gathered = jax.vmap(lambda Xb, r, c: Xb[r, c])(X, group.Arows, group.Acols)
        return jnp.einsum("bjt,bjt->j", group.Avals, gathered)
    return jnp.einsum("bjpq,bpq->j", group.A, X)


def Aadj(group: BlockGroup, y: jax.Array) -> jax.Array:
    """[nb, m, m] <- sum_j y_j A_j per block."""
    if group.is_rank1:
        w = group.Bsgn * y[None, :]
        return jnp.einsum("bj,bjm,bjp->bmp", w, group.B, group.B)
    if group.is_sparse:
        w = group.Avals * y[None, :, None]  # [nb, n, s]
        def scatter(r, c, wv):
            out = jnp.zeros((group.m, group.m), dtype=w.dtype)
            return out.at[r.reshape(-1), c.reshape(-1)].add(wv.reshape(-1))
        return jax.vmap(scatter)(group.Arows, group.Acols, w)
    if group.AT is not None:
        # mat@vec via the j-major copy: keeps the contraction a real dot on
        # XLA:CPU (vec@mat dots get fused into strided loop fusions; see the
        # BlockGroup.AT field comment)
        out = jnp.einsum("bkj,j->bk", group.AT, y)
        return out.reshape(group.AT.shape[0], group.m, group.m)
    return jnp.einsum("j,bjpq->bpq", y, group.A)


def Aadj_dd(group: BlockGroup, y: DD) -> DD:
    """Aadj at double-double accuracy: [nb, m, m] <- sum_j y_j A_j with the
    contraction accumulated in dd and the y.lo correction folded in. Needed
    by the dd2 tier: the f64 Aadj rounds at u64 * ||sum y A|| absolute,
    which would pin the dual residual Rd (and with it err3) at ~1e-14 —
    exactly the floor dd2 exists to break. Per storage (matching the
    reference's type-generic assembly, `src/makeBBBB.jl:39-218` over T):

      dense:  Ozaki-sliced exact matvec against the flattened stack.
      rank-1: u_j = (sgn_j y_j) b_j by TwoProd (the sign product is exact),
              then sum_j u_j b_j^T as an Ozaki-sliced exact GEMM.
      sparse: per-cell padded layout (BlockGroup.Acell*): TwoProd per
              entry, exact dd tree reduction per target cell, then a
              collision-free placement scatter (every cell index is
              unique within its block, so no rounding accumulation).
    """
    if group.is_rank1:
        w = group.Bsgn * y.hi[None, :]  # sgn in {-1, 0, 1}: exact product
        wlo = group.Bsgn * y.lo[None, :]
        u = two_prod(group.B, w[:, :, None])  # [nb, n, m] dd
        P = acc_matmul(jnp.swapaxes(u.hi, 1, 2), group.B)  # [nb, m, m] dd
        corr = jnp.swapaxes(u.lo + group.B * wlo[:, :, None], 1, 2) @ group.B
        s = two_sum(P.hi, corr)
        return DD(s.hi, s.lo + P.lo)
    if group.is_sparse:
        if group.Acell is None:
            raise NotImplementedError(
                "sparse Aadj_dd needs the per-cell layout — attach it with "
                "problem.ensure_dd_aadj() (the solver does this for "
                "precision='dd2')"
            )
        m = group.m
        yh = y.hi[group.Acell_j]  # [nb, ncell, kmax]
        p = two_prod(group.Acell_v, yh)
        corr = group.Acell_v * y.lo[group.Acell_j]
        s = dd_sum(DD(p.hi, p.lo + corr), axis=-1)  # [nb, ncell] dd

        def place(cells, v):
            return jnp.zeros((m * m + 1,), v.dtype).at[cells].set(v)[: m * m]

        hi = jax.vmap(place)(group.Acell, s.hi).reshape(-1, m, m)
        lo = jax.vmap(place)(group.Acell, s.lo).reshape(-1, m, m)
        return DD(hi, lo)
    nb, n, m, _ = group.A.shape
    Af = jnp.moveaxis(group.A, 1, 0).reshape(n, -1)  # [n, b*m*m]
    r = acc_matvec(Af.T, y.hi)  # dd [b*m*m]
    corr = Af.T @ y.lo
    s = two_sum(r.hi, corr)
    return DD(
        s.hi.reshape(nb, m, m), (s.lo + r.lo).reshape(nb, m, m)
    )


def schur_group(
    group: BlockGroup, W: jax.Array, G: jax.Array, gemm_backend: str = "f64"
) -> jax.Array:
    """[n, n] <- this group's contribution to H.

    Dense:   two batched GEMMs (T = W A W) + one [n,n] contraction.
    Rank-1:  with A_j = sgn_j b_j b_j^T,
             H[j,k] = sum_b sgn_j sgn_k (b_j^T W b_k)^2
                    = sum_b sgn sgn' o ((B G)(B G)^T)**2
             (`src/makeBBBB.jl:1-20`; the reference's factors are always
             sign-positive so its formula has no sign term).
    Sparse:  gather-based, see _schur_sparse.

    ``gemm_backend='int8'`` routes the rank-1 path's two large GEMMs (the
    FLOP bulk of maxG11/thetaG11-class assembly) through the int8 Ozaki
    GEMM (ops/int8gemm.py) instead of plain f64 GEMMs.
    """
    if group.is_rank1:
        if gemm_backend == "int8":
            from .int8gemm import matmul_f64_int8

            BG = matmul_f64_int8(group.B, G)
            P = matmul_f64_int8(BG, jnp.swapaxes(BG, -1, -2))
        else:
            BG = jnp.einsum("bjm,bmp->bjp", group.B, G)
            P = jnp.einsum("bjp,bkp->bjk", BG, BG)
        return jnp.einsum("bj,bk,bjk,bjk->jk", group.Bsgn, group.Bsgn, P, P)
    if group.is_sparse:
        return _schur_sparse(group, W)
    nb, n, m, _ = group.A.shape
    # Large dense data: chunk the T = W A W intermediate over constraints.
    # Unchunked, T is [nb, n, m, m] (at tru9 scale, n=3240 and m=152, that
    # is 600 MB of f64 per copy, and the einsum chain keeps several).
    # Chunked, the per-chunk footprint is ~J*m^2 while every GEMM stays
    # large; the final contraction is a [J, m^2] x [m^2, n] GEMM per chunk.
    if nb * n * m * m > (1 << 24):
        return _schur_dense_chunked(group, W)
    T = jnp.einsum("bpa,bjaq->bjpq", W, group.A)
    T = jnp.einsum("bjpq,bqr->bjpr", T, W)
    return jnp.einsum("bjpq,bkpq->jk", group.A, T)


def _schur_dense_chunked(group: BlockGroup, W: jax.Array) -> jax.Array:
    """Dense Schur contribution with the constraint axis processed in
    chunks (lax.map): H rows [J, n] per chunk from T_chunk = W A_chunk W
    flattened against the full data stack. Cost identical to the fused
    path (n m^3 + n^2 m^2 MACs); peak temp memory drops from O(n m^2) to
    O(J m^2). Replaces the reference's unchunked per-block loops
    (`src/makeBBBB.jl:86-98`) at sizes where [n, m, m] f64 temporaries
    crowd device memory."""
    nb, n, m, _ = group.A.shape
    # ~2^22 elements (32 MB of f64) per chunk
    J = int(min(n, max(8, (1 << 22) // max(1, nb * m * m))))
    nch = -(-n // J)
    npad = nch * J
    Ap = jnp.pad(group.A, ((0, 0), (0, npad - n), (0, 0), (0, 0)))
    Achunks = jnp.moveaxis(
        Ap.reshape(nb, nch, J, m, m), 1, 0
    )  # [nch, nb, J, m, m]
    Aflat = jnp.moveaxis(group.A, 1, 0).reshape(n, -1)  # [n, nb*m*m]

    def body(Ac):  # [nb, J, m, m]
        T = jnp.einsum("bpa,bjaq->bjpq", W, Ac)
        T = jnp.einsum("bjpq,bqr->bjpr", T, W)
        Tflat = jnp.moveaxis(T, 1, 0).reshape(J, -1)  # [J, nb*m*m]
        return Tflat @ Aflat.T  # [J, n] rows of H

    Hrows = jax.lax.map(body, Achunks)  # [nch, J, n]
    return Hrows.reshape(npad, n)[:n]


def _schur_sparse(group: BlockGroup, W: jax.Array) -> jax.Array:
    """Sparse-data Schur contribution via batched gathers + rank-s outer
    products, replacing the reference's scalar sparse loops
    (`src/makeBBBB.jl:39-218`) with a batched pipeline:

        T_j = W A_j W = sum_t v_t W[:, r_t] W[c_t, :]     (rank-s outer sum)
        H[j, k] = <A_k, T_j> = sum_u v_u T_j[r_u, c_u]    (gather + reduce)

    chunked over j so the gathered [nb, J, n, s] tensor stays bounded.
    Cost O(n m^2 s + n^2 s) vs dense O(n m^3 + n^2 m^2).
    """
    nb, n, s = group.Avals.shape
    m = group.m
    # cap the per-chunk gather tensor around ~2^25 elements (256 MB f64)
    J = int(min(n, max(8, (1 << 25) // max(1, nb * n * s))))
    nch = -(-n // J)
    npad = nch * J

    def pad_r(x):
        return jnp.pad(x, ((0, 0), (0, npad - n), (0, 0)))

    rows_c = pad_r(group.Arows).reshape(nb, nch, J, s).transpose(1, 0, 2, 3)
    cols_c = pad_r(group.Acols).reshape(nb, nch, J, s).transpose(1, 0, 2, 3)
    vals_c = pad_r(group.Avals).reshape(nb, nch, J, s).transpose(1, 0, 2, 3)
    flatk = group.Arows.astype(jnp.int32) * m + group.Acols.astype(jnp.int32)

    def body(chunk):
        r_c, c_c, v_c = chunk  # each [nb, J, s]
        Wa = jax.vmap(lambda Wb, idx: Wb[idx])(W, r_c)  # [nb, J, s, m]
        Wc = jax.vmap(lambda Wb, idx: Wb[idx])(W, c_c)
        T2 = jnp.einsum("bjtp,bjt,bjtq->bjpq", Wa, v_c, Wc).reshape(nb, J, m * m)
        G = jax.vmap(lambda t2, fk: t2[:, fk.reshape(-1)])(T2, flatk)
        return jnp.einsum("bjks,bks->jk", G.reshape(nb, J, n, s), group.Avals)

    Hrows = jax.lax.map(body, (rows_c, cols_c, vals_c))  # [nch, J, n]
    return Hrows.reshape(npad, n)[:n]


def schur_group_mixed(group: BlockGroup, W: jax.Array, G: jax.Array) -> jax.Array:
    """f32 Schur contribution — the mixed-precision assembly phase
    (assembly_precision='f32', used while total DIMACS > 1e-3 and swapped
    for the exact f64 path afterwards; `ipm/step.py` / `ipm/solver.py`).

    Rationale: where f32 GEMMs are much cheaper than f64 ones, the assembled
    H's relative error of ~1e-6 (f32 accumulate class) is below the
    backward-error level the IPM already tolerates mid-run from its CG
    tolerance schedule (tol_cg 1e-2 -> 1e-7). Every f32 product asks for
    Precision.HIGHEST, so a GPU never runs it as TF32 (~1e-3 relative
    error). Reference cost profile this attacks: `src/makeBBBB.jl:24-36`.

    Per storage:
      rank-1:  stays EXACT f64 — assembly is a small share of the rank-1
               step, while the f32 H((b'Wb)^2 squares the f32 error)
               stalled convergence above the handover threshold.
      sparse:  stays EXACT f64 (see below).
      dense:   the chunked contraction with f32 operands.
    """
    f32, f64 = jnp.float32, W.dtype
    if group.is_rank1:
        return schur_group(group, W, G)
    if group.is_sparse:
        # Two f32 sparse formulations exist (_schur_sparse_mixed against a
        # flattened f32 data copy, _schur_sparse_f32gather with an f32
        # second gather); both killed the runtime of the accelerator this
        # solver was first built for, mid-solve, so sparse groups keep the
        # exact f64 gather path until a measurement on the current device
        # earns them a place.
        return _schur_sparse(group, W)
    nb, n, m, _ = group.A.shape
    W32 = W.astype(f32)
    J = int(min(n, max(8, (1 << 22) // max(1, nb * m * m))))
    nch = -(-n // J)
    npad = nch * J
    Ap = jnp.pad(group.A, ((0, 0), (0, npad - n), (0, 0), (0, 0))).astype(f32)
    Achunks = jnp.moveaxis(Ap.reshape(nb, nch, J, m, m), 1, 0)
    Aflat = jnp.moveaxis(group.A, 1, 0).reshape(n, -1).astype(f32)

    def body(Ac):
        T = jnp.einsum("bpa,bjaq->bjpq", W32, Ac, precision=_HIGHEST)
        T = jnp.einsum("bjpq,bqr->bjpr", T, W32, precision=_HIGHEST)
        Tflat = jnp.moveaxis(T, 1, 0).reshape(J, -1)
        return jnp.matmul(Tflat, Aflat.T, precision=_HIGHEST).astype(f64)

    Hrows = jax.lax.map(body, Achunks)
    return Hrows.reshape(npad, n)[:n]


def _schur_sparse_dd(
    group: BlockGroup, W: jax.Array, W_lo: jax.Array | None = None
) -> DD:
    """Sparse-data Schur contribution in double-double (dd2 tier; the
    reference's type-generic `makeBBBB` sparse loops at T = Float64x4,
    `src/makeBBBB.jl:39-218`). Same gather pipeline as `_schur_sparse`,
    re-based on dd arithmetic: per COO slot t the outer-product term
    v_t (W e_{r_t}) (W e_{c_t})^T enters T2 as TwoProd pairs accumulated
    with dd addition, the second gather moves (hi, lo) pairs exactly, and
    the final contraction against Avals is TwoProd + dd accumulation.
    The static slot loop (s is small) keeps peak memory at one
    [nb, J, m, m] dd accumulator instead of an [nb, J, s, m, m] stack.
    ``W_lo``: first-order NT-tail terms (nt_precision='dd'), folded into
    T2's low words like the dense path does."""
    nb, n, s = group.Avals.shape
    m = group.m
    J = int(min(n, max(4, (1 << 21) // max(1, nb * m * m))))
    nch = -(-n // J)
    npad = nch * J

    def pad_r(x):
        return jnp.pad(x, ((0, 0), (0, npad - n), (0, 0)))

    rows_c = pad_r(group.Arows).reshape(nb, nch, J, s).transpose(1, 0, 2, 3)
    cols_c = pad_r(group.Acols).reshape(nb, nch, J, s).transpose(1, 0, 2, 3)
    vals_c = pad_r(group.Avals).reshape(nb, nch, J, s).transpose(1, 0, 2, 3)
    flatk = group.Arows.astype(jnp.int32) * m + group.Acols.astype(jnp.int32)

    def body(chunk):
        r_c, c_c, v_c = chunk  # each [nb, J, s]
        Wa = jax.vmap(lambda Wb, idx: Wb[idx])(W, r_c)  # [nb, J, s, m]
        Wc = jax.vmap(lambda Wb, idx: Wb[idx])(W, c_c)
        acc_hi = jnp.zeros((nb, J, m, m), dtype=W.dtype)
        acc_lo = jnp.zeros((nb, J, m, m), dtype=W.dtype)
        acc = DD(acc_hi, acc_lo)
        for t in range(s):
            av = two_prod(Wa[:, :, t, :], v_c[:, :, t, None])  # [nb, J, m]
            outer = two_prod(av.hi[..., :, None], Wc[:, :, t, None, :])
            term = DD(
                outer.hi,
                outer.lo + av.lo[..., :, None] * Wc[:, :, t, None, :],
            )
            acc = dd_add(acc, term)
        if W_lo is not None:
            Wal = jax.vmap(lambda Wb, idx: Wb[idx])(W_lo, r_c)
            Wcl = jax.vmap(lambda Wb, idx: Wb[idx])(W_lo, c_c)
            corr = jnp.einsum("bjtp,bjt,bjtq->bjpq", Wal, v_c, Wc)
            corr = corr + jnp.einsum("bjtp,bjt,bjtq->bjpq", Wa, v_c, Wcl)
            acc = DD(acc.hi, acc.lo + corr)
        T2 = DD(acc.hi.reshape(nb, J, m * m), acc.lo.reshape(nb, J, m * m))
        Ghi = jax.vmap(lambda t2, fk: t2[:, fk.reshape(-1)])(T2.hi, flatk)
        Glo = jax.vmap(lambda t2, fk: t2[:, fk.reshape(-1)])(T2.lo, flatk)
        Ghi = Ghi.reshape(nb, J, n, s)
        Glo = Glo.reshape(nb, J, n, s)
        hrow_hi = jnp.zeros((nb, J, n), dtype=W.dtype)
        hrow = DD(hrow_hi, jnp.zeros_like(hrow_hi))
        for t in range(s):
            p = two_prod(Ghi[..., t], group.Avals[:, None, :, t])
            p = DD(p.hi, p.lo + Glo[..., t] * group.Avals[:, None, :, t])
            hrow = dd_add(hrow, p)
        # accumulate the block axis in dd
        out = dd_sum(hrow, axis=0)  # [J, n]
        return out.hi, out.lo

    Hh, Hl = jax.lax.map(body, (rows_c, cols_c, vals_c))  # [nch, J, n]
    return DD(Hh.reshape(npad, n)[:n], Hl.reshape(npad, n)[:n])


def _schur_sparse_f32gather(group: BlockGroup, W: jax.Array) -> jax.Array:
    """Sparse mixed-assembly CANDIDATE without the A_flat32 dense copy:
    exact f64 gathers/outer products for T2 (cheap), then the measured-
    dominant second gather (T2 rows at the COO flat indices) and the
    final contraction in f32 — half the gather bytes of the exact path,
    no 300 MB flattened operand. Structurally identical to _schur_sparse
    (same gather pipeline). Not dispatched by the solver (see
    schur_group_mixed)."""
    nb, n, s = group.Avals.shape
    m = group.m
    J = int(min(n, max(8, (1 << 25) // max(1, nb * n * s))))
    nch = -(-n // J)
    npad = nch * J

    def pad_r(x):
        return jnp.pad(x, ((0, 0), (0, npad - n), (0, 0)))

    rows_c = pad_r(group.Arows).reshape(nb, nch, J, s).transpose(1, 0, 2, 3)
    cols_c = pad_r(group.Acols).reshape(nb, nch, J, s).transpose(1, 0, 2, 3)
    vals_c = pad_r(group.Avals).reshape(nb, nch, J, s).transpose(1, 0, 2, 3)
    flatk = group.Arows.astype(jnp.int32) * m + group.Acols.astype(jnp.int32)
    vals32 = group.Avals.astype(jnp.float32)

    def body(chunk):
        r_c, c_c, v_c = chunk  # each [nb, J, s]
        Wa = jax.vmap(lambda Wb, idx: Wb[idx])(W, r_c)  # [nb, J, s, m]
        Wc = jax.vmap(lambda Wb, idx: Wb[idx])(W, c_c)
        T2 = jnp.einsum("bjtp,bjt,bjtq->bjpq", Wa, v_c, Wc)
        T32 = T2.reshape(nb, J, m * m).astype(jnp.float32)
        G = jax.vmap(lambda t2, fk: t2[:, fk.reshape(-1)])(T32, flatk)
        return jnp.einsum(
            "bjks,bks->jk", G.reshape(nb, J, n, s), vals32,
            precision=_HIGHEST,
        ).astype(W.dtype)

    Hrows = jax.lax.map(body, (rows_c, cols_c, vals_c))  # [nch, J, n]
    return Hrows.reshape(npad, n)[:n]


def _schur_sparse_mixed(group: BlockGroup, W: jax.Array) -> jax.Array:
    """Sparse-data mixed assembly: T2 rows from exact f64 gathers/outer
    products (the cheap stage), H rows from one f32 GEMM per chunk
    against A_flat32 (replacing the f64 gather stage). Not dispatched by
    the solver (see schur_group_mixed)."""
    nb, n, s = group.Avals.shape
    m = group.m
    J = int(min(n, max(8, (1 << 25) // max(1, nb * n * s))))
    nch = -(-n // J)
    npad = nch * J

    def pad_r(x):
        return jnp.pad(x, ((0, 0), (0, npad - n), (0, 0)))

    rows_c = pad_r(group.Arows).reshape(nb, nch, J, s).transpose(1, 0, 2, 3)
    cols_c = pad_r(group.Acols).reshape(nb, nch, J, s).transpose(1, 0, 2, 3)
    vals_c = pad_r(group.Avals).reshape(nb, nch, J, s).transpose(1, 0, 2, 3)
    Af32 = group.A_flat32  # [nb, n, m*m]

    def body(chunk):
        r_c, c_c, v_c = chunk  # each [nb, J, s]
        Wa = jax.vmap(lambda Wb, idx: Wb[idx])(W, r_c)  # [nb, J, s, m]
        Wc = jax.vmap(lambda Wb, idx: Wb[idx])(W, c_c)
        T2 = jnp.einsum("bjtp,bjt,bjtq->bjpq", Wa, v_c, Wc)
        T32 = T2.reshape(nb, J, m * m).astype(jnp.float32)
        return jnp.einsum("bjk,bnk->jn", T32, Af32,
                          precision=_HIGHEST).astype(W.dtype)

    Hrows = jax.lax.map(body, (rows_c, cols_c, vals_c))  # [nch, J, n]
    return Hrows.reshape(npad, n)[:n]


def schur_lp_mixed(C_lin: jax.Array, w: jax.Array) -> jax.Array:
    """LP-cone Schur block with the big GEMM in f32 (the weighting stays
    f64 so the X/S scaling magnitudes are carried exactly)."""
    Cw = (C_lin * w[None, :]).astype(jnp.float32)
    return jnp.matmul(Cw, C_lin.T.astype(jnp.float32),
                      precision=_HIGHEST).astype(C_lin.dtype)


def Aop_dd(group: BlockGroup, M: jax.Array, Mlo=None) -> DD:
    """Aop in double-double: [n] <- sum_b <A_j, M_b> with dd accumulation.

    ``M`` (and optional low part ``Mlo``) is the per-block matrix argument.
    Dense storage uses an Ozaki-sliced exact contraction; rank-1 and sparse
    storages use TwoProd + dd tree reduction (their contractions are short
    enough that slicing buys nothing)."""
    if group.is_rank1:
        BX = jnp.einsum("bjm,bmp->bjp", group.B, M)  # f64 inner product
        p = two_prod(BX, group.B)
        vals = dd_sum(DD(p.hi, p.lo), axis=-1)  # [nb, n]
        w = dd_sum(DD(vals.hi * group.Bsgn, vals.lo * group.Bsgn), axis=0)
        if Mlo is not None:
            corr = jnp.sum(
                group.Bsgn * jnp.einsum("bjm,bmp,bjp->bj", group.B, Mlo, group.B),
                axis=0,
            )
            s = two_sum(w.hi, corr)
            w = DD(s.hi, s.lo + w.lo)
        return w
    if group.is_sparse:
        gathered = jax.vmap(lambda Xb, r, c: Xb[r, c])(M, group.Arows, group.Acols)
        p = two_prod(group.Avals, gathered)
        flat = DD(
            jnp.moveaxis(p.hi, 1, 0).reshape(p.hi.shape[1], -1),
            jnp.moveaxis(p.lo, 1, 0).reshape(p.lo.shape[1], -1),
        )
        w = dd_sum(flat, axis=-1)
        if Mlo is not None:
            g2 = jax.vmap(lambda Xb, r, c: Xb[r, c])(Mlo, group.Arows, group.Acols)
            corr = jnp.einsum("bjt,bjt->j", group.Avals, g2)
            s = two_sum(w.hi, corr)
            w = DD(s.hi, s.lo + w.lo)
        return w
    nb, n = group.A.shape[:2]
    Af = jnp.moveaxis(group.A, 1, 0).reshape(n, -1)  # [n, b*m*m]
    r = acc_matvec(Af, M.reshape(-1))
    if Mlo is not None:
        corr = Af @ Mlo.reshape(-1)
        s = two_sum(r.hi, corr)
        r = DD(s.hi, s.lo + r.lo)
    return r


def schur_group_dd(
    group: BlockGroup,
    W: jax.Array,
    G: jax.Array,
    W_lo: jax.Array | None = None,
    G_lo: jax.Array | None = None,
) -> DD:
    """Schur contribution in double-double (the high-precision mode's
    replacement for `schur_group`): every GEMM is an Ozaki-sliced exact
    product, accumulations are dd. Cost is a constant factor (~15-20 GEMMs
    per GEMM) over the f64 path, all GEMM-shaped.

    ``W_lo``/``G_lo``: dd low words of the NT quantities (native dd NT
    scaling, nt_precision='dd'). Their first-order contributions
    (W_lo A W + W A W_lo sandwiched into H; B G_lo folded into the rank-1
    factor product) are u64-small relative terms evaluated as plain f64
    GEMMs — they keep the assembled H consistent with the dd-tailed W used
    in the direction formulas, so the Schur-solve refinement converges to
    the tailed operator's solution.

    Sparse-storage groups run the dd gather pipeline (`_schur_sparse_dd`,
    round 5): without it the Schur-solve refinement targets an f64-rounded
    operator and the feasibility-exact direction identity A(delX) = Rp
    breaks at u64 * ||H|| — measured as a 9e-15 err1 floor on sparse-stored
    tru3 dd2 (the dd H restores the dd-class floor)."""
    if group.is_rank1:
        BG = acc_matmul(group.B, G)  # [nb, n, m] dd
        if G_lo is not None:
            BG = DD(BG.hi, BG.lo + jnp.einsum("bjm,bmp->bjp", group.B, G_lo))
        GT = jnp.swapaxes(BG.hi, -1, -2)
        P = acc_matmul(BG.hi, GT)  # [nb, n, n] dd
        # lo-part cross terms: BG.lo @ BG.hi^T and its transpose (u^2-level
        # relative; BG.lo x BG.lo is below dd resolution)
        cross = BG.lo @ GT
        P = DD(*_dd_renorm(P.hi, P.lo + cross + jnp.swapaxes(cross, -1, -2)))
        # elementwise square in dd: (hi+lo)^2 = hi^2 + 2 hi lo (+ lo^2 ~ 0)
        sq = two_prod(P.hi, P.hi)
        Psq = DD(*_dd_renorm(sq.hi, sq.lo + 2.0 * P.hi * P.lo))
        sgn = group.Bsgn[:, :, None] * group.Bsgn[:, None, :]
        return dd_sum(DD(Psq.hi * sgn, Psq.lo * sgn), axis=0)
    if group.is_sparse:
        return _schur_sparse_dd(group, W, W_lo)
    nb, n, m, _ = group.A.shape
    WA = acc_matmul(W[:, None], group.A)  # [nb, n, m, m] dd
    T = acc_matmul(WA.hi, W[:, None])
    Tlo = WA.lo @ W[:, None]
    if W_lo is not None:
        # first-order W-tail terms: W_lo A W + W A W_lo (f64 GEMMs)
        Tlo = Tlo + W_lo[:, None] @ (group.A @ W[:, None]) + WA.hi @ W_lo[:, None]
    T = DD(*_dd_renorm(T.hi, T.lo + Tlo))
    Af = jnp.moveaxis(group.A, 1, 0).reshape(n, -1)  # [n, b*m*m]
    Thf = jnp.moveaxis(T.hi, 1, 0).reshape(n, -1)
    Tlf = jnp.moveaxis(T.lo, 1, 0).reshape(n, -1)
    H = acc_matmul(Af, Thf.T)
    corr = Af @ Tlf.T
    return DD(*_dd_renorm(H.hi, H.lo + corr))


def _dd_renorm(hi, lo):
    s = hi + lo
    # fold-blocker: see ops/dd.py two_sum
    t = (s - hi) + 0.0 * lo
    return s, lo - t


def lp_weight(X_lin: jax.Array, S_lin_inv: jax.Array) -> jax.Array:
    return X_lin * S_lin_inv


def schur_lp(C_lin: jax.Array, w: jax.Array) -> jax.Array:
    """[n, n] <- C_lin diag(w) C_lin^T."""
    return (C_lin * w[None, :]) @ C_lin.T


def schur_lp_dd(C_lin: jax.Array, w: DD) -> DD:
    """schur_lp at dd accuracy (dd2 LP-cone support): the C*w scaling is an
    error-free TwoProd (a plain f64 product would re-inject u64*||H_lp||
    noise before the exact GEMM), the big product is the Ozaki-sliced exact
    GEMM, and the w.lo first-order term is a plain f64 GEMM. Reference
    equivalent: the LP block of `makeBBBB` at T = Float64x4
    (`src/makeBBBB.jl:24-36`, `src/Solvers.jl:18`)."""
    p = two_prod(C_lin, w.hi[None, :])
    H = acc_matmul(p.hi, C_lin.T)
    corr = (p.lo + C_lin * w.lo[None, :]) @ C_lin.T
    s = two_sum(H.hi, corr)
    return DD(*_dd_renorm(s.hi, s.lo + H.lo))
