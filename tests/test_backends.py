"""The one platform decision (config.resolve_backends / AUTO_BACKENDS), the
compile-cache placement, and the CPU-testable contracts of what replaced
the removed Pallas kernels: eigensolvers at the bench's block sizes, steplength
lower bounds, the f64 split-preconditioned CG at late-IPM conditioning,
full-precision f32 products in the mixed paths, and chip_smoke.py's
refusal to run without a GPU."""
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import loraine_tpu as lt
from loraine_tpu.config import AUTO_BACKENDS, Options, resolve_backends
from loraine_tpu.ops.eigh import eigh_backend_for, eigh_by_backend

REPO = pathlib.Path(__file__).resolve().parent.parent
PLATFORMS = sorted(AUTO_BACKENDS)
AUTO_OPTIONS = ("eigh_backend", "step_eig", "chol_backend", "assembly_precision")


# ---------------------------------------------------------------- resolution


@pytest.mark.parametrize("platform", PLATFORMS)
@pytest.mark.parametrize("name", AUTO_OPTIONS + ("nt_precision",))
def test_auto_resolves_to_table(platform, name):
    o = Options().validated(platform=platform)
    want = AUTO_BACKENDS[platform][name]
    if name == "nt_precision":
        want = "f64"  # dd NT only under precision='dd2'
    assert getattr(o, name) == want
    assert getattr(o, name) != "auto"


@pytest.mark.parametrize("platform", PLATFORMS)
def test_nt_precision_auto_under_dd2(platform):
    o = Options(precision="dd2").validated(platform=platform)
    assert o.nt_precision == AUTO_BACKENDS[platform]["nt_precision"]


@pytest.mark.parametrize("platform", PLATFORMS)
def test_explicit_choices_are_kept(platform):
    o = Options(eigh_backend="jacobi", step_eig="chol", chol_backend="mixed",
                assembly_precision="f32").validated(platform=platform)
    assert (o.eigh_backend, o.step_eig, o.chol_backend, o.assembly_precision) == (
        "jacobi", "chol", "mixed", "f32")


def test_unknown_platform_is_an_error():
    with pytest.raises(ValueError, match="no backend choices for platform 'rocm'"):
        Options().validated(platform="rocm")


@pytest.mark.parametrize("name", ["step_eig", "eigh_backend"])
def test_removed_pallas_values_rejected(name):
    with pytest.raises(ValueError, match=f"{name}='pallas' was removed"):
        Options(**{name: "pallas"}).validated(platform="cpu")


def test_removed_cg_kernel_option_rejected():
    with pytest.raises(ValueError, match="option 'cg_kernel' was removed"):
        Options.from_dict({"cg_kernel": "ff"})


def test_dd_refused_where_transforms_are_not_exact(monkeypatch):
    monkeypatch.setitem(AUTO_BACKENDS["gpu"], "dd_exact", "TwoProd contracted")
    with pytest.raises(ValueError, match="TwoProd contracted"):
        Options(precision="dd").validated(platform="gpu")
    Options(precision="f64").validated(platform="gpu")


def test_resolution_is_idempotent():
    o = Options(precision="dd2").validated(platform="cpu")
    assert resolve_backends(o, "cpu") == o
    assert o.validated(platform="cpu") == o


def test_eigh_backend_for_sizes_and_unresolved():
    rule = ((64, "xla"), (512, "mixed"), (None, "xla"))
    assert [eigh_backend_for(rule, m) for m in (5, 63, 64, 511, 512, 801)] == [
        "xla", "xla", "mixed", "mixed", "xla", "xla"]
    assert eigh_backend_for("jacobi", 5) == "jacobi"
    with pytest.raises(ValueError, match="not a resolved choice"):
        eigh_backend_for("auto", 10)


@pytest.mark.parametrize("rule", [((64, "xla"),), ((None, "pallas"),), ()])
def test_malformed_eigh_size_rule_rejected(rule):
    with pytest.raises(ValueError, match="malformed eigh_backend size rule"):
        Options(eigh_backend=rule).validated(platform="cpu")


# ---------------------------------------------------------------- cache


def test_default_cache_dir_is_the_checkout():
    assert lt.DEFAULT_CACHE_DIR == str(REPO / ".jax_cache")


def _enable_cache_recording(monkeypatch, persistent):
    calls = {}
    monkeypatch.setattr(lt, "_persistent_cache_enabled", False)
    monkeypatch.setitem(AUTO_BACKENDS["cpu"], "persistent_cache", persistent)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    lt._enable_persistent_cache()
    return calls


def test_cache_placed_in_checkout_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _enable_cache_recording(monkeypatch, True)
    assert calls["jax_compilation_cache_dir"] == str(REPO / ".jax_cache")
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 0.0


def test_cache_env_dir_is_not_overridden(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _enable_cache_recording(monkeypatch, True)
    assert "jax_compilation_cache_dir" not in calls


def test_cache_off_where_table_says_so(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert _enable_cache_recording(monkeypatch, False) == {}


# ---------------------------------------------------------------- eigensolvers


def _sym(rng, nb, m):
    A = rng.standard_normal((nb, m, m))
    return (A + A.transpose(0, 2, 1)) / 2


@pytest.mark.parametrize("m", [5, 10, 50, 144, 145])
@pytest.mark.parametrize("backend", ["xla", "jacobi", "mixed"])
def test_eigh_backend_matches_numpy(backend, m):
    rng = np.random.default_rng(m)
    M = _sym(rng, 2, m)
    lam, V = eigh_by_backend(jnp.asarray(M), backend)
    lam, V = np.asarray(lam), np.asarray(V)
    norm = np.max(np.abs(np.linalg.eigvalsh(M)))
    # backward-stable f64 class: ~m u ||M||; 1e-10 fails any f32 result
    assert np.max(np.abs(lam - np.linalg.eigvalsh(M))) < 1e-10 * norm
    rec = V @ (lam[..., None] * V.transpose(0, 2, 1))
    assert np.max(np.abs(rec - M)) < 1e-10 * norm
    assert np.max(np.abs(V.transpose(0, 2, 1) @ V - np.eye(m))) < 1e-10


@pytest.mark.parametrize("m", [800, 801])
@pytest.mark.parametrize("backend", ["xla", "mixed"])
def test_eigh_backend_matches_numpy_large(backend, m):
    rng = np.random.default_rng(m)
    M = _sym(rng, 1, m)
    lam, _ = eigh_by_backend(jnp.asarray(M), backend)
    ref = np.linalg.eigvalsh(M)
    assert np.max(np.abs(np.asarray(lam) - ref)) < 1e-10 * np.max(np.abs(ref))


# ---------------------------------------------------------------- steplengths


def _spectrum(kind, rng, nb, m):
    if kind == "random":
        return _sym(rng, nb, m)
    if kind == "graded":
        lam = -np.logspace(-8, 0, m)[None, :] * rng.uniform(0.5, 2.0, (nb, 1))
    else:  # a tight cluster plus an isolated minimum
        lam = 1.0 + 1e-7 * rng.standard_normal((nb, m))
        lam[:, 0] = -0.25
    Q = np.linalg.qr(rng.standard_normal((nb, m, m)))[0]
    M = (Q * lam[:, None, :]) @ Q.transpose(0, 2, 1)
    return (M + M.transpose(0, 2, 1)) / 2


@pytest.mark.parametrize("kind", ["random", "graded", "clustered"])
@pytest.mark.parametrize("step_eig", ["exact", "chol", "lanczos"])
def test_steplength_lower_bound(step_eig, kind):
    """The steplength lambda_min never lands above the true lambda_min by
    more than the reference's own f64 accuracy (and is tight enough to be
    a useful steplength)."""
    from loraine_tpu.ipm.step import steplength_eigmin

    rng = np.random.default_rng(len(kind) * 7 + len(step_eig))
    M = _spectrum(kind, rng, 4, 40)
    ev = np.linalg.eigvalsh(M)
    norm = np.max(np.abs(ev), axis=-1)
    opts = Options(step_eig=step_eig, eigh_backend="xla").validated(platform="cpu")
    lo = np.asarray(jax.jit(steplength_eigmin(opts))(jnp.asarray(M)))
    assert np.all((lo - ev[:, 0]) / norm <= 1e-12)
    assert np.all((ev[:, 0] - lo) / norm <= 1e-4)


def test_steplength_unresolved_mode_rejected():
    from loraine_tpu.ipm.step import steplength_eigmin

    with pytest.raises(ValueError, match="not a resolved choice"):
        steplength_eigmin(Options())


# ---------------------------------------------------------------- CG


@pytest.mark.parametrize("n", [21, 64])
def test_cg_plain_split_preconditioned_kappa_1e10(n):
    """The materialized kit=1 route solves (Mli H Mli^T) u = Mli b with the
    f64 CG: it must converge to 1e-7 relative at the late-IPM conditioning
    kappa(H) ~ 1e10 with a preconditioner that captures the spread."""
    from loraine_tpu.ops.cg import cg_plain

    rng = np.random.default_rng(n)
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    lam = np.logspace(0, 10, n)
    H = (Q * lam) @ Q.T
    H = (H + H.T) / 2
    # an approximate inverse Cholesky factor: its eigenvalues off by <= 10%
    P = (Q * (lam * (1 + 0.1 * rng.uniform(size=n)))) @ Q.T
    Mli = np.linalg.inv(np.linalg.cholesky((P + P.T) / 2))
    b = rng.standard_normal(n)
    Hp = Mli @ H @ Mli.T
    u, it = jax.jit(lambda Hp, r: cg_plain(lambda v: Hp @ v, r, 1e-7, 1000))(
        jnp.asarray(Hp), jnp.asarray(Mli @ b))
    x = Mli.T @ np.asarray(u)
    assert int(it) < 1000
    assert np.linalg.norm(Mli @ (H @ x - b)) <= 1.1e-7 * np.linalg.norm(Mli @ b)
    # an unpreconditioned solve at this kappa needs far more iterations
    _, it0 = jax.jit(lambda H, r: cg_plain(lambda v: H @ v, r, 1e-7, 1000))(
        jnp.asarray(H), jnp.asarray(b))
    assert int(it0) > int(it)


# ---------------------------------------------------------------- f32 precision


def _f32_dot_precisions(fn, *args):
    """Precision of every dot_general on f32 operands in fn's jaxpr
    (including nested jaxprs of maps and conds)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general" and any(
                v.aval.dtype == jnp.float32 for v in eqn.invars
            ):
                found.append(eqn.params["precision"])
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else [p]):
                    if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _is_highest(p):
    return p is not None and all(x == jax.lax.Precision.HIGHEST for x in p)


def _mixed_path_cases():
    from loraine_tpu.ops.mixed_chol import chol_mixed_blocked
    from loraine_tpu.ops.schur import schur_group_mixed, schur_lp_mixed

    rng = np.random.default_rng(3)
    A = rng.standard_normal((300, 300))
    spd = jnp.asarray(A @ A.T + 300 * np.eye(300))
    prob = lt.problem_from_dense([_sym(rng, 6, 8)], [np.eye(8)],
                                 rng.standard_normal(6), storage="dense")
    g = prob.groups[0]
    W = jnp.broadcast_to(jnp.eye(g.m), (g.nb, g.m, g.m))
    C_lin = jnp.asarray(rng.standard_normal((6, 5)))
    w = jnp.asarray(rng.uniform(size=5))
    return {
        "chol_mixed_blocked": (chol_mixed_blocked, (spd,)),
        "schur_group_mixed": (lambda W: schur_group_mixed(g, W, W), (W,)),
        "schur_lp_mixed": (schur_lp_mixed, (C_lin, w)),
    }


@pytest.mark.parametrize("name", ["chol_mixed_blocked", "schur_group_mixed",
                                  "schur_lp_mixed"])
def test_mixed_f32_products_request_highest(name):
    fn, args = _mixed_path_cases()[name]
    precisions = _f32_dot_precisions(fn, *args)
    assert precisions, f"{name}: no f32 product found"
    assert all(_is_highest(p) for p in precisions), (name, precisions)


# ---------------------------------------------------------------- chip_smoke


def _run_smoke(cwd, env_extra):
    env = dict(os.environ, **env_extra)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_refuses_cpu():
    r = _run_smoke(REPO, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path, {"JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
