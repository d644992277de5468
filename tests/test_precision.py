"""Every contraction on the solve and setup paths runs at full float32
precision.

On a GPU a float32 ``dot_general`` at default precision may run in TF32
(about 10 mantissa bits), which would round Gram-Schmidt coefficients, the
dense coarse solve and the one-hot slot accumulations of the device setups.
Each site therefore passes ``precision=HIGHEST`` itself.  These tests trace
each site at small shapes, record every ``dot_general`` bound from a line
of this package, and require the precision on each.
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import jax
from jax import lax
from jax._src.lax import lax as lax_internal

import tpusolve

PKG = os.path.dirname(os.path.abspath(tpusolve.__file__))


def _site():
    """'<module path>:<qualname>' of the innermost tpusolve frame."""
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path.startswith(PKG + os.sep):
            return (os.path.relpath(path, PKG).replace(os.sep, "/") + ":"
                    + f.f_code.co_qualname)
        f = f.f_back
    return None


@contextlib.contextmanager
def recorded_dots():
    """Record (site, precision) of every dot_general traced from tpusolve.
    Trace caches are cleared first so cached programs are traced again."""
    prim = lax_internal.dot_general_p
    seen = []

    def bind(*args, **params):
        site = _site()
        if site is not None:
            seen.append((site, params.get("precision")))
        return type(prim).bind(prim, *args, **params)

    jax.clear_caches()
    prim.bind = bind
    try:
        yield seen
    finally:
        del prim.bind
        jax.clear_caches()


def _highest(prec) -> bool:
    if prec is None:
        return False
    precs = prec if isinstance(prec, tuple) else (prec,)
    return all(p == lax.Precision.HIGHEST for p in precs)


def _z(shape, dtype=np.float32):
    return jax.numpy.zeros(shape, dtype)


# The device-setup sites are traced (jax.make_jaxpr) at small synthetic
# shapes: tracing binds every dot_general without compiling the programs.
C, K, KC, KF, N = 256, 8, 4, 4, 512


def run_gmres(request):
    from tpusolve.stencil import laplace27
    from tpusolve.krylov.gmres import gmres_setup
    A, b, _ = laplace27(request.getfixturevalue("mesh1"), 6, 6, 6,
                        dtype=np.float32)
    for flexible in (False, True):
        solve = gmres_setup(A, None, tol=1e-4, maxiter=20, restart=5,
                            flexible=flexible)
        jax.make_jaxpr(solve)(b)


def run_coarse_solve(request):
    from tpusolve.stencil import laplace27
    from tpusolve.amg.builder import boomeramg_setup
    from tpusolve.config import BoomerAMGConfig
    A, b, _, Ah = laplace27(request.getfixturevalue("mesh1"), 6, 6, 6,
                            dtype=np.float32, with_host=True)
    pre = boomeramg_setup(A, BoomerAMGConfig(max_coarse_size=64),
                          A_host=Ah)
    jax.make_jaxpr(pre.apply)(b)


def run_bell(request):
    from tpusolve.matrix.sharded import ShardedMatrix
    from tpusolve.matrix.spmv import spmv
    n = 256
    rows = np.repeat(np.arange(n, dtype=np.int64), 128)
    cols = np.tile(np.arange(128), n) + 128 * ((rows // 8) % 2)
    vals = np.ones(rows.size)
    A = ShardedMatrix.from_coo(request.getfixturevalue("mesh1"), (n, n),
                               rows, cols, vals, dtype=np.float32,
                               allow_dia=False, allow_bdia=False)
    assert A.layout == "bell"
    jax.make_jaxpr(spmv)(A, _z(A.padded_ncols))


def run_ell_classical(request):
    from tpusolve.amg.device_setup_ell import _classical_chunk_jit
    i32 = np.int32
    jax.make_jaxpr(lambda *a: _classical_chunk_jit(*a, KF=KF))(
        _z((C, KF)), _z((C, KF), i32), _z((C, KC)), _z((C, KC), i32),
        _z((C,), i32), _z((C,)), _z((C,)), _z((N, K)), _z((N, K), i32),
        _z((N,)))


def run_ell_exti(request):
    from tpusolve.amg.device_setup_ell import _exti_chunk_jit
    i32 = np.int32
    jax.make_jaxpr(lambda *a: _exti_chunk_jit(
        *a, Kce=(KF + 1) * KC, KF=KF, row0=0))(
        _z((C, K)), _z((C, K), i32), _z((C, K), bool), _z((C, K), bool),
        _z((C, KF)), _z((C, KF), i32), _z((C,)), _z((C,)), _z((C, KC)),
        _z((C, KC), i32), _z((C,), i32), _z((N, K)), _z((N, K), i32),
        _z((N,)))


def _mp_args(P, G=16, S=4):
    i32 = np.int32
    return (_z((P, C, K)), _z((P, C, K), i32), _z((P, C, K), bool),
            _z((P, C), i32), _z((P, C), i32), _z((P, P, S), i32),
            _z((P, G), i32), _z((P, C + G + 1), i32))


def run_mp_classical(request):
    from tpusolve.amg.device_setup_ell_mp import _interp_classical_mp
    mesh = request.getfixturevalue("mesh8")
    jax.make_jaxpr(lambda *a: _interp_classical_mp(
        mesh, mesh.axis_names[0], *a, R=C, G=16, Kc=KC, KF=KF))(
            *_mp_args(8))


def run_mp_exti(request):
    from tpusolve.amg.device_setup_ell_mp import _interp_exti_mp
    mesh = request.getfixturevalue("mesh8")
    i32 = np.int32
    jax.make_jaxpr(lambda *a: _interp_exti_mp(
        mesh, mesh.axis_names[0], *a, R=C, G=16, Kc=KC, KF=KF))(
            *_mp_args(8), _z((8, 1), i32), _z((8, 1), i32))


def run_ilu_ell(request):
    from tpusolve.ilu.device_setup import make_ell_factorizer
    factor = make_ell_factorizer(C, K, sweeps=2, KL=4, KU=5)
    jax.make_jaxpr(factor)(_z((C, K)), _z((C, K), np.int32))


def run_power_lambda(request):
    from tpusolve.stencil import laplace27
    from tpusolve.amg import device_setup
    A, _, _ = laplace27(request.getfixturevalue("mesh1"), 6, 6, 6,
                        dtype=np.float32)
    device_setup.power_lambda(A, A.diagonal_padded(), iters=2)


SITES = [
    ("krylov/gmres.py:_dot", run_gmres),
    ("amg/builder.py:", run_coarse_solve),
    ("kernels/bell.py:bell_spmv_local", run_bell),
    ("amg/device_setup_ell.py:_classical_chunk_jit.", run_ell_classical),
    ("amg/device_setup_ell.py:_exti_chunk_jit.", run_ell_exti),
    ("amg/device_setup_ell_mp.py:_interp_classical_mp.", run_mp_classical),
    ("amg/device_setup_ell_mp.py:_interp_exti_mp.", run_mp_exti),
    ("ilu/device_setup.py:make_ell_factorizer.", run_ilu_ell),
    ("amg/device_setup.py:power_lambda.", run_power_lambda),
]


@pytest.mark.parametrize("site,run", SITES, ids=[s for s, _ in SITES])
def test_contraction_precision(site, run, request):
    with recorded_dots() as seen:
        run(request)
    at_site = [p for s, p in seen if s.startswith(site)]
    assert at_site, f"no dot_general traced at {site}: {seen}"
    loose = sorted({s for s, p in seen if not _highest(p)})
    assert not loose, f"contractions without precision=HIGHEST: {loose}"


@pytest.mark.chip
def test_highest_precision_on_card(gpu_mesh):
    """On the card, a pinned batched contraction (the one-hot
    accumulation's shape) agrees with f64 to f32 roundoff, where TF32
    would be ~1e-4 off."""
    import jax.numpy as jnp
    a = jax.random.normal(jax.random.PRNGKey(0), (512, 64, 32), jnp.float32)
    b = jax.random.normal(jax.random.PRNGKey(1), (512, 32, 48), jnp.float32)
    ref = np.einsum("cks,csq->ckq", np.asarray(a, np.float64),
                    np.asarray(b, np.float64))
    got = np.asarray(jnp.einsum("cks,csq->ckq", a, b,
                                precision=lax.Precision.HIGHEST))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5
