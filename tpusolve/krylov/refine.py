"""Mixed-precision iterative refinement.

HYPRE runs everything in f64.  ``precision: mixed`` keeps the
preconditioner and Krylov sweeps in f32, which stream half the bytes, and
recovers f64 accuracy by classical IR (SURVEY.md section 7 "hard parts":
f32 with iterative refinement to hit rtol 1e-8):

    repeat:  r = b - A x        (high precision)
             solve A d = r      (f32 Krylov + preconditioner)
             x <- x + d         (high-precision accumulation)

The inner solver only ever needs to reduce the residual by ~1e-6 (the f32
limit); the outer loop squares that per pass, reaching 1e-8..1e-12 in 2-3
refinements.  The high-precision operator is a second (f64) copy of A —
memory cost 3x the f32 operator, applied once per refinement pass.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tpusolve.krylov.common import (
    SolveResult, as_operator_pair, norm, safe_div, stop_target)


def refined_solve_setup(A_hi, inner_solve, *, tol: float = 1e-8,
                        atol: float = 0.0, max_refine: int = 6,
                        lo_dtype=jnp.float32):
    """Wrap a low-precision solver closure with IR against ``A_hi``.

    ``A_hi``: the operator in high precision (ShardedMatrix or callable);
    ``inner_solve(b_lo, x0=None) -> SolveResult``: the f32 solver (e.g. a
    ``pcg_setup``/``gmres_setup`` closure built on the f32 operator with its
    own inner tolerance ~1e-6).

    Returns a jitted ``solve(b_hi, x0=None) -> SolveResult`` whose ``iters``
    counts total inner Krylov iterations.
    """
    afn, astate = as_operator_pair(A_hi)
    if hasattr(inner_solve, "_fn"):
        inner_fn = inner_solve._fn
        inner_state = inner_solve._state
    else:  # opaque closure: state rides as a capture (small solvers only)
        inner_fn = lambda _st, b, x0: inner_solve(b, x0)
        inner_state = ()

    @jax.jit
    def _solve(astate, inner_state, b, x0):
        matvec_hi = lambda v: afn(astate, v)
        hi = b.dtype
        x = jnp.zeros_like(b) if x0 is None else x0.astype(hi)
        bnorm = norm(b)
        target = stop_target(bnorm, tol, atol)
        r = b - matvec_hi(x)
        rnorm = norm(r)

        def cond(state):
            x, r, rnorm, tot, k = state
            return (k < max_refine) & (rnorm > target)

        def body(state):
            x, r, rnorm, tot, k = state
            res = inner_fn(*inner_state, r.astype(lo_dtype), None) \
                if inner_state else inner_fn(inner_state, r.astype(lo_dtype), None)
            x = x + res.x.astype(hi)
            r = b - matvec_hi(x)
            return x, r, norm(r), tot + res.iters, k + 1

        x, r, rnorm, tot, k = lax.while_loop(
            cond, body, (x, r, rnorm, jnp.int32(0), jnp.int32(0)))
        return SolveResult(x=x, iters=tot, relres=safe_div(rnorm, bnorm),
                           converged=rnorm <= target)

    def solve(b, x0=None):
        return _solve(astate, inner_state, b, x0)

    solve._fn = _solve
    solve._state = (astate, inner_state)
    return solve
