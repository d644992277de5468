"""Stationary (fixed-point) iteration: x <- x + M(b - A x).

Used for AMG-as-solver (ref: setup_boomeramg_solver,
src/HypreSystem.cpp:91-117) and ILU-as-solver (ref: setup_ilu,
src/HypreSystem.cpp:457-497).  One jitted ``while_loop`` — never op-by-op
dispatch (one host round-trip per eager op).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tpusolve.krylov.common import (
    SolveResult, as_operator_pair, as_precond_pair, norm, safe_div,
    stop_target)


def stationary_solve_setup(A, M, *, tol: float = 0.0, atol: float = 0.0,
                           maxiter: int = 1):
    afn, astate = as_operator_pair(A)
    mfn, mstate = as_precond_pair(M)

    @jax.jit
    def _solve(astate, mstate, b, x0):
        matvec = lambda v: afn(astate, v)
        precond = lambda r: mfn(mstate, r)
        x = jnp.zeros_like(b) if x0 is None else x0
        bnorm = norm(b)
        target = stop_target(bnorm, tol, atol)
        r0 = b - matvec(x)

        def cond(state):
            x, r, rnorm, it = state
            return (it < maxiter) & (rnorm > target)

        def body(state):
            # one matvec per iteration: the residual carried in state serves
            # both the update and the convergence norm
            x, r, _, it = state
            x = x + precond(r)
            r = b - matvec(x)
            return x, r, norm(r), it + 1

        x, _, rnorm, it = lax.while_loop(
            cond, body, (x, r0, norm(r0), jnp.int32(0)))
        return SolveResult(x=x, iters=it, relres=safe_div(rnorm, bnorm),
                           converged=rnorm <= target)

    def solve(b, x0=None):
        return _solve(astate, mstate, b, x0)

    solve._fn = _solve        # (astate, mstate, b, x0) -> SolveResult
    solve._state = (astate, mstate)
    return solve
