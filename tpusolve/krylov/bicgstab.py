"""Preconditioned BiCGSTAB for non-symmetric systems (momentum equations).

JAX replacement for ``HYPRE_ParCSRBiCGSTAB*`` (consumed by the
reference at src/HypreSystem.cpp:423-438).  Right-preconditioned van der
Vorst BiCGSTAB; two matvecs + two preconditioner applications per iteration,
all reductions fused by XLA into psum collectives.  Operator/preconditioner
state enters as pytree arguments (no HLO constants).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tpusolve.krylov.common import (
    SolveResult, as_operator_pair, as_precond_pair, dot, norm, safe_div,
    stop_target, history_buffer)


def bicgstab_setup(A, M=None, *, tol: float = 1e-5, atol: float = 0.0,
                   maxiter: int = 1000):
    afn, astate = as_operator_pair(A)
    mfn, mstate = as_precond_pair(M)

    @jax.jit
    def _solve(astate, mstate, b, x0):
        matvec = lambda x: afn(astate, x)
        precond = lambda r: mfn(mstate, r)
        x = jnp.zeros_like(b) if x0 is None else x0
        bnorm = norm(b)
        target = stop_target(bnorm, tol, atol)
        r = b - matvec(x)
        r0 = r  # shadow residual
        rho = dot(r0, r)
        p = r
        rnorm = norm(r)
        hist = history_buffer(maxiter, rnorm, b.dtype)

        def cond(state):
            x, r, p, rho, rnorm, _, it = state
            return (it < maxiter) & (rnorm > target)

        def body(state):
            x, r, p, rho, _, hist, it = state
            phat = precond(p)
            v = matvec(phat)
            alpha = safe_div(rho, dot(r0, v))
            s = r - alpha * v
            shat = precond(s)
            t = matvec(shat)
            omega = safe_div(dot(t, s), dot(t, t))
            x = x + alpha * phat + omega * shat
            r = s - omega * t
            rho_new = dot(r0, r)
            beta = safe_div(rho_new, rho) * safe_div(alpha, omega)
            p = r + beta * (p - omega * v)
            rnorm = norm(r)
            hist = hist.at[it + 1].set(rnorm)
            return x, r, p, rho_new, rnorm, hist, it + 1

        x, r, p, rho, rnorm, hist, it = lax.while_loop(
            cond, body, (x, r, p, rho, rnorm, hist, jnp.int32(0)))
        relres = safe_div(rnorm, bnorm)
        return SolveResult(x=x, iters=it, relres=relres,
                           converged=rnorm <= target, history=hist)

    def solve(b, x0=None):
        return _solve(astate, mstate, b, x0)

    solve._fn = _solve        # (astate, mstate, b, x0) -> SolveResult
    solve._state = (astate, mstate)
    return solve


def bicgstab(A, b, x0=None, M=None, **kw) -> SolveResult:
    return bicgstab_setup(A, M, **kw)(b, x0)
