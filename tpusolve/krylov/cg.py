"""Preconditioned conjugate gradients.

JAX replacement for ``HYPRE_ParCSRPCG*`` (consumed by the reference at
src/HypreSystem.cpp:440-455).  Jitted ``lax.while_loop``; the two dot products
per iteration become ``psum`` collectives over the mesh.

The operator and preconditioner state enter the jitted function as pytree
*arguments* (see ``as_operator_pair``) so GB-scale hierarchies are runtime
buffers, not HLO constants.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tpusolve.krylov.common import (
    SolveResult, as_operator_pair, as_precond_pair, dot, norm, safe_div,
    stop_target, history_buffer)


def pcg_setup(A, M=None, *, tol: float = 1e-5, atol: float = 0.0,
              maxiter: int = 1000, fused: bool = True):
    """Build a jitted PCG solver closure for operator ``A`` and
    preconditioner ``M`` (z = M(r)).

    ``fused=False`` dispatches one jitted STEP per iteration (host loop)
    instead of one while_loop program: XLA's buffer assignment for the
    fused program must hold every iteration buffer plus the V-cycle's
    temps simultaneously, which exceeds a 16 GB chip near ~50M rows
    (measured r5 at 384^3); per-step programs bound temps to one
    iteration at a ~30 ms/step dispatch cost — negligible when a step
    costs hundreds of ms at that scale."""
    afn, astate = as_operator_pair(A)
    mfn, mstate = as_precond_pair(M)
    if not fused:
        return _pcg_stepped(afn, astate, mfn, mstate, tol=tol, atol=atol,
                            maxiter=maxiter)

    @jax.jit
    def _solve(astate, mstate, b, x0):
        matvec = lambda x: afn(astate, x)
        precond = lambda r: mfn(mstate, r)
        x = jnp.zeros_like(b) if x0 is None else x0
        bnorm = norm(b)
        target = stop_target(bnorm, tol, atol)
        r = b - matvec(x)
        z = precond(r)
        p = z
        rz = dot(r, z)
        rnorm = norm(r)
        hist = history_buffer(maxiter, rnorm, b.dtype)

        def cond(state):
            _, _, _, _, rnorm, _, it = state
            return (it < maxiter) & (rnorm > target)

        def body(state):
            x, r, p, rz, _, hist, it = state
            Ap = matvec(p)
            alpha = safe_div(rz, dot(p, Ap))
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = dot(r, z)
            beta = safe_div(rz_new, rz)
            p = z + beta * p
            rnorm = norm(r)
            hist = hist.at[it + 1].set(rnorm)
            return x, r, p, rz_new, rnorm, hist, it + 1

        x, r, p, rz, rnorm, hist, it = lax.while_loop(
            cond, body, (x, r, p, rz, rnorm, hist, jnp.int32(0)))
        relres = safe_div(rnorm, bnorm)
        return SolveResult(x=x, iters=it, relres=relres,
                           converged=rnorm <= target, history=hist)

    def solve(b, x0=None):
        return _solve(astate, mstate, b, x0)

    solve._fn = _solve        # (astate, mstate, b, x0) -> SolveResult
    solve._state = (astate, mstate)
    return solve


def _pcg_stepped(afn, astate, mfn, mstate, *, tol, atol, maxiter):
    """Host-looped PCG: identical update formulas to the fused path."""
    import numpy as np

    @jax.jit
    def _init(astate, mstate, b, x0):
        x = jnp.zeros_like(b) if x0 is None else x0
        bnorm = norm(b)
        r = b - afn(astate, x)
        z = mfn(mstate, r)
        rz = dot(r, z)
        return x, r, z, rz, norm(r), bnorm

    @jax.jit
    def _step(astate, mstate, x, r, p, rz):
        Ap = afn(astate, p)
        alpha = safe_div(rz, dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = mfn(mstate, r)
        rz_new = dot(r, z)
        beta = safe_div(rz_new, rz)
        p = z + beta * p
        return x, r, p, rz_new, norm(r)

    def solve(b, x0=None):
        x, r, z, rz, rnorm, bnorm = _init(astate, mstate, b, x0)
        target = max(tol * float(bnorm), atol)
        hist = [float(rnorm)]
        p = z
        it = 0
        while it < maxiter and hist[-1] > target:
            x, r, p, rz, rnorm = _step(astate, mstate, x, r, p, rz)
            hist.append(float(rnorm))
            it += 1
        relres = hist[-1] / float(bnorm) if float(bnorm) else 0.0
        return SolveResult(
            x=x, iters=jnp.int32(it), relres=jnp.asarray(relres),
            converged=jnp.asarray(hist[-1] <= target),
            history=jnp.asarray(np.asarray(hist, np.float64)))

    solve._state = (astate, mstate)
    return solve


def pcg(A, b, x0=None, M=None, *, tol: float = 1e-5, atol: float = 0.0,
        maxiter: int = 1000) -> SolveResult:
    """One-shot convenience wrapper around :func:`pcg_setup`."""
    return pcg_setup(A, M, tol=tol, atol=atol, maxiter=maxiter)(b, x0)
