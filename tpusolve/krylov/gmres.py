"""Restarted GMRES family: GMRES, COGMRES, FlexGMRES.

JAX replacements for ``HYPRE_ParCSRGMRES*`` (+``SetKDim`` restart,
ref: src/HypreSystem.cpp:390-404), ``HYPRE_ParCSRCOGMRES*`` (+``SetCGS``,
ref: :372-388) and ``HYPRE_ParCSRFlexGMRES*`` (ref: :406-421).

Design notes:

* Orthogonalization is **batched classical Gram-Schmidt**: the projection
  ``h = V w`` is a single (m+1, n) x (n,) product at full float32
  precision (no TF32) — one fused global
  reduction per iteration, which is exactly the communication-avoiding
  property COGMRES exists for (the reference ships COGMRES for this reason).
  ``cgs=2`` re-orthogonalizes once (CGS2), matching ``HYPRE_COGMRESSetCGS``'s
  2-step option and restoring MGS-level stability.
* The Krylov basis ``V`` is a dense (m+1, n) array sharded over the row
  axis; basis rows are zero until filled, so no masking is needed in the
  projection.
* Right preconditioning throughout (residual is the true residual);
  FlexGMRES additionally stores the preconditioned vectors ``Z`` so the
  preconditioner may change per iteration (ref behavior of FlexGMRES).
* Inner loop is a ``lax.while_loop`` with static bound ``kspace``; the
  triangular solve pads the Hessenberg with an identity beyond the reached
  column so early exits need no dynamic shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from tpusolve.krylov.common import (
    SolveResult, as_operator_pair, as_precond_pair, norm, safe_div,
    stop_target, history_buffer)



def _dot(a, b):
    """Full-precision contraction: a float32 product at default precision
    may run in TF32 (about 10 mantissa bits) on GPUs."""
    return jnp.dot(a, b, precision=lax.Precision.HIGHEST)

def _givens(a, b):
    """Givens rotation zeroing b: returns (c, s, r) with c*a + s*b = r."""
    rho = jnp.sqrt(a * a + b * b)
    c = jnp.where(rho != 0, a / jnp.where(rho != 0, rho, 1), 1.0)
    s = jnp.where(rho != 0, b / jnp.where(rho != 0, rho, 1), 0.0)
    return c, s, rho


def _gmres_cycle(matvec, precond, m, cgs, flexible, b, x, target, dtype,
                 hist, it0):
    """One restart cycle of at most m inner iterations.

    Returns (x_new, rnorm, inner_iters, hist)."""
    n = b.shape[0]
    r = b - matvec(x)
    beta = norm(r)

    V = jnp.zeros((m + 1, n), dtype)
    V = V.at[0].set(jnp.where(beta != 0, r / jnp.where(beta != 0, beta, 1), 0))
    Z = jnp.zeros((m if flexible else 1, n), dtype)
    H = jnp.zeros((m + 1, m), dtype)
    cs = jnp.zeros(m, dtype)
    sn = jnp.zeros(m, dtype)
    g = jnp.zeros(m + 1, dtype).at[0].set(beta)

    def cond(state):
        V, Z, H, cs, sn, g, j, res, hist = state
        return (j < m) & (res > target)

    def body(state):
        V, Z, H, cs, sn, g, j, res, hist = state
        v = V[j]
        z = precond(v)
        w = matvec(z)
        if flexible:
            Z = Z.at[j].set(z)

        # batched classical Gram-Schmidt: one fused reduction
        h = _dot(V, w)                  # rows > j are zero => h[k>j] = 0
        w = w - _dot(h, V)
        if cgs >= 2:                    # CGS2 re-orthogonalization
            h2 = _dot(V, w)
            w = w - _dot(h2, V)
            h = h + h2
        hj1 = norm(w)
        V = V.at[j + 1].set(
            jnp.where(hj1 != 0, w / jnp.where(hj1 != 0, hj1, 1), 0))

        # apply previous Givens rotations to the new column
        def rot_body(i, hcol):
            pred = i < j
            t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
            t2 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
            hcol = hcol.at[i].set(jnp.where(pred, t1, hcol[i]))
            hcol = hcol.at[i + 1].set(jnp.where(pred, t2, hcol[i + 1]))
            return hcol

        hcol = jnp.zeros(m + 1, dtype).at[: m + 1].set(h)
        hcol = hcol.at[j + 1].set(hj1)
        hcol = lax.fori_loop(0, m, rot_body, hcol)

        c, s, rho = _givens(hcol[j], hcol[j + 1])
        hcol = hcol.at[j].set(rho).at[j + 1].set(0.0)
        cs = cs.at[j].set(c)
        sn = sn.at[j].set(s)
        gj = g[j]
        g = g.at[j].set(c * gj).at[j + 1].set(-s * gj)
        H = H.at[:, j].set(hcol)
        res_new = jnp.abs(g[j + 1])
        hist = hist.at[it0 + j + 1].set(res_new)
        return V, Z, H, cs, sn, g, j + 1, res_new, hist

    V, Z, H, cs, sn, g, k, res, hist = lax.while_loop(
        cond, body, (V, Z, H, cs, sn, g, jnp.int32(0), beta, hist))

    # solve the k x k least-squares system, padded to m with identity
    cols = jnp.arange(m)
    R = jnp.where(cols[None, :] < k, H[:m, :], jnp.eye(m, dtype=dtype))
    R = jnp.triu(R)
    R = jnp.where(jnp.diag(R)[:, None] == 0,
                  jnp.eye(m, dtype=dtype), R)  # happy-breakdown guard
    gk = jnp.where(cols < k, g[:m], 0.0)
    y = jax.scipy.linalg.solve_triangular(R, gk, lower=False)

    if flexible:
        dx = _dot(y, Z)
    else:
        dx = precond(_dot(y, V[:m]))
    return x + dx, res, k, hist


def gmres_setup(A, M=None, *, tol: float = 1e-5, atol: float = 0.0,
                maxiter: int = 1000, restart: int = 10, cgs: int = 1,
                flexible: bool = False):
    """Build a jitted restarted-GMRES solver closure.

    ``restart`` is the Krylov dimension (reference key ``kspace``,
    src/HypreSystem.cpp:396); ``cgs=2`` enables two-step classical
    Gram-Schmidt; ``flexible=True`` gives FlexGMRES.
    """
    afn, astate = as_operator_pair(A)
    mfn, mstate = as_precond_pair(M)
    m = int(restart)

    @jax.jit
    def _solve(astate, mstate, b, x0):
        matvec = lambda v: afn(astate, v)
        precond = lambda r: mfn(mstate, r)
        x = jnp.zeros_like(b) if x0 is None else x0
        dtype = b.dtype
        bnorm = norm(b)
        target = stop_target(bnorm, tol, atol)

        def cond(state):
            x, rnorm, it, hist = state
            return (it < maxiter) & (rnorm > target)

        def body(state):
            x, rnorm, it, hist = state
            x, res, k, hist = _gmres_cycle(matvec, precond, m, cgs, flexible,
                                           b, x, target, dtype, hist, it)
            return x, res, it + k, hist

        rnorm0 = norm(b - matvec(x))
        hist = history_buffer(maxiter + m, rnorm0, dtype)
        x, rnorm, it, hist = lax.while_loop(
            cond, body, (x, rnorm0, jnp.int32(0), hist))
        relres = safe_div(rnorm, bnorm)
        return SolveResult(x=x, iters=it, relres=relres,
                           converged=rnorm <= target, history=hist)

    def solve(b, x0=None):
        return _solve(astate, mstate, b, x0)

    solve._fn = _solve        # (astate, mstate, b, x0) -> SolveResult
    solve._state = (astate, mstate)
    return solve


def gmres(A, b, x0=None, M=None, **kw) -> SolveResult:
    return gmres_setup(A, M, **kw)(b, x0)


def cogmres_setup(A, M=None, *, cgs: int = 1, **kw):
    """Communication-optimized GMRES (ref: src/HypreSystem.cpp:372-388).

    The batched-CGS GMRES above already performs one fused reduction per
    iteration — the defining COGMRES property — so this shares the kernel;
    ``cgs`` selects 1- or 2-step classical Gram-Schmidt
    (``HYPRE_COGMRESSetCGS``).
    """
    return gmres_setup(A, M, cgs=cgs, **kw)


def fgmres_setup(A, M=None, **kw):
    """Flexible GMRES (ref: src/HypreSystem.cpp:406-421): stores the
    preconditioned basis so M may vary per iteration."""
    return gmres_setup(A, M, flexible=True, **kw)
