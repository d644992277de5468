"""Shared Krylov machinery.

Solvers operate on global padded sharded vectors; dot products and norms are
plain ``jnp`` reductions — XLA's SPMD partitioner turns them into ``psum``
across the mesh (the analog of the ``MPI_Allreduce`` inside HYPRE's Krylov kernels).
The padding invariant (padded entries exactly 0) makes reductions mask-free.

Each solver follows the reference's setup/solve split
(``solverSetupPtr_``/``solverSolvePtr_``, ref: src/HypreSystem.h:265-277,
call at src/HypreSystem.cpp:687-723): ``*_setup(A, M, ...)`` returns a jitted
closure ``solve(b, x0) -> SolveResult``, so tracing happens once per operator
and repeated solves (multi-component systems) reuse the executable.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from tpusolve.matrix.sharded import ShardedMatrix
from tpusolve.matrix.spmv import spmv


class SolveResult(NamedTuple):
    x: jax.Array
    iters: jax.Array      # int32 iteration count
    relres: jax.Array     # final ||r|| / ||b||
    converged: jax.Array  # bool
    history: jax.Array | None = None  # per-iteration ||r|| (padded with -1)


def history_buffer(maxiter: int, r0, dtype):
    """(maxiter+1,) residual-norm trace, slot 0 = initial residual,
    unused slots = -1 (the reference's print_level 4 prints per-iteration
    residual norms; here the trace is returned for the harness to print)."""
    import jax.numpy as jnp
    buf = jnp.full(maxiter + 1, -1.0, dtype)
    return buf.at[0].set(r0)


def as_matvec(A) -> Callable:
    """Accept a ShardedMatrix or a callable y = A(x)."""
    if isinstance(A, ShardedMatrix):
        return lambda x: spmv(A, x)
    if callable(A):
        return A
    raise TypeError(f"cannot interpret {type(A)} as a linear operator")


def as_precond(M) -> Callable:
    """Preconditioner contract: closure z = M(r)
    (the Krylov <-> precond contract of HYPRE_PtrToParSolverFcn,
    ref: src/HypreSystem.h:270-271)."""
    if M is None:
        return lambda r: r
    if isinstance(M, ShardedMatrix):
        return lambda r: spmv(M, r)
    if callable(M):
        return M
    raise TypeError(f"cannot interpret {type(M)} as a preconditioner")


# ----------------------------------------------------------------------
# Operator protocol: (static_fn, state_pytree) with y = static_fn(state, x).
#
# Operators MUST flow into jitted solvers as *arguments*, never as closure
# captures: JAX inlines closed-over arrays as HLO constants, which bloats
# executables by the size of a GB-scale hierarchy.

def _identity_fn(_, r):
    return r


def _closure_fn_factory(f):
    return lambda _, x: f(x)


def as_operator_pair(A):
    """-> (fn, state) with fn(state, x) = A @ x; state is a pytree arg."""
    if isinstance(A, ShardedMatrix):
        return spmv, A
    if hasattr(A, "pair"):
        return A.pair()
    # bound method of a pair-capable object (e.g. AMGPreconditioner.apply):
    # unwrap so the GB-scale state rides as an argument, not a capture
    owner = getattr(A, "__self__", None)
    if owner is not None and hasattr(owner, "pair"):
        return owner.pair()
    if callable(A):
        return _closure_fn_factory(A), ()
    raise TypeError(f"cannot interpret {type(A)} as a linear operator")


def as_precond_pair(M):
    """-> (fn, state) with fn(state, r) = M(r)."""
    if M is None:
        return _identity_fn, ()
    return as_operator_pair(M)


def dot(a: jax.Array, b: jax.Array) -> jax.Array:
    return jnp.sum(a * b)


def norm(a: jax.Array) -> jax.Array:
    return jnp.sqrt(jnp.sum(a * a))


def safe_div(num, den):
    """num/den with 0/0 -> 0 (breakdown guards)."""
    return jnp.where(den != 0, num / jnp.where(den != 0, den, 1), 0.0)


def stop_target(bnorm, tol, atol):
    """Convergence target: ||r|| <= max(tol * ||b||, atol)."""
    return jnp.maximum(tol * bnorm, atol)
