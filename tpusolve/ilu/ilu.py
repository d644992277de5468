"""ILU(k) preconditioner with Jacobi triangular solves.

JAX replacement for ``HYPRE_ILU*`` (consumed by the reference at
src/HypreSystem.cpp:328-370 as preconditioner and :457-497 as solver).

Two deliberately parallel-friendly algorithm choices, both of which the
reference itself exposes as its GPU path:

* **Factorization**: Chow-Patel fixed-point iterative ILU — the algorithm
  behind rocSPARSE's iterative ILU0 that the reference configures via
  ``ilu_iterative_setup_{type,option,max_iter,tolerance}``
  (src/HypreSystem.cpp:352-361).  Each sweep is one sparse product +
  elementwise update (vectorized on the host here; the same recurrence is
  device-portable).
* **Triangular solves**: Jacobi-iteration trisolve — the reference's
  ``ilu_tri_solve: 0`` path with ``ilu_lower/upper_jacobi_iters``
  (src/HypreSystem.cpp:363-365) — because exact sequential trisolve doesn't
  vectorize.  Each iteration is one SpMV on the strict triangle.

``ilu_type`` mapping (HYPRE codes, src/HypreSystem.cpp:337):
  0  -> ILU(k) with k = ``ilu_fill_level`` (0 = classic ILU0)
  1  -> ILUT approximated by ILU(k) + post-drop at ``ilu_drop_threshold``
  others -> ILU(k) with a note.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import scipy.sparse as sp
import jax
from jax import lax

from tpusolve.config import ILUConfig
from tpusolve.matrix.sharded import ShardedMatrix
from tpusolve.matrix.spmv import spmv
from tpusolve.matrix.vectors import to_device_vector


def _fill_pattern(A: sp.csr_matrix, k: int) -> sp.csr_matrix:
    """Structural fill pattern for ILU(k): pattern of (|A| + I)^(k+1)."""
    if k <= 0:
        return A
    P = (sp.csr_matrix((np.abs(A.data), A.indices, A.indptr), shape=A.shape)
         + sp.eye(A.shape[0], format="csr"))
    G = P.copy()
    for _ in range(k):
        G = (G @ P).tocsr()
        G.data[:] = 1.0
    # values of A scattered onto grown pattern (zeros elsewhere)
    from tpusolve.amg.interp import _restrict_to_pattern
    return _restrict_to_pattern(A, G)


def chow_patel_ilu(A: sp.csr_matrix, sweeps: int = 5,
                   fill_level: int = 0):
    """Iterative ILU factorization on the (possibly grown) pattern of A.

    Returns (L_strict, u_diag, U_strict) with unit-lower L and U including
    its diagonal separately: A ~= (I + L_strict) @ (diag(u_diag) + U_strict).
    """
    A = _fill_pattern(A.tocsr(), fill_level)
    A.sum_duplicates()
    n = A.shape[0]
    rows = np.repeat(np.arange(n), np.diff(A.indptr))
    cols = A.indices
    vals = A.data.astype(np.float64)
    lower = rows > cols
    upper = ~lower                      # includes diagonal

    diag = A.diagonal()
    diag = np.where(diag != 0, diag, 1.0)

    # init: l_ij = a_ij / a_jj ; u_ij = a_ij
    lvals = np.where(lower, vals / diag[cols], 0.0)
    uvals = np.where(upper, vals, 0.0)

    from tpusolve.amg.interp import _restrict_to_pattern
    pat = sp.csr_matrix((np.ones_like(vals), cols.copy(), A.indptr.copy()),
                        shape=A.shape)

    for _ in range(max(sweeps, 1)):
        # NB: the (data, indices, indptr) constructor does NOT copy data —
        # eliminate_zeros() would corrupt lvals/uvals in place
        L = sp.csr_matrix((lvals.copy(), cols.copy(), A.indptr.copy()),
                          shape=A.shape)
        U = sp.csr_matrix((uvals.copy(), cols.copy(), A.indptr.copy()),
                          shape=A.shape)
        L.eliminate_zeros()
        U.eliminate_zeros()
        prod = _restrict_to_pattern((L @ U).tocsr(), pat)
        p = prod.data                          # aligned with A's pattern
        ujj = np.bincount(rows[rows == cols],
                          weights=uvals[rows == cols], minlength=n)
        ujj = np.where(ujj != 0, ujj, 1.0)
        # i > j:  l_ij = (a_ij - (p_ij - l_ij u_jj)) / u_jj
        new_l = np.where(lower,
                         (vals - p + lvals * ujj[cols]) / ujj[cols], 0.0)
        # i <= j: u_ij = a_ij - p_ij   (p excludes the k=i term since L is
        # strict lower)
        new_u = np.where(upper, vals - p, 0.0)
        lvals, uvals = new_l, new_u

    ujj = np.bincount(rows[rows == cols], weights=uvals[rows == cols],
                      minlength=n)
    ujj = np.where(ujj != 0, ujj, 1.0)
    strict_u = uvals * (rows != cols)
    L = sp.csr_matrix((lvals, (rows, cols)), shape=A.shape)
    U = sp.csr_matrix((strict_u, (rows, cols)), shape=A.shape)
    L.eliminate_zeros()
    U.eliminate_zeros()
    return L.tocsr(), ujj, U.tocsr()


def _drop_small(M: sp.csr_matrix, tol: float) -> sp.csr_matrix:
    if tol <= 0:
        return M
    M = M.tocsr().copy()
    n = M.shape[0]
    rows = np.repeat(np.arange(n), np.diff(M.indptr))
    absv = np.abs(M.data)
    row_max = np.zeros(n)
    nonempty = np.diff(M.indptr) > 0
    if nonempty.any():
        row_max[nonempty] = np.maximum.reduceat(absv, M.indptr[:-1][nonempty])
    M.data[absv < tol * row_max[rows]] = 0.0
    M.eliminate_zeros()
    return M


def _cap_row_nnz(M: sp.csr_matrix, max_nnz: int) -> sp.csr_matrix:
    """ILUT row cap: keep only the ``max_nnz`` largest-magnitude entries per
    row (``ilu_max_nnz_per_row``, ref: src/HypreSystem.cpp:344-350).
    Vectorized: within-row magnitude ranks via one lexsort."""
    if max_nnz <= 0:
        return M
    M = M.tocsr()
    counts = np.diff(M.indptr)
    if not (counts > max_nnz).any():
        return M
    n = M.shape[0]
    rows = np.repeat(np.arange(n), counts)
    absv = np.abs(M.data)
    order = np.lexsort((-absv, rows))
    rank = np.empty(M.data.size, np.int64)
    rank[order] = np.arange(M.data.size) - np.repeat(M.indptr[:-1], counts)
    out = M.copy()
    out.data[rank >= max_nnz] = 0.0
    out.eliminate_zeros()
    return out


def _rcm_permutation(A: sp.csr_matrix) -> np.ndarray:
    """Reverse Cuthill-McKee on the symmetrized pattern
    (``ilu_local_reordering: 1``, ref: src/HypreSystem.cpp:351)."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    return np.asarray(reverse_cuthill_mckee(A.tocsr(), symmetric_mode=False),
                      np.int64)


def ilu_apply(L, U, dinv, r, lower_iters: int, upper_iters: int):
    """z ~= (D+U)^-1 (I+L)^-1 r via Jacobi trisolve iterations (the
    reference's ilu_tri_solve: 0 path, src/HypreSystem.cpp:363-365).
    Jittable; L/U/dinv ride as runtime arguments."""
    def lbody(_, z):
        return r - spmv(L, z)
    z = lax.fori_loop(0, lower_iters, lbody, r)

    def ubody(_, x):
        return dinv * (z - spmv(U, x))
    return lax.fori_loop(0, upper_iters, ubody, dinv * z)


@dataclass
class ILUPreconditioner:
    L: ShardedMatrix          # strict lower
    U: ShardedMatrix          # strict upper
    udiag_inv: jax.Array      # padded sharded 1/u_ii
    lower_iters: int
    upper_iters: int
    notes: list[str]
    _apply: Any = None
    _apply_fn: Any = None
    _A: Any = None            # operator the factorization approximates

    def pair(self):
        """Operator-pair protocol: state rides as a jit argument."""
        return self._apply_fn, (self.L, self.U, self.udiag_inv)

    def apply(self, r):
        """z ~= U^-1 L^-1 r via Jacobi trisolve iterations."""
        return self._apply(r)

    def solve(self, b, x0=None, tol: float = 0.0, maxiter: int = 1):
        """Standalone ILU solver (reference method ``ilu``,
        src/HypreSystem.cpp:457-497): stationary iteration
        x <- x + M(b - A x) with M = the stored factorization."""
        from tpusolve.krylov.stationary import stationary_solve_setup
        solve = stationary_solve_setup(self._A, self.pair(),
                                       tol=tol, maxiter=maxiter)
        return solve(b, x0)


def ilu_setup(A: ShardedMatrix, config: ILUConfig | None = None, *,
              A_host: sp.csr_matrix | None = None) -> ILUPreconditioner:
    cfg = config or ILUConfig()
    from tpusolve.ilu import device_setup as _dev
    path = _dev._device_path(A, cfg)
    if path == "dia":
        # DIA-layout ILU(0): factor on device — no global host CSR at any
        # scale (ref: device ILU setup, src/HypreSystem.cpp:328-370)
        return _dev.ilu_setup_device(A, cfg)
    if path == "ell":
        # generic-ELL ILU(0) (unstructured/file-loaded operators): masked
        # Chow-Patel sweeps on device, block-Jacobi across parts
        return _dev.ilu_setup_device_ell(A, cfg)
    notes: list[str] = []
    mesh = A.mesh
    dtype = A.dtype

    Ah = (A_host if A_host is not None else A.to_scipy()).tocsr()
    fill = cfg.ilu_fill_level
    if cfg.ilu_type == 1:
        notes.append("ilu_type 1 (ILUT) approximated by ILU(k) + "
                     f"drop at {cfg.ilu_drop_threshold} capped at "
                     f"{cfg.ilu_max_nnz_per_row} nnz/row")
    elif cfg.ilu_type not in (0, 1):
        notes.append(f"ilu_type {cfg.ilu_type} mapped to ILU(k) block-Jacobi")

    perm = None
    if cfg.ilu_local_reordering:
        # factor P A P^T (RCM-ordered: better incomplete-factor quality),
        # then un-permute the factors by similarity — the permuted factors
        # stay nilpotent, so the Jacobi trisolves apply unchanged and no
        # device-side permutation gather is ever needed
        perm = _rcm_permutation(Ah)
        notes.append("ilu_local_reordering: RCM")
        Ah_f = Ah[perm][:, perm].tocsr()
    else:
        Ah_f = Ah

    sweeps = max(cfg.ilu_iterative_setup_max_iter, 1) * 5
    L_host, ujj, U_host = chow_patel_ilu(Ah_f, sweeps=sweeps,
                                         fill_level=fill)
    if cfg.ilu_type == 1:
        L_host = _drop_small(L_host, cfg.ilu_drop_threshold)
        U_host = _drop_small(U_host, cfg.ilu_drop_threshold)
        L_host = _cap_row_nnz(L_host, cfg.ilu_max_nnz_per_row)
        U_host = _cap_row_nnz(U_host, cfg.ilu_max_nnz_per_row)

    if perm is not None:
        # similarity back to original ordering: M_orig = P^T M_perm P
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(perm.size)
        L_host = L_host[iperm][:, iperm].tocsr()
        U_host = U_host[iperm][:, iperm].tocsr()
        ujj = ujj[iperm]

    ro = np.asarray(A.row_offsets)
    Lc = L_host.tocoo()
    Uc = U_host.tocoo()
    L_sh = ShardedMatrix.from_coo(mesh, A.shape, Lc.row, Lc.col, Lc.data,
                                  dtype=dtype, row_offsets=ro, col_offsets=ro)
    U_sh = ShardedMatrix.from_coo(mesh, A.shape, Uc.row, Uc.col, Uc.data,
                                  dtype=dtype, row_offsets=ro, col_offsets=ro)
    udiag_inv = to_device_vector(mesh, 1.0 / ujj, ro, A.row_pad, dtype=dtype)

    pre = ILUPreconditioner(L=L_sh, U=U_sh, udiag_inv=udiag_inv,
                            lower_iters=max(cfg.ilu_lower_jacobi_iters, 1),
                            upper_iters=max(cfg.ilu_upper_jacobi_iters, 1),
                            notes=notes, _A=A)

    nl, nu = pre.lower_iters, pre.upper_iters

    def apply_fn(state, r):
        L, U, dinv = state
        return ilu_apply(L, U, dinv, r, nl, nu)

    pre._apply_fn = apply_fn
    applyj = jax.jit(apply_fn)
    pre._apply = lambda r: applyj((pre.L, pre.U, pre.udiag_inv), r)
    return pre
