"""BoomerAMG-equivalent multilevel hierarchy: setup + jitted cycles.

JAX replacement for ``HYPRE_BoomerAMG{Create,Setup,Solve}`` and the
~45-key setter surface the reference drives (src/HypreSystem.cpp:91-326).

Split of labor (SURVEY.md section 7 "hard parts"):

* **Setup** (strength -> PMIS coarsening -> classical/direct interpolation ->
  Galerkin RAP) runs vectorized on the host — the analog of the reference's
  separately-timed "Preconditioner setup" phase (src/HypreSystem.cpp:731) —
  producing a static hierarchy of ShardedMatrix operators.
* **Cycling** (smooth -> restrict -> recurse -> prolong -> smooth) is a pure
  jitted function over sharded vectors; every SpMV is the shard_map halo
  kernel and every reduction a psum.

The hierarchy is introspectable (``levels[i].A/P/R``), matching the
reference's reach into ``hypre_ParAMGData`` for the AMG-matrix dump
(src/HypreSystem.cpp:700-714).
"""

from __future__ import annotations

import dataclasses
import os
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp

from tpusolve.config import BoomerAMGConfig
from tpusolve.matrix.sharded import ShardedMatrix
from tpusolve.matrix.spmv import spmv
from tpusolve.matrix.vectors import pad_vector, replicated
from tpusolve.mesh import row_decomposition
from tpusolve.amg import strength as strength_mod
from tpusolve.amg import coarsen as coarsen_mod
from tpusolve.amg import interp as interp_mod
from tpusolve.amg import galerkin
from tpusolve.amg import smoothers
from tpusolve.amg import device_setup
from tpusolve.krylov.common import SolveResult
from tpusolve.krylov.stationary import stationary_solve_setup


@jax.tree_util.register_dataclass
@dataclass
class Level:
    """One level of the hierarchy.

    A pytree: the operators/vectors are leaves so the whole hierarchy flows
    into jitted cycles as a runtime argument (never as HLO constants — a
    GB-scale hierarchy inlined as constants overflows compile payloads).
    Transfers are either sparse operators (P/R ShardedMatrix — algebraic
    hierarchy) or structured closures (prolong/restrict static fields —
    geometric hierarchy); exactly one pair is set on non-coarsest levels."""
    A: ShardedMatrix
    P: ShardedMatrix | None          # (n_fine, n_coarse); None at coarsest
    R: ShardedMatrix | None          # P^T
    dinv_l1: jax.Array | None        # 1 / l1 row norms (padded, sharded)
    dinv: jax.Array | None           # 1 / diag        (padded, sharded)
    cmask: jax.Array | None = None   # 1.0 at C-points (CF relax order)
    ilu_L: ShardedMatrix | None = None   # complex (ILU) smoother factors
    ilu_U: ShardedMatrix | None = None   # (smooth_type, ref :251-321)
    ilu_dinv: jax.Array | None = None
    A_relax: ShardedMatrix | None = None  # reduced-precision smoother twin
    cheby_bounds: tuple | None = dataclasses.field(
        default=None, metadata=dict(static=True))
    n: int = dataclasses.field(default=0, metadata=dict(static=True))
    nnz: int = dataclasses.field(default=0, metadata=dict(static=True))
    prolong: Any = dataclasses.field(default=None,
                                     metadata=dict(static=True))
    restrict: Any = dataclasses.field(default=None,
                                      metadata=dict(static=True))


@dataclass
class AMGPreconditioner:
    levels: list[Level]
    coarse_inv: jax.Array            # (Npad_c, Npad_c) replicated pinv
    config: BoomerAMGConfig
    notes: list[str]
    _cycle_fn: Any = None            # cycle_fn(state, r); state = pair()[1]
    _cycle_jit: Any = None
    num_levels: int = 0
    _solvers: dict = dataclasses.field(default_factory=dict)

    def pair(self):
        """Operator-pair protocol: (fn, state) with z = fn(state, r) —
        lets Krylov solvers take the hierarchy as a jit argument."""
        return self._cycle_fn, (tuple(self.levels), self.coarse_inv)

    def apply(self, r):
        """z = (one AMG cycle)(r) from zero initial guess — the
        preconditioner contract."""
        if self._cycle_jit is None:
            self._cycle_jit = jax.jit(self._cycle_fn)
        return self._cycle_jit((tuple(self.levels), self.coarse_inv), r)

    def solve(self, b, x0=None, tol: float | None = None,
              maxiter: int | None = None) -> SolveResult:
        """Standalone AMG iteration (reference method ``boomeramg``,
        src/HypreSystem.cpp:91-117): stationary cycles until tol, as one
        jitted while_loop (no op-by-op dispatch)."""
        cfg = self.config
        tol = cfg.tolerance if tol is None else tol
        maxiter = cfg.max_iterations if maxiter is None else maxiter
        key = (float(tol), int(maxiter))
        if key not in self._solvers:
            self._solvers[key] = stationary_solve_setup(
                self.levels[0].A, self, tol=tol, maxiter=maxiter)
        return self._solvers[key](b, x0)

    def describe(self) -> str:
        """Grid/operator complexity table (hypre print_level>=1 analog)."""
        lines = ["AMG hierarchy:",
                 f"  {'lvl':>3s} {'rows':>12s} {'nnz':>14s} {'avg nnz/row':>12s}"]
        n0 = self.levels[0].n
        nnz0 = self.levels[0].nnz
        for i, lev in enumerate(self.levels):
            avg = lev.nnz / max(lev.n, 1)
            lines.append(f"  {i:3d} {lev.n:12d} {lev.nnz:14d} {avg:12.2f}")
        grid_c = sum(l.n for l in self.levels) / max(n0, 1)
        op_c = sum(l.nnz for l in self.levels) / max(nnz0, 1)
        lines.append(f"  grid complexity {grid_c:.3f}   "
                     f"operator complexity {op_c:.3f}")
        for note in self.notes:
            lines.append(f"  note: {note}")
        return "\n".join(lines)


def _sharded_from_scipy(mesh, M: sp.spmatrix, dtype, row_offsets=None,
                        col_offsets=None,
                        allow_tiles: bool = True) -> ShardedMatrix:
    """``allow_tiles=False`` forces the plain padded-ELL layout.  Used for
    P/R: transfer operators average ~2-4 entries/row, so the dense-tile
    layouts (BELL/BDIA) expand them 40-60x (P at 128^3: 35 MB of entries ->
    a 6.4 GB tile array; 51 GB at 256^3) — unaffordable in HBM and the
    dominant cost of the whole setup phase to build.  Square coarse
    operators are denser per row and keep the full layout selection."""
    return ShardedMatrix.from_csr_host(
        mesh, M.tocsr(), dtype=dtype, row_offsets=row_offsets,
        col_offsets=col_offsets, allow_bell=allow_tiles,
        allow_bdia=allow_tiles)


# dense coarse solve guard: above this size the replicated (Npad_c^2) pinv
# is substituted by coarse relaxation sweeps (memory ~ Npad_c^2 per device)
DENSE_COARSE_MAX = 8192
_COARSE_FALLBACK_SWEEPS = 10


def _resolve_kinds(cfg: BoomerAMGConfig):
    notes = []
    kind_down, note = smoothers.resolve_relax(
        cfg.relax_down if cfg.relax_down is not None else cfg.relax_type)
    if note:
        notes.append(note)
    kind_up, note = smoothers.resolve_relax(
        cfg.relax_up if cfg.relax_up is not None else cfg.relax_type)
    if note and note not in notes:
        notes.append(note)
    kind_coarse, note = smoothers.resolve_coarse_relax(cfg.relax_coarse)
    if note and note not in notes:
        notes.append(note)
    return kind_down, kind_up, kind_coarse, notes


def boomeramg_setup(A: ShardedMatrix, config: BoomerAMGConfig | None = None,
                    *, A_host: sp.csr_matrix | None = None,
                    seed: int = 1234, lattice_parts=None) -> AMGPreconditioner:
    """Build the AMG hierarchy for sharded operator ``A``.

    ``A_host`` may supply the host CSR to avoid a device gather when the
    caller already has it (e.g. straight after file load).

    ``lattice_parts`` (stencil.laplace27 ``with_lattice=True`` payload)
    enables the SHARDED device fine-level setup on multi-part meshes
    (amg/device_setup_sharded.py).

    Set ``TPUSOLVE_SETUP_LOG=1`` for per-level phase timings (the analog
    of BoomerAMG's setup print_level output).
    """
    log_on = os.environ.get("TPUSOLVE_SETUP_LOG", "0") == "1"
    _t = [time.perf_counter()]

    def _phase(label):
        if log_on:
            t = time.perf_counter()
            print(f"    setup: {label:28s} {t - _t[0]:8.2f}s", flush=True)
            _t[0] = t

    cfg = config or BoomerAMGConfig()
    mesh = A.mesh
    dtype = A.dtype
    kind_down, kind_up, kind_coarse, notes = _resolve_kinds(cfg)
    # remaining reference keys (src/HypreSystem.cpp:180-190) with no
    # behavioral freedom here — record how each is honored/mapped so no
    # accepted key is a silent no-op:
    if cfg.rap2:
        notes.append("rap2=1 honored by construction: RAP is always "
                     "computed as two products, (A@P) then P^T@(AP)")
    if cfg.keep_transpose:
        notes.append("keep_transpose=1 honored by construction: R = P^T "
                     "is materialized and stored per level")
    if cfg.variant is not None:
        notes.append(f"variant {cfg.variant} (Schwarz smoother variant) "
                     "not applicable: Schwarz smoothing maps to ILU(0)")

    min_coarse = cfg.min_coarse_size or 1
    max_coarse = max(cfg.max_coarse_size, min_coarse)

    levels: list[Level] = []
    A_sh = A
    Ah = None
    Ah_fn = None       # deferred coarse-CSR fetch from the device paths
    lvl_start = 0

    def _host_csr() -> sp.csr_matrix:
        """Materialize the current level's host CSR, fetching the deferred
        device coarse operator only when the host pipeline really needs
        it (full device recursion never pays this transfer)."""
        nonlocal Ah
        if Ah is None:
            tt = time.perf_counter()
            Ah = Ah_fn().tocsr()
            if log_on:
                print(f"    setup: coarse CSR fetch (deferred) "
                      f"{time.perf_counter() - tt:8.2f}s", flush=True)
        return Ah

    # --- device fine-level setup (amg/device_setup.py): DIA operators run
    # strength/PMIS/interp/RAP on the device — the analog of the reference's
    # on-device BoomerAMGSetup (src/HypreSystem.cpp:692) — and hand the 8x
    # smaller coarse level back to this host pipeline.  Also the only path
    # that never needs the fine host CSR (north-star problem sizes).
    res = None
    dev_note = None
    if A.shape[0] > max_coarse and cfg.max_levels > 1:
        log = (lambda s: print(s, flush=True)) if log_on else None
        from tpusolve.amg import device_setup_sharded
        from tpusolve.amg import device_setup_ell
        if device_setup_sharded.eligible(A, cfg, lattice_parts):
            if log_on:
                print(f"  setup level 0 [device, {A.nparts} parts]: "
                      f"n={A.shape[0]} nnz={A.nnz}", flush=True)
            res = device_setup_sharded.device_level0_sharded(
                A, cfg, lattice_parts, seed=seed, log=log)
            dev_note = ("level 0 setup on device (DIA offset algebra: "
                        "strength/PMIS/interp/RAP as shifted streaming ops)")
        elif device_setup.eligible(A, cfg):
            if log_on:
                print(f"  setup level 0 [device]: n={A.shape[0]} "
                      f"nnz={A.nnz}", flush=True)
            res = device_setup.device_level0(A, cfg, seed=seed, log=log)
            dev_note = ("level 0 setup on device (DIA offset algebra: "
                        "strength/PMIS/interp/RAP as shifted streaming ops)")
        elif device_setup_ell.eligible(A, cfg, A_host):
            if log_on:
                print(f"  setup level 0 [device, generic ELL]: "
                      f"n={A.shape[0]} nnz={A.nnz}", flush=True)
            res = device_setup_ell.device_level0_ell(
                A, cfg, A_host=A_host, seed=seed, log=log)
            dev_note = ("level 0 setup on device (generic ELL: PMIS via "
                        "gather/scatter rounds, RAP as sort-based SpGEMM)")
        if res is not None and res["nc"] >= min_coarse:
            lev = _make_level_device(mesh, A, res, kind_down, kind_up, cfg)
            levels.append(lev)
            Ah_fn = res["Ah_c_fn"]
            A_sh = res["Ac"]
            lvl_start = 1
            notes.append(dev_note)
            if cfg.coarsen_type != 8:
                notes.append(f"device setup: coarsen_type "
                             f"{cfg.coarsen_type} runs PMIS (as in hypre's "
                             "device setup)")
        _t[0] = time.perf_counter()

    if lvl_start == 0:
        Ah = (A_host if A_host is not None else A.to_scipy()).tocsr()
        Ah.sum_duplicates()

    for lvl in range(lvl_start, cfg.max_levels):
        n = A_sh.shape[0]
        if n <= max_coarse or lvl == cfg.max_levels - 1:
            break
        # device recursion (ROADMAP r3): coarse operators produced by the
        # device paths are live ELL ShardedMatrix objects — keep running
        # them through the generic-ELL device setup while they are big
        # enough, instead of paying the host pipeline per coarse level
        from tpusolve.amg import device_setup_ell
        if device_setup_ell.eligible(A_sh, cfg, Ah):
            if log_on:
                print(f"  setup level {lvl} [device, generic ELL]: "
                      f"n={n} nnz={A_sh.nnz}", flush=True)
            log = (lambda s: print(s, flush=True)) if log_on else None
            res = device_setup_ell.device_level0_ell(
                A_sh, cfg, A_host=Ah, seed=seed + lvl, log=log)
            if res is not None:
                if res["nc"] < min_coarse:
                    break     # next grid would be below min_coarse_size
                lev = _make_level_device(mesh, A_sh, res, kind_down,
                                         kind_up, cfg)
                levels.append(lev)
                Ah = None
                Ah_fn = res["Ah_c_fn"]
                A_sh = res["Ac"]
                note = ("coarse levels recursed on device (generic ELL "
                        "setup)")
                if note not in notes:
                    notes.append(note)
                continue
            # res None: coarsening stalled on device — the host stages
            # below reach the same conclusion and stop cleanly
        Ah = _host_csr()
        if log_on:
            print(f"  setup level {lvl}: n={n} nnz={Ah.nnz}", flush=True)
        _t[0] = time.perf_counter()
        S = strength_mod.classical_strength(Ah, cfg.strong_threshold)
        _phase("strength")
        aggressive = lvl < cfg.agg_num_levels
        if aggressive:
            # agg_num_levels finest levels coarsen aggressively
            # (ref: src/HypreSystem.cpp:207-213)
            split = coarsen_mod.aggressive_pmis(S, seed=seed + lvl)
            note = "aggressive (two-pass PMIS) coarsening"
            if note not in notes:
                notes.append(note)
        else:
            split, note = coarsen_mod.coarsen(S, cfg.coarsen_type,
                                              seed=seed + lvl)
            if note and note not in notes:
                notes.append(note)
        _phase("coarsen")
        nc = int((split == coarsen_mod.C_PT).sum())
        if nc == 0 or nc >= n:
            break  # coarsening stalled: stop here, direct-solve this level
        if nc < min_coarse:
            # BoomerAMG stops when the next grid would drop below
            # min_coarse_size (ref: HYPRE_BoomerAMGSetMinCoarseSize,
            # src/HypreSystem.cpp:216-219)
            break
        P_host, note = interp_mod.build_interpolation(
            Ah, S, split,
            cfg.agg_interp_type if aggressive else cfg.interp_type,
            cfg.trunc_factor, cfg.p_max_elmts,
            require_distance2=aggressive)
        if note and note not in notes:
            notes.append(note)
        _phase("interpolation")
        Ac = galerkin.rap(Ah, P_host)
        _phase("galerkin RAP")
        ng_tol = cfg.non_galerkin_tol
        if cfg.nongalerk_tol:
            idx = min(lvl, len(cfg.nongalerk_tol) - 1)
            ng_tol = float(cfg.nongalerk_tol[idx])
        if ng_tol > 0:
            Ac = galerkin.nongalerkin_sparsify(Ac, ng_tol)

        lev = _make_level(mesh, A_sh, Ah, dtype, kind_down, kind_up, cfg)
        _phase("level vectors")
        if lvl < cfg.smooth_num_levels and cfg.smooth_type is not None:
            _attach_ilu_smoother(lev, mesh, A_sh, Ah, dtype, cfg, notes)
        if cfg.relax_order == 1:
            from tpusolve.matrix.vectors import to_device_vector
            lev.cmask = to_device_vector(
                mesh, (split == coarsen_mod.C_PT).astype(np.float64),
                np.asarray(A_sh.row_offsets), A_sh.row_pad, dtype=dtype)
        row_off = np.asarray(A_sh.row_offsets)
        col_off = row_decomposition(nc, A_sh.nparts)
        lev.P = _sharded_from_scipy(mesh, P_host, dtype,
                                    row_offsets=row_off,
                                    col_offsets=col_off,
                                    allow_tiles=False)
        lev.R = _sharded_from_scipy(mesh, P_host.T.tocsr(), dtype,
                                    row_offsets=col_off,
                                    col_offsets=row_off,
                                    allow_tiles=False)
        _phase("P/R device assembly")
        levels.append(lev)

        Ah = Ac
        A_sh = _sharded_from_scipy(mesh, Ah, dtype)
        _phase("coarse A device assembly")

    # coarsest level: dense (pseudo)inverse or relaxation sweeps (needs
    # the host CSR — small by now, so a deferred fetch is cheap)
    Ah = _host_csr()
    kind_coarse, coarse_sweeps = _guard_coarse(kind_coarse, Ah.shape[0],
                                               cfg, notes)
    lev = _make_level(mesh, A_sh, Ah, dtype, kind_down, kind_up, cfg,
                      kind_coarse=kind_coarse)
    levels.append(lev)
    coarse_inv = _coarse_solver_data(mesh, Ah, A_sh, dtype, kind_coarse)

    pre = AMGPreconditioner(levels=levels, coarse_inv=coarse_inv, config=cfg,
                            notes=notes, num_levels=len(levels))
    pre._cycle_fn = _build_cycle(pre, kind_down, kind_up, cfg,
                                 kind_coarse=kind_coarse,
                                 coarse_sweeps=coarse_sweeps)
    return pre


def _attach_ilu_smoother(lev: Level, mesh, A_sh, Ah, dtype, cfg, notes):
    """Complex-smoother block: ILU(0) factors attached to a fine level
    (``smooth_type``/``smooth_num_levels``/``smooth_num_sweeps``, ref:
    src/HypreSystem.cpp:237-321).  HYPRE's codes 5 (ParILUK), 7 (Pilut),
    9 (Euclid) are all ILU-family; 6 (Schwarz) is substituted."""
    from tpusolve.ilu.ilu import chow_patel_ilu
    from tpusolve.matrix.vectors import to_device_vector
    st = cfg.smooth_type
    if st not in (5, 6, 7, 9):
        note = f"smooth_type {st} unsupported: levels use relax_type instead"
        if note not in notes:
            notes.append(note)
        return
    note = {5: "smooth_type 5 (ParILUK) as Chow-Patel ILU(0) + Jacobi trisolve",
            7: "smooth_type 7 (Pilut) as Chow-Patel ILU(0) + Jacobi trisolve",
            9: "smooth_type 9 (Euclid) as Chow-Patel ILU(0) + Jacobi trisolve",
            6: "smooth_type 6 (Schwarz) mapped to ILU(0) smoothing"}[st]
    if note not in notes:
        notes.append(note)
    L_host, ujj, U_host = chow_patel_ilu(Ah.tocsr(), sweeps=5, fill_level=0)
    ro = np.asarray(A_sh.row_offsets)
    lev.ilu_L = ShardedMatrix.from_csr_host(
        mesh, L_host, dtype=dtype, row_offsets=ro, col_offsets=ro)
    lev.ilu_U = ShardedMatrix.from_csr_host(
        mesh, U_host, dtype=dtype, row_offsets=ro, col_offsets=ro)
    lev.ilu_dinv = to_device_vector(mesh, 1.0 / ujj, ro, A_sh.row_pad,
                                    dtype=dtype)


def _guard_coarse(kind_coarse, n_c: int, cfg, notes: list):
    """Dense-solve guard + coarse sweep count resolution."""
    ncs = (cfg.num_coarse_sweeps if cfg.num_coarse_sweeps is not None
           else cfg.num_sweeps)
    if kind_coarse == smoothers.RELAX_DIRECT and n_c > DENSE_COARSE_MAX:
        notes.append(
            f"coarse level has {n_c} rows > {DENSE_COARSE_MAX}: dense "
            "inverse replaced by l1-Jacobi sweeps (raise max_coarse_size "
            "guardedly or set relax_coarse)")
        return smoothers.RELAX_L1_JACOBI, max(ncs, _COARSE_FALLBACK_SWEEPS)
    return kind_coarse, ncs


def _coarse_solver_data(mesh, Ah, A_sh, dtype, kind_coarse):
    if kind_coarse == smoothers.RELAX_DIRECT:
        return _padded_pinv(mesh, Ah, A_sh, dtype)
    # relaxation-based coarse solve: a (1,1) placeholder keeps the cycle
    # state pytree shape stable
    return replicated(mesh, np.zeros((1, 1), dtype))


def _relax_twin(A_sh: ShardedMatrix, cfg) -> ShardedMatrix | None:
    """bfloat16 smoother twin (``smoother_dtype: bfloat16``): halves the
    smoother matvecs' memory reads.  Only for DIA and ELL layouts: the
    tile layouts (BDIA/BELL) keep the solve dtype."""
    if getattr(cfg, "smoother_dtype", "match") != "bfloat16":
        return None
    if A_sh.uses_bdia or A_sh.uses_bell:
        return None
    return A_sh.astype(jnp.bfloat16)


def _make_level_device(mesh, A_sh, res, kind_down, kind_up, cfg) -> Level:
    """Level-0 construction from the device setup results (no host CSR)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P(A_sh.axis))
    put = lambda a: jax.device_put(a, sharding)
    kinds = (kind_down, kind_up)
    dinv_l1 = (put(res["dinv_l1"])
               if smoothers.RELAX_L1_JACOBI in kinds else None)
    cheby_bounds = None
    if smoothers.RELAX_CHEBYSHEV in kinds:
        lam = device_setup.power_lambda(A_sh, put(res["dinv"]))
        cheby_bounds = (cfg.cheby_fraction * lam, 1.1 * lam)
    cmask = None
    if cfg.relax_order == 1:
        cmask = put(res["Cmask"].astype(A_sh.dtype))
    return Level(A=A_sh, P=res["P"], R=res["R"], dinv_l1=dinv_l1,
                 dinv=put(res["dinv"]), cmask=cmask,
                 A_relax=_relax_twin(A_sh, cfg),
                 cheby_bounds=cheby_bounds, n=A_sh.shape[0], nnz=A_sh.nnz)


def _make_level(mesh, A_sh, Ah, dtype, kind_down, kind_up, cfg,
                kind_coarse=None) -> Level:
    ro = np.asarray(A_sh.row_offsets)
    kinds = (kind_down, kind_up, kind_coarse)
    need_l1 = smoothers.RELAX_L1_JACOBI in kinds
    need_cheby = smoothers.RELAX_CHEBYSHEV in kinds
    dinv_l1 = None
    cheby_bounds = None
    d = Ah.diagonal()
    d = np.where(d != 0, d, 1.0)
    dinv_host = 1.0 / d
    from tpusolve.matrix.vectors import to_device_vector
    dinv = to_device_vector(mesh, dinv_host, ro, A_sh.row_pad, dtype=dtype)
    if need_l1:
        l1 = smoothers.l1_row_norms(Ah)
        dinv_l1 = to_device_vector(mesh, 1.0 / l1, ro, A_sh.row_pad,
                                   dtype=dtype)
    if need_cheby:
        lam = smoothers.chebyshev_bounds(Ah, dinv_host)
        cheby_bounds = (cfg.cheby_fraction * lam, 1.1 * lam)
    return Level(A=A_sh, P=None, R=None, dinv_l1=dinv_l1, dinv=dinv,
                 A_relax=_relax_twin(A_sh, cfg),
                 cheby_bounds=cheby_bounds, n=Ah.shape[0], nnz=Ah.nnz)


def _padded_pinv(mesh, Ah, A_sh, dtype) -> jax.Array:
    """Dense pseudo-inverse of the coarsest operator, laid out in the padded
    sharded vector space on both axes, replicated on the mesh."""
    ro = np.asarray(A_sh.row_offsets)
    pad = A_sh.row_pad
    inv = np.linalg.pinv(Ah.toarray(), rcond=1e-12)
    # scatter into padded layout: rows then cols
    tmp = pad_vector(inv, ro, pad)                       # (Npad, n)
    full = pad_vector(np.ascontiguousarray(tmp.T), ro, pad)  # (Npad, Npad)
    return replicated(mesh, full.T.astype(dtype))


def _build_cycle(pre: AMGPreconditioner, kind_down, kind_up,
                 cfg: BoomerAMGConfig,
                 kind_coarse=smoothers.RELAX_DIRECT, coarse_sweeps=None):
    """Build cycle_fn(state, r) with state = (levels_tuple, coarse_inv)
    passed at call time (hierarchy as runtime buffers)."""
    L = len(pre.levels)
    if coarse_sweeps is None:
        coarse_sweeps = (cfg.num_coarse_sweeps
                         if cfg.num_coarse_sweeps is not None
                         else cfg.num_sweeps)
    nu_down = cfg.num_down_sweeps if cfg.num_down_sweeps is not None else cfg.num_sweeps
    nu_up = cfg.num_up_sweeps if cfg.num_up_sweeps is not None else cfg.num_sweeps
    gamma = 2 if cfg.cycle_type == 2 else 1
    weight = 1.0

    cf_order = cfg.relax_order == 1

    def smooth(lev: Level, b, x, kind, ns):
        if ns <= 0:
            return x
        # reduced-precision smoother twin (smoother_dtype: bfloat16):
        # relaxation matvecs read half the HBM bytes; x/accumulation stay
        # in the solve dtype via jnp promotion
        A_s = lev.A_relax if lev.A_relax is not None else lev.A
        if lev.ilu_L is not None:
            # complex (ILU) smoother replaces relaxation on this level
            from jax import lax
            from tpusolve.ilu.ilu import ilu_apply

            def body(_, x):
                r = b - spmv(lev.A, x)
                return x + ilu_apply(lev.ilu_L, lev.ilu_U, lev.ilu_dinv,
                                     r, 5, 5)
            return lax.fori_loop(0, cfg.smooth_num_sweeps, body, x)
        use_cf = cf_order and lev.cmask is not None
        if kind == smoothers.RELAX_L1_JACOBI:
            if use_cf:
                return smoothers.cf_jacobi_sweeps(A_s, lev.dinv_l1,
                                                  lev.cmask, b, x, ns, 1.0)
            return smoothers.jacobi_sweeps(A_s, lev.dinv_l1, b, x, ns, 1.0)
        if kind == smoothers.RELAX_JACOBI:
            if use_cf:
                return smoothers.cf_jacobi_sweeps(A_s, lev.dinv, lev.cmask,
                                                  b, x, ns, weight)
            return smoothers.jacobi_sweeps(A_s, lev.dinv, b, x, ns, weight)
        if kind == smoothers.RELAX_CHEBYSHEV:
            for _ in range(ns):
                if cfg.cheby_variant == 4:
                    # fourth-kind (Lottes 2022): only the upper bound
                    x = smoothers.chebyshev4_sweeps(A_s, lev.dinv, b, x,
                                                    lev.cheby_bounds[1],
                                                    cfg.cheby_order)
                else:
                    x = smoothers.chebyshev_sweeps(A_s, lev.dinv, b, x,
                                                   lev.cheby_bounds,
                                                   cfg.cheby_order)
            return x
        raise ValueError(kind)

    def cycle_fn(state, r):
        levels, coarse_inv = state

        def cycle(l: int, b, x):
            lev = levels[l]
            if l == L - 1:
                if kind_coarse != smoothers.RELAX_DIRECT:
                    # coarse-level relaxation (relax_coarse /
                    # num_coarse_sweeps, ref: src/HypreSystem.cpp:129-151)
                    return smooth(lev, b, x, kind_coarse, coarse_sweeps)
                rr = b - spmv(lev.A, x)
                return x + jnp.dot(coarse_inv, rr,
                                   precision=jax.lax.Precision.HIGHEST)
            x = smooth(lev, b, x, kind_down, nu_down)
            rr = b - spmv(lev.A, x)
            rc = lev.restrict(rr) if lev.R is None else spmv(lev.R, rr)
            ec = jnp.zeros(levels[l + 1].A.padded_nrows, b.dtype)
            for _ in range(gamma):
                ec = cycle(l + 1, rc, ec)
            x = x + (lev.prolong(ec) if lev.P is None else spmv(lev.P, ec))
            x = smooth(lev, b, x, kind_up, nu_up)
            return x

        return cycle(0, r, jnp.zeros_like(r))

    return cycle_fn
