"""LinearSystem — the run-orchestration layer.

JAX analog of ``nalu::HypreSystem`` (ref: src/HypreSystem.h:66-298)
with the same 8-method lifecycle, called in the reference's order
(src/main.cpp:172-192)::

    sys = LinearSystem(mesh, config)
    sys.setup_precon_and_solver()
    sys.load()
    sys.solve()
    sys.check_solution()
    sys.output_linear_system()
    sys.summarize_timers()
    sys.destroy_system()

Timer names match the reference's exactly (SURVEY.md section 5) so CSV
profiles are directly comparable.
"""

from __future__ import annotations

import os

import numpy as np
import jax
import jax.numpy as jnp

from tpusolve.config import AppConfig
from tpusolve.formats import mmio, ij
from tpusolve.matrix.sharded import ShardedMatrix
from tpusolve.matrix.vectors import to_device_vector, from_device_vector
from tpusolve.mesh import row_decomposition, local_range
from tpusolve import timers as timers_mod
from tpusolve.timers import Timers
from tpusolve.harness.check import check_solution  # noqa: F401 (re-export)
from tpusolve.krylov import (
    pcg_setup, gmres_setup, cogmres_setup, fgmres_setup, bicgstab_setup)
from tpusolve.amg import boomeramg_setup
from tpusolve.ilu import ilu_setup
from tpusolve.stencil import laplace27

import scipy.sparse as sp


class LinearSystem:
    def __init__(self, mesh, config: AppConfig, verbose: bool = True,
                 reuse_cache: dict | None = None):
        self.mesh = mesh
        self.config = config
        self.verbose = verbose
        self.timers = Timers()
        self._compile_s0 = timers_mod.compile_seconds()
        # reuse_preconditioner: the CLI passes one dict across the
        # num_tests loop; the built solver/preconditioner are stashed there
        # and later tests skip the setup phase (same system each test)
        self._reuse_cache = reuse_cache

        ls = config.linear_system
        self.num_components = ls.num_components
        self.segregated = ls.segregated_solve
        self.num_solves = ls.num_components if self.segregated else 1
        self.rtol = ls.rtol
        self.atol = ls.atol
        self.check_enabled = False

        prec = config.solver.precision
        if prec not in ("double", "single", "mixed"):
            raise ValueError(f"unknown precision: {prec}")
        if prec in ("double", "mixed") and not jax.config.jax_enable_x64:
            # without x64, "f64" arrays silently demote to f32 and
            # iterative refinement stalls at the f32 floor
            raise RuntimeError(
                f"precision '{prec}' requires jax_enable_x64; "
                "set jax.config.update('jax_enable_x64', True) "
                "(the CLI does this automatically)")
        self.precision = prec
        # "mixed": f32 operators for Krylov/preconditioner + an f64 copy for
        # iterative-refinement residuals (rtol 1e-8 targets in f32 compute)
        self.dtype = np.float32 if prec == "single" else np.float64

        self.A: ShardedMatrix | None = None
        self.A_lo: ShardedMatrix | None = None   # f32 twin (mixed precision)
        self.A_host: sp.csr_matrix | None = None
        self.rhs: list[jax.Array] = []
        self.sln: list[jax.Array] = []
        self.sln_ref: list[np.ndarray] = []
        self.solve_results = []
        self._precond = None
        self._method = None
        self._precond_name = None
        self._perm = None          # matrix_ordering: new index -> old

    # ------------------------------------------------------------------
    def _log(self, msg):
        if self.verbose:
            print(msg, flush=True)

    # ------------------------------------------------------------------
    def setup_precon_and_solver(self):
        """Resolve method/preconditioner names (ref:
        src/HypreSystem.cpp:49-89).  Like the reference, this only selects
        and configures — operator-dependent setup happens inside solve()."""
        s = self.config.solver
        method = s.method.lower()
        precond = (s.preconditioner or "none").lower()
        valid_methods = {"gmres", "cogmres", "fgmres", "bicg", "bicgstab",
                         "cg", "pcg", "boomeramg", "ilu"}
        if method not in valid_methods:
            raise ValueError(f"Invalid method provided: {method}")
        if precond not in {"boomeramg", "ilu", "none", "pfmg"}:
            raise ValueError(f"Invalid preconditioner provided: {precond}")
        self._method = method
        self._precond_name = precond
        self._log(f"Setting up solver: {method}; preconditioner: {precond}")

    # ------------------------------------------------------------------
    def load(self):
        """Dispatch on linear_system.type (ref: src/HypreSystem.cpp:16-47)."""
        ls = self.config.linear_system
        kind = ls.type
        if kind == "matrix_market":
            self._load_matrix_market()
        elif kind == "hypre_ij":
            self._load_hypre_ij()
        elif kind == "build_27pt_stencil":
            self._build_27pt_stencil()
        else:
            raise RuntimeError(f"Invalid linear system type option: {kind}")

    # ------------------------------------------------------------------
    def _apply_ordering(self, rows, cols, vals, n):
        """Optional global reordering A -> P A P^T (``matrix_ordering:
        rcm``): bandwidth reduction makes file-loaded unstructured systems
        eligible for the BDIA fast path (kernels/bdia.py).  Returns the
        permuted COO; ``self._perm`` maps new index -> old index and is
        applied to every vector staged afterwards."""
        ordering = self.config.solver.extra.get(
            "matrix_ordering", self.config.solver.matrix_ordering)
        if ordering in (None, "none"):
            return rows, cols, vals
        if ordering != "rcm":
            raise ValueError(f"unknown matrix_ordering: {ordering}")
        lo, hi = self._host_range(n)
        if lo != 0 or hi != n - 1:
            self._log("  note: matrix_ordering: rcm skipped (global "
                      "pattern not local to this host)")
            return rows, cols, vals
        from scipy.sparse.csgraph import reverse_cuthill_mckee
        pat = sp.csr_matrix((np.ones(len(rows), np.int8), (rows, cols)),
                            shape=(n, n))
        perm = np.asarray(reverse_cuthill_mckee(pat + pat.T,
                                                symmetric_mode=True))
        inv = np.empty(n, np.int64)
        inv[perm] = np.arange(n)
        self._perm = perm          # new -> old
        self._perm_inv = inv       # old -> new
        self._log("  note: matrix_ordering: rcm applied (bandwidth "
                  "reduction for the blocked-DIA fast path)")
        return inv[rows], inv[cols], vals

    def _assemble(self, rows, cols, vals, n):
        """COO -> sharded device matrix + host CSR (for precond setup)."""
        rows, cols, vals = self._apply_ordering(rows, cols, vals, n)
        with self.timers.span("Initialize system"):
            offsets = row_decomposition(n, self.mesh.devices.size)
            if self.verbose:
                for p in range(min(self.mesh.devices.size, 8)):
                    lo, hi = local_range(offsets, p)
                    self._log(f"  Shard {p:4d}:: iLower = {lo:9d}; "
                              f"iUpper = {hi:9d}; numRows = {hi - lo + 1}")
        with self.timers.span("Assemble system"):
            allow_dia = self.config.solver.spmv_use_dia
            allow_bell = self.config.solver.spmv_use_bell
            allow_bdia = self.config.solver.spmv_use_bdia
            self.A = ShardedMatrix.from_coo(
                self.mesh, (n, n), rows, cols, vals, dtype=self.dtype,
                row_offsets=offsets, allow_dia=allow_dia,
                allow_bell=allow_bell, allow_bdia=allow_bdia)
            if self.verbose:
                self._log(f"  Matrix layout: {self.A.layout}")
            if self.precision == "mixed":
                # f32 twin by device-side cast — not a second assembly
                self.A_lo = self.A.astype(np.float32)
            if self._needs_host_csr():
                # multi-host runs stage only each host's row block; the
                # host-side AMG/ILU setup needs the GLOBAL matrix — gather
                # the blocks first (correct), never hand a partial CSR to
                # setup (silently wrong hierarchy)
                from tpusolve.mesh import allgather_host_coo
                grows, gcols, gvals = allgather_host_coo(rows, cols, vals)
                self.A_host = sp.csr_matrix(
                    (gvals, (grows, gcols)), shape=(n, n))
                self.A_host.sum_duplicates()

    def _host_range(self, n: int) -> tuple[int, int]:
        """Inclusive row range this host must stage (all rows when single
        process)."""
        from tpusolve.mesh import host_row_range
        offsets = row_decomposition(n, self.mesh.devices.size)
        return host_row_range(self.mesh, offsets)

    def _needs_host_csr(self) -> bool:
        """Keep a host CSR only for consumers that factor on the host
        (AMG/ILU setup) or serialize the system; with preconditioner
        ``none`` the f64+f32+host triplication is pure waste."""
        return (self._precond_name in ("boomeramg", "ilu", "pfmg")
                or self._method in ("boomeramg", "ilu")
                or self.config.linear_system.write_outputs)

    def _permute_in(self, vec_np):
        """Carry a global vector into the (optionally reordered) solve
        basis; the golden check then compares like with like."""
        return vec_np[self._perm] if self._perm is not None else vec_np

    def _permute_out(self, vec_np):
        """Solution back to the original ordering (file writers)."""
        if self._perm is None:
            return vec_np
        out = np.empty_like(vec_np)
        out[self._perm] = vec_np
        return out

    def _stage_vector(self, vec_np):
        return to_device_vector(self.mesh, self._permute_in(vec_np),
                                self.A.row_offsets,
                                self.A.row_pad, dtype=self.dtype)

    # ------------------------------------------------------------------
    def _load_matrix_market(self):
        ls = self.config.linear_system
        with self.timers.span("Matrix market : determine system size"):
            info = mmio.read_info(ls.matrix_file)
            n = info.nrows * (2 if ls.complex_numbers else 1)
        self._log(f"Loading matrix market file: {ls.matrix_file} "
                  f"({n} rows)")
        with self.timers.span("Matrix market : read and build matrix"):
            rows, cols, vals, shape = mmio.read_matrix(ls.matrix_file)
            if ls.complex_numbers:
                rows, cols, vals, shape = mmio.expand_complex_to_real(
                    rows, cols, vals, shape)
            elif np.iscomplexobj(vals):
                raise RuntimeError(
                    "complex matrix file requires complex_numbers: true")
            # per-host sharded staging: keep only rows this host's devices
            # own (the reference's per-rank overlap filter,
            # src/HypreSystem.cpp:1751-1835 keeps [iLower_, iUpper_])
            lo, hi = self._host_range(n)
            keep = (rows >= lo) & (rows <= hi)
            if not keep.all():
                rows, cols, vals = rows[keep], cols[keep], vals[keep]
        self._assemble(rows, cols, np.real(vals), n)
        with self.timers.span("Matrix market : read and build vector"):
            for rf in ls.rhs_files:
                v = mmio.read_vector(rf)
                if ls.complex_numbers:
                    v = mmio.expand_complex_vector(v)
                self.rhs.append(self._stage_vector(np.real(v)))
            for sf in ls.sln_files:
                v = mmio.read_vector(sf)
                if ls.complex_numbers:
                    v = mmio.expand_complex_vector(v)
                self.sln_ref.append(self._permute_in(np.real(v)))
        self.check_enabled = bool(self.sln_ref) and \
            len(self.sln_ref) == len(self.rhs)

    # ------------------------------------------------------------------
    def _load_hypre_ij(self):
        ls = self.config.linear_system
        nfiles = ls.num_partitions or 1
        with self.timers.span("IJ : determine system size"):
            n = ij.num_global_rows(ls.matrix_file, nfiles)
        self._log(f"Loading HYPRE IJ files: {ls.matrix_file} x{nfiles} "
                  f"({n} rows)")
        with self.timers.span("IJ : read and build matrix"):
            # sharded read: each host parses only files overlapping its
            # devices' row blocks (ref strided/overlap reads,
            # src/HypreSystem.cpp:1147, 1203-1236)
            rr = self._host_range(n)
            rows, cols, vals = ij.read_matrix(ls.matrix_file, nfiles,
                                              row_range=rr)
        self._assemble(rows, cols, vals, n)
        with self.timers.span("IJ : read and build vector"):
            for rf in ls.rhs_files:
                self.rhs.append(self._stage_vector(
                    ij.read_dense_vector(rf, nfiles, n, row_range=rr)))
            for sf in ls.sln_files:
                self.sln_ref.append(self._permute_in(
                    ij.read_dense_vector(sf, nfiles, n, row_range=rr)))
        self.check_enabled = bool(self.sln_ref) and \
            len(self.sln_ref) == len(self.rhs)

    # ------------------------------------------------------------------
    def _build_27pt_stencil(self):
        ls = self.config.linear_system
        with self.timers.span("Build 27Pt Stencil HYPRE matrix"):
            pfmg = self._precond_name == "pfmg"
            # device AMG setup (single-chip or sharded) takes level 0 on
            # device and never needs the fine host CSR — skip the (at 256^3:
            # GB-scale, minutes of page faults) with_host build
            from tpusolve.amg import device_setup as _ds
            amg = (self._precond_name == "boomeramg"
                   or self._method == "boomeramg")
            n_glob = ls.nx * ls.ny * ls.nz * self.mesh.devices.size
            min_n = int(os.environ.get("TPUSOLVE_DEVICE_SETUP_MIN_N",
                                       _ds.MIN_DEVICE_N))
            dev_amg = (amg and min(ls.nx, ls.ny) >= 3 and n_glob >= min_n
                       and not ls.write_outputs
                       and self.config.solver.matrix_ordering == "none"
                       and _ds.config_eligible(self.config.boomeramg))
            if pfmg and min(ls.nx, ls.ny) >= 3:
                # structured payload reuses the generator's arrays and the
                # matrix-free setup never needs a host CSR
                A, b, x_ref, hp = laplace27(
                    self.mesh, ls.nx, ls.ny, ls.nz, dtype=self.dtype,
                    with_parts=True)
                self._host_parts = hp
                self.A_host = None
            elif dev_amg and self.mesh.devices.size > 1:
                A, b, x_ref, lat = laplace27(
                    self.mesh, ls.nx, ls.ny, ls.nz, dtype=self.dtype,
                    with_lattice=True)
                self._lattice = lat
                self.A_host = None
                self._host_parts = None
            elif dev_amg:
                A, b, x_ref = laplace27(self.mesh, ls.nx, ls.ny, ls.nz,
                                        dtype=self.dtype)
                self.A_host = None
                self._host_parts = None
            elif self._needs_host_csr():
                A, b, x_ref, A_host = laplace27(
                    self.mesh, ls.nx, ls.ny, ls.nz, dtype=self.dtype,
                    with_host=True)
                self.A_host = A_host
                self._host_parts = None
            else:
                A, b, x_ref = laplace27(self.mesh, ls.nx, ls.ny, ls.nz,
                                        dtype=self.dtype)
                self.A_host = None
                self._host_parts = None
            self.A = A
            if self.precision == "mixed":
                self.A_lo = A.astype(np.float32)
            self.rhs = [b]
            self.sln_ref = [np.ones(A.shape[0])]
        n = A.shape[0]
        self._log(f"Built 27-pt stencil system: {ls.nx}x{ls.ny}x{ls.nz} "
                  f"per device, {n} global rows")
        self.check_enabled = True
        self.num_solves = 1

    # ------------------------------------------------------------------
    @property
    def _A_solve(self):
        """Operator the Krylov/preconditioner machinery runs on."""
        return self.A_lo if self.precision == "mixed" else self.A

    def _build_preconditioner(self):
        name = self._precond_name
        if name == "none":
            return None, None
        if name in ("boomeramg", "pfmg"):
            from tpusolve.amg.structured import (
                structured_mg_setup, structured_possible)
            if name == "pfmg":
                if not structured_possible(self._A_solve):
                    raise ValueError(
                        "pfmg requires a structured (box-generated) operator")
                hp = getattr(self, "_host_parts", None)
                if hp is not None:
                    from tpusolve.amg.structured import structured_mg_setup_fast
                    pre = structured_mg_setup_fast(
                        self._A_solve, self.config.boomeramg, host_parts=hp)
                else:
                    pre = structured_mg_setup(self._A_solve,
                                              self.config.boomeramg,
                                              A_host=self.A_host)
            else:
                pre = boomeramg_setup(self._A_solve, self.config.boomeramg,
                                      A_host=self.A_host,
                                      lattice_parts=getattr(
                                          self, "_lattice", None))
            if self.verbose:
                self._log(pre.describe())
            return pre, pre
        if name == "ilu":
            pre = ilu_setup(self._A_solve, self.config.ilu,
                            A_host=self.A_host)
            for note in pre.notes:
                self._log(f"  note: {note}")
            return pre, pre
        raise ValueError(name)

    def _build_solver(self, M):
        s = self.config.solver
        mixed = self.precision == "mixed"
        # mixed precision: the inner f32 solve only needs to reach the f32
        # floor; the IR outer loop carries it to s.tolerance
        inner_tol = float(s.extra.get("inner_tolerance", 1e-5))
        kw = dict(tol=inner_tol if mixed else s.tolerance,
                  maxiter=s.max_iterations)
        A = self._A_solve
        method = self._method
        if method in ("cg", "pcg"):
            inner = pcg_setup(A, M, **kw)
        elif method == "gmres":
            inner = gmres_setup(A, M, restart=s.kspace, **kw)
        elif method == "cogmres":
            inner = cogmres_setup(A, M, restart=s.kspace, cgs=s.cgs, **kw)
        elif method == "fgmres":
            inner = fgmres_setup(A, M, restart=s.kspace, **kw)
        elif method in ("bicg", "bicgstab"):
            inner = bicgstab_setup(A, M, **kw)
        else:
            inner = None
        if inner is not None:
            if mixed:
                from tpusolve.krylov.refine import refined_solve_setup
                return refined_solve_setup(
                    self.A, inner, tol=s.tolerance,
                    max_refine=int(s.extra.get("max_refine", 6)))
            return inner
        # stationary methods follow the same precision policy as the
        # Krylov paths: build on _A_solve (f32 under single/mixed), wrap
        # mixed in f64 iterative refinement
        inner_stat_tol = inner_tol if mixed else s.tolerance
        if method == "boomeramg":
            # AMG as the solver (ref: setup_boomeramg_solver,
            # src/HypreSystem.cpp:91-117) — reuse AMG's own tolerance keys
            pre = self._amg_solver_pre = boomeramg_setup(
                A, self.config.boomeramg, A_host=self.A_host,
                lattice_parts=getattr(self, "_lattice", None))
            inner = lambda b, x0=None: pre.solve(
                b, x0, tol=inner_stat_tol, maxiter=s.max_iterations)
        elif method == "ilu":
            # ILU as the solver (ref: setup_ilu, src/HypreSystem.cpp:457-497):
            # stationary iteration x += M(b - A x)
            from tpusolve.krylov.stationary import stationary_solve_setup
            pre = ilu_setup(A, self.config.ilu, A_host=self.A_host)
            inner = stationary_solve_setup(A, pre.apply, tol=inner_stat_tol,
                                           maxiter=s.max_iterations)
        else:
            raise ValueError(method)
        if mixed:
            from tpusolve.krylov.refine import refined_solve_setup
            return refined_solve_setup(
                self.A, inner, tol=s.tolerance,
                max_refine=int(s.extra.get("max_refine", 6)))
        return inner

    # ------------------------------------------------------------------
    def solve(self):
        """Preconditioner setup + solve per component
        (ref: src/HypreSystem.cpp:673-737)."""
        with self.timers.span("Preconditioner setup") as fence:
            cache = self._reuse_cache
            if cache is not None and "solver" in cache:
                self._log("Reusing preconditioner/solver from previous test")
                solver = cache["solver"]
                self._precond = cache.get("precond")
            else:
                self._precond, M = (None, None)
                if self._method not in ("boomeramg", "ilu"):
                    self._precond, M = self._build_preconditioner()
                solver = self._build_solver(M)
                if cache is not None:
                    cache["solver"] = solver
                    cache["precond"] = self._precond

        if self.config.linear_system.write_amg_matrices and \
                self._precond is not None and hasattr(self._precond, "levels"):
            with self.timers.span("Write AMG Matrices"):
                self._write_amg_matrices()

        with self.timers.span("Solve") as fence:
            self.solve_results = []
            self.sln = []
            if self.segregated or len(self.rhs) <= 1:
                for i in range(len(self.rhs)):
                    res = solver(self.rhs[i])
                    self.solve_results.append(res)
                    self.sln.append(res.x)
            else:
                # coupled multi-component solve: batch the RHS dimension
                # (reference multivector path, src/HypreSystem.h:261-263)
                batched = jax.vmap(lambda b: solver(b))
                res = batched(jnp.stack(self.rhs))
                for i in range(len(self.rhs)):
                    self.solve_results.append(jax.tree.map(
                        lambda a: a[i], res))
                    self.sln.append(res.x[i])
            fence(*self.sln)

        for i, res in enumerate(self.solve_results):
            self._log(f"Solve {i}: iters={int(res.iters)} "
                      f"relres={float(res.relres):.3e} "
                      f"converged={bool(res.converged)}")
            # per-iteration residual transparency (HYPRE print_level 4,
            # ref: etc/hypre_app.yaml:20)
            if self.config.solver.print_level >= 4 and res.history is not None:
                h = np.asarray(res.history)
                h = h[h >= 0]
                for k, rn in enumerate(h):
                    self._log(f"    iter {k:4d}  ||r|| = {rn:.6e}")

    # ------------------------------------------------------------------
    def check_solution(self):
        """Golden check (ref: src/HypreSystem.cpp:771-845)."""
        if not self.check_enabled:
            self._log("Solution check skipped (no reference solution)")
            return True
        with self.timers.span("Check solution"):
            all_pass = True
            for i, x_dev in enumerate(self.sln):
                x = from_device_vector(x_dev, self.A.row_offsets,
                                       self.A.row_pad)
                passed, nbad = check_solution(
                    x, self.sln_ref[i], self.rtol, self.atol,
                    verbose=self.verbose)
                all_pass &= passed
        return all_pass

    # ------------------------------------------------------------------
    def output_linear_system(self):
        """Write matrix/rhs/sln as IJ files
        (ref: src/HypreSystem.cpp:739-769)."""
        ls = self.config.linear_system
        if not (ls.write_outputs or ls.write_solution):
            return
        with self.timers.span("Output system"):
            offsets = np.asarray(self.A.row_offsets)
            nparts = self.A.nparts
            if ls.write_outputs:
                Ah = self.A_host if self.A_host is not None else \
                    self.A.to_scipy()
                Ac = Ah.tocoo()
                # under matrix_ordering the in-memory system lives in the
                # permuted basis; files are written in the ORIGINAL index
                # space so the (A, b, x) triple stays consistent (A@x = b)
                # and matches the reference's numbering
                arow, acol = Ac.row, Ac.col
                if self._perm is not None:
                    arow, acol = self._perm[arow], self._perm[acol]
                ij.write_matrix(ls.output_matrix_name, arow, acol,
                                Ac.data, offsets, ncols=self.A.shape[1])
                for i, b in enumerate(self.rhs):
                    ij.write_vector(f"IJV{i}.rhs",
                                    self._permute_out(
                                        from_device_vector(
                                            b, self.A.row_offsets,
                                            self.A.row_pad)),
                                    offsets)
            for i, x in enumerate(self.sln):
                ij.write_vector(f"IJV{i}.sln",
                                self._permute_out(
                                    from_device_vector(x,
                                                       self.A.row_offsets,
                                                       self.A.row_pad)),
                                offsets)

    def _write_amg_matrices(self):
        """Per-level operator dump (ref: src/HypreSystem.cpp:700-714),
        re-loadable by the hypre_ij reader."""
        offsets_of = lambda M: np.asarray(M.row_offsets)
        for lvl, level in enumerate(self._precond.levels):
            Mh = level.A.to_scipy().tocoo()
            ij.write_matrix(f"IJM.mat_level_{lvl}", Mh.row, Mh.col, Mh.data,
                            offsets_of(level.A), ncols=level.A.shape[1])

    # ------------------------------------------------------------------
    def _finalize_compile_timer(self):
        """Append the lifecycle's XLA compile total as a named timer row
        (once).  The reference's table accounts for ~all of main()'s wall
        time (src/main.cpp:187-216); with this row timers_total ~= wall on
        cold runs too, instead of silently hiding the compile phase."""
        if getattr(self, "_compile_timer_done", False):
            return
        self._compile_timer_done = True
        c = timers_mod.compile_seconds() - self._compile_s0
        if c > 0.0:
            self.timers.add("Compile (XLA trace+lower+build)", c)

    def summarize_timers(self):
        self._finalize_compile_timer()
        self._log(self.timers.summarize())

    def retrieve_timers(self, profile):
        self._finalize_compile_timer()
        profile.append(self.timers)

    def destroy_system(self):
        self.A = None
        self.A_host = None
        self.rhs = []
        self.sln = []
        self._precond = None
