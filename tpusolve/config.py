"""YAML configuration schema.

Same file layout and key names as the reference driver
(ref: etc/hypre_app.yaml:1-42; parsed throughout src/HypreSystem.cpp with the
``get_optional`` helper at src/HypreSystem.h:57-64).  Four sections:

* ``linear_system``     — problem source and checking options
* ``solver_settings``   — Krylov method, preconditioner, tolerances
* ``boomeramg_settings``— AMG knobs (ref: src/HypreSystem.cpp:119-326)
* ``ilu_preconditioner_settings`` — ILU knobs (ref: src/HypreSystem.cpp:328-370)

Values are parsed into typed dataclasses; unknown keys are preserved in
``extra`` so configs written for the reference load without error.
"""

from __future__ import annotations

from dataclasses import dataclass, field
import yaml


def get_optional(node: dict | None, key: str, default):
    """Reference semantics (src/HypreSystem.h:57-64): value if present,
    else default."""
    if node is None:
        return default
    val = node.get(key, default)
    if val is None:
        return default
    if default is not None and not isinstance(default, bool) and isinstance(val, bool):
        return val
    if isinstance(default, bool):
        return bool(val)
    if isinstance(default, int) and not isinstance(default, bool) and not isinstance(val, float):
        return int(val)
    if isinstance(default, float):
        return float(val)
    return val


@dataclass
class LinearSystemConfig:
    # ref keys: src/HypreSystem.cpp:22-41 (type dispatch), :1613-1665 (MM),
    # :1021-1082 (IJ), :1476-1494 (stencil)
    type: str = "matrix_market"   # matrix_market | hypre_ij | build_27pt_stencil
    matrix_file: str | None = None
    rhs_file: str | None = None
    sln_file: str | None = None
    rhs_files: list[str] = field(default_factory=list)   # rhs_file0..N
    sln_files: list[str] = field(default_factory=list)
    num_partitions: int | None = None    # IJ file count (may differ from ndevices)
    num_components: int = 1
    segregated_solve: bool = True
    complex_numbers: bool = False
    rtol: float = 1.0e-6                 # golden-check tolerances
    atol: float = 1.0e-8                 # (ref defaults src/HypreSystem.h:296-297)
    nx: int = 128                        # stencil box per device
    ny: int = 128                        # (ref defaults src/HypreSystem.cpp:1487-1489)
    nz: int = 128
    write_outputs: bool = False
    write_solution: bool = False
    write_amg_matrices: bool = False
    output_matrix_name: str = "IJM.mat"
    extra: dict = field(default_factory=dict)


@dataclass
class SolverConfig:
    # ref: src/HypreSystem.cpp:49-89 + per-method setup fns :372-497
    method: str = "gmres"        # gmres|cogmres|fgmres|bicg|cg|boomeramg|ilu
    preconditioner: str = "boomeramg"   # boomeramg|ilu|none
    tolerance: float = 1.0e-5    # ref default src/HypreSystem.cpp:393
    max_iterations: int = 1000
    kspace: int = 10             # GMRES restart (ref :396)
    cgs: int = 1                 # COGMRES: 1- vs 2-step classical GS (ref :377)
    print_level: int = 1
    num_tests: int = 1
    csv_profile_file: str | None = None
    # kernel-implementation selection, the analog of the reference's
    # vendor-kernel toggles (ref: src/main.cpp:127-156): allow the DIA
    # fast layout at assembly, and the block-ELL (BELL) unstructured fast
    # path (else padded-ELL gather everywhere)
    spmv_use_dia: bool = True
    spmv_use_bell: bool = True
    spmv_use_bdia: bool = True
    # global system reordering at assembly: "rcm" permutes A -> P A P^T
    # (reverse Cuthill-McKee) so file-loaded unstructured systems become
    # banded and eligible for the BDIA fast path; rhs/solution vectors are
    # permuted consistently (golden check unaffected)
    matrix_ordering: str = "none"
    # keep the preconditioner/solver across the num_tests loop (key present
    # in the reference's yaml surface, etc/hypre_app.yaml:21)
    reuse_preconditioner: bool = False
    # precision policy: "double" matches the reference's f64; "single" runs
    # f32 with compensated reductions; "mixed" is f32 inner solves under
    # f64 iterative refinement
    precision: str = "double"
    extra: dict = field(default_factory=dict)


@dataclass
class BoomerAMGConfig:
    # Full key surface of setup_boomeramg_precond (ref: src/HypreSystem.cpp:119-326).
    # Type-code semantics follow HYPRE; sequential codes are mapped to the
    # nearest parallel-friendly algorithm and reported (see amg/builder.py).
    print_level: int = 1
    max_iterations: int = 1
    tolerance: float = 0.0
    coarsen_type: int = 8          # ref default 8=PMIS (:126); yaml example 6=Falgout
    cycle_type: int = 1            # 1=V, 2=W
    relax_type: int = 6            # GS-family codes → l1-Jacobi/Chebyshev
    relax_order: int = 0           # 1 = CF ordering
    relax_down: int | None = None  # per-phase relax types (ref :129-151)
    relax_up: int | None = None
    relax_coarse: int | None = None
    num_sweeps: int = 1
    num_down_sweeps: int | None = None
    num_up_sweeps: int | None = None
    num_coarse_sweeps: int | None = None
    strong_threshold: float = 0.57  # ref default (:158-159)
    max_levels: int = 20
    min_coarse_size: int | None = None
    max_coarse_size: int = 64
    interp_type: int = 0            # 0=classical; 3=direct; 6=extended+i
    trunc_factor: float = 0.0
    p_max_elmts: int = 0
    agg_num_levels: int = 0
    agg_interp_type: int = 4
    rap2: int = 0
    keep_transpose: int = 0
    non_galerkin_tol: float = 0.0
    nongalerk_tol: list[float] = field(default_factory=list)
    variant: int | None = None
    smooth_type: int | None = None
    smooth_num_sweeps: int = 1
    smooth_num_levels: int = 0
    # extension (no reference analog): value dtype for the SMOOTHER
    # matvecs only — "bfloat16" halves smoother memory traffic inside the
    # V-cycle (residual/transfer matvecs keep the solve dtype; the cycle
    # is a preconditioner, so reduced smoother precision costs at most a
    # few Krylov iterations, never correctness)
    smoother_dtype: str = "match"   # match | bfloat16
    # Chebyshev smoother options (parallel relax path)
    cheby_order: int = 2
    cheby_fraction: float = 0.3
    cheby_variant: int = 0     # 0 = classical third-kind; 4 = fourth-kind
                               # (Lottes 2022 — needs only the upper bound)
    extra: dict = field(default_factory=dict)


@dataclass
class ILUConfig:
    # ref: src/HypreSystem.cpp:328-370 (precond) and :457-497 (solver)
    ilu_type: int = 0              # 0=ILU(k) local
    ilu_fill_level: int = 0
    ilu_drop_threshold: float = 1.0e-2
    ilu_max_nnz_per_row: int = 100
    ilu_max_iterations: int = 1
    ilu_tolerance: float = 0.0
    ilu_local_reordering: int = 0
    ilu_print_level: int = 0
    ilu_tri_solve: int = 0         # 0 = Jacobi-iteration trisolve (device path, ref :363)
    ilu_lower_jacobi_iters: int = 5
    ilu_upper_jacobi_iters: int = 5
    ilu_iterative_setup_type: int = 0
    ilu_iterative_setup_option: int = 0
    ilu_iterative_setup_max_iter: int = 1
    ilu_iterative_setup_tolerance: float = 0.0
    extra: dict = field(default_factory=dict)


@dataclass
class AppConfig:
    linear_system: LinearSystemConfig
    solver: SolverConfig
    boomeramg: BoomerAMGConfig
    ilu: ILUConfig
    raw: dict = field(default_factory=dict)


def _fill(dc_cls, node: dict | None, alias: dict[str, str] | None = None):
    node = dict(node or {})
    alias = alias or {}
    for src, dst in alias.items():
        if src in node:
            node[dst] = node.pop(src)
    known = {f for f in dc_cls.__dataclass_fields__ if f != "extra"}
    kwargs = {k: v for k, v in node.items() if k in known}
    extra = {k: v for k, v in node.items() if k not in known}
    obj = dc_cls(**kwargs)
    if hasattr(obj, "extra"):
        obj.extra = extra
    return obj


def parse_config(doc: dict) -> AppConfig:
    linsys_node = doc.get("linear_system", {}) or {}
    solver_node = doc.get("solver_settings", {}) or {}

    linsys = _fill(LinearSystemConfig, linsys_node)
    # multi-component rhs_file0..N / sln_file0..N (ref: src/HypreSystem.cpp:1636-1645)
    ncomp = linsys.num_components
    if ncomp > 1:
        missing = [f"rhs_file{i}" for i in range(ncomp)
                   if linsys_node.get(f"rhs_file{i}") is None]
        if missing:
            raise ValueError(
                f"num_components={ncomp} requires rhs_file0..rhs_file{ncomp-1}"
                f"; missing: {', '.join(missing)}")
        linsys.rhs_files = [linsys_node.get(f"rhs_file{i}") for i in range(ncomp)]
        slns = [linsys_node.get(f"sln_file{i}") for i in range(ncomp)]
        if all(s is not None for s in slns):
            linsys.sln_files = slns
    else:
        if linsys.rhs_file:
            linsys.rhs_files = [linsys.rhs_file]
        if linsys.sln_file:
            linsys.sln_files = [linsys.sln_file]

    solver = _fill(SolverConfig, solver_node)
    # ILU-as-solver keys live in solver_settings (ref: src/HypreSystem.cpp:459-486)
    ilu_node = dict(doc.get("ilu_preconditioner_settings", {}) or {})
    for k in list(solver.extra):
        if k.startswith("ilu_"):
            ilu_node.setdefault(k, solver.extra[k])
    ilu = _fill(ILUConfig, ilu_node)
    amg = _fill(BoomerAMGConfig, doc.get("boomeramg_settings", {}))
    return AppConfig(linear_system=linsys, solver=solver, boomeramg=amg,
                     ilu=ilu, raw=doc)


def load_config(path: str) -> AppConfig:
    with open(path) as fh:
        doc = yaml.safe_load(fh) or {}
    return parse_config(doc)
