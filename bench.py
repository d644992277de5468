"""Benchmark: SpMV effective bandwidth on the 27-pt weak-scaling fixture.

Prints ONE JSON line:
    {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}

The north-star SpMV target is >= 80% of the device's peak memory bandwidth
(BASELINE.md); ``vs_baseline`` therefore reports achieved_bandwidth /
(0.8 * peak) for the detected device, so >= 1.0 means the target is met.
The benchmark needs a GPU listed in ``PEAK_HBM_GBPS``: on any other device
it prints nothing on stdout and exits non-zero.

Effective bytes per SpMV use the standard sparse accounting: values + column
indices + input vector + output vector, over the *padded* arrays the kernel
actually reads (padding rides along in the ELL layout).

``python bench.py --full`` additionally runs the gate-level cases, each in
a child process while this process stays off the device, and writes them to
BENCH_FULL.json.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Peak memory bandwidth by ``device_kind`` (GB/s).  Source: NVIDIA H100
# Tensor Core GPU data sheet, SXM form factor: 3.35 TB/s HBM3.
PEAK_HBM_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def peak_hbm_gbps(kind: str) -> float:
    """Peak bandwidth of a device kind; an unlisted device is an error."""
    if kind not in PEAK_HBM_GBPS:
        raise ValueError(f"no peak bandwidth on record for device kind "
                         f"{kind!r}; bench.py measures listed GPUs only")
    return PEAK_HBM_GBPS[kind]


def _device_peak() -> float:
    import jax
    return peak_hbm_gbps(jax.devices()[0].device_kind)


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _bench_chain(A, x, spmv, n_it=128):
    """Warm per-SpMV seconds via overhead-calibrated chain timing."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def chain(A, x):
        def body(_, x):
            return spmv(A, x) * jnp.float32(1.0 / 52.0)
        return jnp.sum(jnp.abs(lax.fori_loop(0, n_it, body, x)))

    @jax.jit
    def trivial(x):
        return jnp.sum(x)

    float(trivial(x))
    float(chain(A, x))
    best = ovh = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        float(trivial(x))
        ovh = min(ovh, time.perf_counter() - t0)
        t0 = time.perf_counter()
        float(chain(A, x))
        best = min(best, time.perf_counter() - t0)
    return max(best - ovh, 1e-9) / n_it


def _case_bdia_unstructured() -> dict:
    """Unstructured (clustered-band, DIA-ineligible) SpMV — the nalu-wind
    file-system profile (readers ref: src/HypreSystem.cpp:1021-1969)."""
    from tpusolve.mesh import make_mesh
    from tpusolve.matrix.sharded import ShardedMatrix
    from tpusolve.matrix.spmv import spmv
    from tpusolve.matrix.vectors import to_device_vector
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from gatefix import clustered_band

    sol = _device_peak()
    rng = np.random.default_rng(11)
    n = 884736            # = 96^3
    rows, cols, vals = clustered_band(n)
    A = ShardedMatrix.from_coo(make_mesh(1), (n, n), rows, cols, vals,
                               dtype=np.float32, allow_dia=False)
    x = to_device_vector(A.mesh, rng.standard_normal(n),
                         np.asarray(A.col_offsets), A.col_pad,
                         dtype=np.float32)
    t = _bench_chain(A, x, spmv, n_it=64)
    csr_bytes = rows.size * 8 + 2 * n * 4
    gbps = csr_bytes / t / 1e9
    return {"metric": f"spmv_unstructured_{A.layout}_96^3graph_f32",
            "value": round(gbps, 2), "unit": "GB/s",
            "vs_baseline": round(gbps / (0.1 * sol), 4),
            "note": "target: >=10% of peak bandwidth on unstructured"}


def _case_flagship_solve() -> dict:
    """Flagship 64^3 AMG(PFMG)-PCG solve: warm wall time + iterations."""
    import numpy as np
    import jax
    from tpusolve.mesh import make_mesh
    from tpusolve.stencil import laplace27
    from tpusolve.config import BoomerAMGConfig
    from tpusolve.amg.structured import structured_mg_setup_fast
    from tpusolve.krylov.cg import pcg_setup

    mesh = make_mesh(1)
    A, b, _, hp = laplace27(mesh, 64, 64, 64, dtype=np.float32,
                            with_parts=True)
    t0 = time.perf_counter()
    pre = structured_mg_setup_fast(A, BoomerAMGConfig(), host_parts=hp)
    setup_s = time.perf_counter() - t0
    solve = pcg_setup(A, pre.apply, tol=1e-8, maxiter=100)
    res = solve(b)
    jax.block_until_ready(res.x)          # compile + first solve
    import jax.numpy as jnp
    # timing: N solves of distinctly-scaled rhs chained inside one jit,
    # minus the cost of a trivial dispatch and fetch
    from jax import lax
    fn = solve._fn
    salt = np.float32((time.time_ns() % 997) * 1e-9)
    N = 8

    @jax.jit
    def chain(astate, mstate, b, salt):
        def body(k, acc):
            bk = b * (1.0 + salt + k.astype(b.dtype) * 1e-6)
            r = fn(astate, mstate, bk, None)
            return acc + r.relres
        return lax.fori_loop(0, N, body, jnp.asarray(0.0, b.dtype))

    astate, mstate = solve._state
    sj = jnp.asarray(salt, b.dtype)
    float(chain(astate, mstate, b, sj))          # compile
    ovh = time.perf_counter()
    float(jnp.sum(b))
    ovh = time.perf_counter() - ovh
    t0 = time.perf_counter()
    float(chain(astate, mstate, b, sj + jnp.asarray(1e-7, b.dtype)))
    solve_s = max((time.perf_counter() - t0 - ovh) / N, 0.0)
    return {"metric": "flagship_64^3_pfmg_pcg", "value": round(solve_s, 4),
            "unit": "s_warm_solve", "iters": int(res.iters),
            "relres": float(res.relres), "setup_s": round(setup_s, 2),
            "converged": bool(res.converged)}


def _case_amg_setup() -> dict:
    """Algebraic (BoomerAMG-path) setup wall time at 128^3 = 2.1M rows."""
    import numpy as np
    from tpusolve.mesh import make_mesh
    from tpusolve.stencil import laplace27
    from tpusolve.config import BoomerAMGConfig
    from tpusolve.amg.builder import boomeramg_setup

    mesh = make_mesh(1)
    A, b, _, A_host = laplace27(mesh, 128, 128, 128, dtype=np.float32,
                                with_host=True)
    t0 = time.perf_counter()
    pre = boomeramg_setup(A, BoomerAMGConfig(), A_host=A_host)
    setup_s = time.perf_counter() - t0
    return {"metric": "boomeramg_setup_128^3_host", "value": round(setup_s, 2),
            "unit": "s", "levels": pre.num_levels,
            "note": "round-1 baseline: 841 s"}


def _case_device_setup_256() -> dict:
    """Algebraic AMG setup at 256^3 = 16.8M rows — the device fine-level
    path (amg/device_setup.py; ref on-device setup src/HypreSystem.cpp:692,
    timed :731).  Target <= 60 s."""
    import jax
    from tpusolve.mesh import make_mesh
    from tpusolve.stencil import laplace27
    from tpusolve.config import BoomerAMGConfig
    from tpusolve.amg.builder import boomeramg_setup

    mesh = make_mesh(1)
    t0 = time.perf_counter()
    A, b, _ = laplace27(mesh, 256, 256, 256, dtype=np.float32)
    jax.block_until_ready(A.dia_vals)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre = boomeramg_setup(A, BoomerAMGConfig())
    setup_s = time.perf_counter() - t0
    levels = pre.num_levels
    del pre
    # steady-state rerun (same semantics as the ell_setup case: the
    # reference's BoomerAMGSetup has no compile phase, so the warm number
    # is the apples-to-apples setup cost; cold pays one-time XLA
    # trace/compile-cache lookups)
    t0 = time.perf_counter()
    pre = boomeramg_setup(A, BoomerAMGConfig())
    warm_s = time.perf_counter() - t0
    return {"metric": "boomeramg_setup_256^3_device",
            "value": round(setup_s, 2), "unit": "s",
            "vs_baseline": round(60.0 / max(setup_s, 1e-9), 4),
            "warm_s": round(warm_s, 2),
            "levels": levels, "gen_s": round(gen_s, 2),
            "note": "target <= 60 s at 16.8M rows (VERDICT r2 #2)"}


def _big_at(side: int) -> dict:
    """One attempt at the big single-device solve (runs in a child
    process; see _case_big_solve)."""
    import os
    import jax
    import jax.numpy as jnp
    from tpusolve.mesh import make_mesh
    from tpusolve.stencil import laplace27, laplace27_host_parts
    from tpusolve.config import BoomerAMGConfig
    from tpusolve.amg.structured import structured_mg_setup_fast
    from tpusolve.krylov.cg import pcg_setup

    mesh = make_mesh(1)
    t0 = time.perf_counter()
    A, b, _ = laplace27(mesh, side, side, side, dtype=np.float32)
    jax.block_until_ready(A.dia_vals)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hp = laplace27_host_parts(1, side, side, side, dtype=np.float32)
    # non-Galerkin truncation keeps coarse stacks <= 27 planes; stepped
    # PCG bounds program temps to one iteration
    ngt = float(os.environ.get("TPUSOLVE_BIG_NGT", "0.02"))
    pre = structured_mg_setup_fast(
        A, BoomerAMGConfig(non_galerkin_tol=ngt), host_parts=hp)
    setup_s = time.perf_counter() - t0
    del hp
    solve = pcg_setup(A, pre.apply, tol=1e-8, maxiter=200, fused=False)
    res = solve(b)
    float(res.relres)                     # compile + first solve
    eps = np.float32(1.0 + (time.time_ns() % 997 + 1) * 1e-6)
    b2 = jax.jit(lambda v, s: v * s)(b, jnp.asarray(eps, b.dtype))
    jax.block_until_ready(b2)
    ovh = time.perf_counter()
    float(jnp.sum(b2))
    ovh = time.perf_counter() - ovh
    t0 = time.perf_counter()              # window ends on a scalar fetch
    res = solve(b2)
    float(res.relres)
    solve_s = max(time.perf_counter() - t0 - ovh, 0.0)
    return {"metric": f"big_{side}^3_mg_pcg_{A.shape[0]/1e6:.1f}Mrow",
            "value": round(solve_s, 3), "unit": "s_warm_solve",
            "rows": int(A.shape[0]), "iters": int(res.iters),
            "relres": float(res.relres), "converged": bool(res.converged),
            "setup_s": round(setup_s, 2), "gen_s": round(gen_s, 2),
            "vs_baseline": round(A.shape[0] / (4 * 12.5e6), 3),
            "note": "rtol 1e-8; vs_baseline = rows / (4x the 12.5M-row "
                    "north-star per-device share)"}


def _case_big_solve_child() -> dict:
    import os
    side = int(os.environ["TPUSOLVE_BIG_ONESIDE"])
    try:
        return _big_at(side)
    except Exception as e:
        return {"metric": f"big_{side}^3",
                "error": f"{type(e).__name__}: {str(e)[:140]}"}


def _case_big_solve() -> dict:
    """The largest single-device solve: 27-pt, f32 — on-device generation
    + structured-MG setup (non-Galerkin truncated coarse stacks) + stepped
    PCG to rtol 1e-8 (ref weak-scaling sizing, src/HypreSystem.cpp:
    1487-1516).  Sides from ``TPUSOLVE_BIG_SIDES`` are tried in order, each
    in its own child process (a failed attempt may leave the device's
    memory fragmented); every attempt is recorded."""
    import subprocess
    attempts = {}
    sides = [int(s) for s in os.environ.get(
        "TPUSOLVE_BIG_SIDES", "384,352,320").split(",")]
    for side in sides:
        env = _child_env()
        env["TPUSOLVE_BIG_ONESIDE"] = str(side)
        try:
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--case", "big_solve_child"],
                capture_output=True, text=True, timeout=3000, env=env,
                cwd=HERE)
            r = None
            for ln in reversed(p.stdout.splitlines()):
                if ln.startswith("{"):
                    r = json.loads(ln)
                    break
            if r is not None and not r.get("error"):
                if attempts:
                    r["attempted"] = attempts
                return r
            attempts[side] = (r or {}).get(
                "error", f"rc={p.returncode}: {p.stderr[-200:]}")
        except (OSError, subprocess.SubprocessError) as e:
            attempts[side] = f"{type(e).__name__}: {str(e)[:100]}"
    return {"metric": "big_mg_pcg", "error": "no size fits",
            "attempted": attempts}


def _case_ilu_device_setup() -> dict:
    """Device ILU(0) setup at 224^3 = 11.2M rows (VERDICT r3 #5): a
    momentum-like nonsymmetric DIA operator — upwind-skewed couplings
    over a mass-dominated diagonal (the nalu-wind momentum class:
    dt-scaled mass + convection + viscous; a PURE scaled Laplacian is
    the pressure class, where ILU(0)-BiCGSTAB is not h-independent and
    stalls past ~2M rows — measured) — factors on device (Chow-Patel
    plane sweeps, ilu/device_setup.py), no global host CSR at any
    scale; then BiCGSTAB+ILU solves to rtol 1e-8 (ref device ILU
    setup+solve, src/HypreSystem.cpp:328-370)."""
    import jax
    import jax.numpy as jnp
    from tpusolve.mesh import make_mesh
    from tpusolve.stencil import laplace27
    from tpusolve.config import ILUConfig
    from tpusolve.ilu.ilu import ilu_setup
    from tpusolve.matrix.sharded import ShardedMatrix
    from tpusolve.krylov.bicgstab import bicgstab_setup

    side = 224
    mesh = make_mesh(1)
    A0, b, _ = laplace27(mesh, side, side, side, dtype=np.float32)
    offs = A0.dia_offsets
    scale = np.array([1.3 if o == 0 else (1.25 if o > 0 else 0.8)
                      for o in offs], np.float32)
    sh = (1, len(offs)) + (1,) * (A0.dia_vals.ndim - 2)
    planes = jax.jit(lambda v: v * jnp.asarray(scale).reshape(sh))(
        A0.dia_vals)
    D = len(offs)
    A = ShardedMatrix.from_dia_parts(
        mesh, A0.shape, offs, planes.reshape(1, D, -1),
        [(np.zeros(0, np.int64), np.zeros(0, np.int64),
          np.zeros(0, np.float32))],
        dtype=np.float32, dia_shape=A0.dia_shape)
    del A0
    cfg = ILUConfig()
    t0 = time.perf_counter()
    pre = ilu_setup(A, cfg)
    jax.block_until_ready(pre.udiag_inv)
    cold_s = time.perf_counter() - t0
    dev = any("on device" in s for s in pre.notes)
    t0 = time.perf_counter()
    pre = ilu_setup(A, cfg)
    jax.block_until_ready(pre.udiag_inv)
    warm_s = time.perf_counter() - t0
    solve = bicgstab_setup(A, pre.apply, tol=1e-8, maxiter=300)
    res = solve(b)
    jax.block_until_ready(res.x)
    eps = np.float32(1.0 + (time.time_ns() % 997 + 1) * 1e-6)
    b2 = jax.jit(lambda v, s: v * s)(b, jnp.asarray(eps, b.dtype))
    jax.block_until_ready(b2)             # perturbed rhs
    ovh = time.perf_counter()
    float(jnp.sum(b2))
    ovh = time.perf_counter() - ovh
    t0 = time.perf_counter()              # window ends on a scalar fetch
    res = solve(b2)
    float(res.relres)
    solve_s = max(time.perf_counter() - t0 - ovh, 0.0)
    return {"metric": "ilu_device_setup_224^3_11.2Mrow",
            "value": round(warm_s, 3), "unit": "s_warm_setup",
            "cold_s": round(cold_s, 2), "device_path": bool(dev),
            "rows": int(A.shape[0]),
            "solve_s": round(solve_s, 3), "iters": int(res.iters),
            "relres": float(res.relres), "converged": bool(res.converged),
            "note": "BiCGSTAB+ILU(0), rtol 1e-8; factors never touch the "
                    "host (VERDICT r3 #5: >=10M-row device ILU setup)"}


def _case_ell_setup() -> dict:
    """Algebraic AMG setup on an UNSTRUCTURED operator — 128^3 27-pt under
    a random symmetric permutation (2.1M rows, 56M nnz, no recoverable
    offset structure): the generic-ELL device setup path
    (amg/device_setup_ell.py; the file-loaded-system analog of the
    reference's on-device BoomerAMGSetup, src/HypreSystem.cpp:692).
    Reports the warm-compile-cache time (the production steady state);
    cold includes one-time XLA sort compiles (persistently cached)."""
    import jax
    from tpusolve.mesh import make_mesh
    from tpusolve.stencil import laplace27
    from tpusolve.config import BoomerAMGConfig
    from tpusolve.amg.builder import boomeramg_setup
    from tpusolve.matrix.sharded import ShardedMatrix

    import scipy.sparse as sp
    mesh = make_mesh(1)
    _, _, _, Ah = laplace27(mesh, 128, 128, 128, dtype=np.float32,
                            with_host=True)
    Ah = Ah.tocsr()
    n = Ah.shape[0]
    perm = np.random.default_rng(0).permutation(n)
    coo = Ah.tocoo()
    Ah = sp.csr_matrix((coo.data, (perm[coo.row], perm[coo.col])),
                       shape=(n, n))
    Ah.sort_indices()
    A = ShardedMatrix.from_csr_host(mesh, Ah, dtype=np.float32,
                                    allow_bell=False, allow_bdia=False)
    cfg = BoomerAMGConfig(interp_type=3)
    t0 = time.perf_counter()
    pre = boomeramg_setup(A, cfg, A_host=Ah)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pre = boomeramg_setup(A, cfg, A_host=Ah)
    setup_s = time.perf_counter() - t0
    dev = any("generic ELL" in s for s in pre.notes)
    return {"metric": "boomeramg_setup_128^3_ell_device",
            "value": round(setup_s, 2), "unit": "s_warm",
            "vs_baseline": round(15.4 / max(setup_s, 1e-9), 4),
            "cold_s": round(cold_s, 2), "levels": pre.num_levels,
            "device_path": bool(dev),
            "note": "unstructured (scrambled) 2.1M rows; baseline: 15.4 s "
                    "native host kernels on the same fixture class"}


def _run_gate_cli(tag: str, yaml_path: str) -> dict:
    """Run ``python -m tpusolve <yaml>`` and parse iters/relres/timers —
    gates as *results* (ref lifecycle src/main.cpp:164-192)."""
    import re
    import subprocess
    env = _child_env()
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "tpusolve", yaml_path],
                       capture_output=True, text=True, timeout=1800,
                       env=env)
    wall = time.perf_counter() - t0
    out = p.stdout
    r: dict = {"metric": tag, "unit": "s_solve", "wall_s": round(wall, 1),
               "passed": "Check solution: PASSED" in out,
               "exit": p.returncode}
    m = re.search(r"Solve 0: iters=(\d+) relres=([\d.e+-]+)", out)
    if m:
        r["iters"] = int(m.group(1))
        r["relres"] = float(m.group(2))
    for name, key in (("Preconditioner setup", "setup_s"),
                      ("Solve", "value"),
                      ("Compile (XLA trace+lower+build)", "compile_s"),
                      ("Total", "timers_total_s")):
        tm = re.search(rf"^    {re.escape(name)} +([\d.]+)\s*$", out,
                       re.MULTILINE)
        if tm:
            r[key] = round(float(tm.group(1)), 4)
    if "timers_total_s" in r:
        # VERDICT r3 #3: with the Compile timer, the named timers should
        # account for ~all of wall (ref table covers main()'s whole
        # runtime, src/main.cpp:187-216)
        r["wall_vs_timers_gap"] = round(
            (wall - r["timers_total_s"]) / max(wall, 1e-9), 3)
    if not r["passed"]:
        r["stderr_tail"] = p.stderr[-800:]
    return r


def _case_gate3_file() -> dict:
    """Gate 3: file-loaded pressure system (MatrixMarket), GMRES+AMG,
    golden check — through the CLI (readers ref:
    src/HypreSystem.cpp:1613-1969).  Runs 3x; all runs' wall/pass
    recorded."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from gatefix import prepare
    with tempfile.TemporaryDirectory() as tmp:
        y3, _ = prepare(tmp)
        runs = [_run_gate_cli("gate3_pressure_mm_gmres_amg_64^3", y3)
                for _ in range(3)]
    best = min(runs, key=lambda r: r.get("wall_s", 1e9))
    best["runs"] = [{k: r.get(k) for k in
                     ("wall_s", "passed", "exit", "iters",
                      "wall_vs_timers_gap")} for r in runs]
    best["passes"] = sum(1 for r in runs if r.get("passed"))
    return best


def _case_gate4_file() -> dict:
    """Gate 4: file-loaded momentum system (HYPRE-IJ), BiCGSTAB+ILU,
    precision mixed — through the CLI (readers ref:
    src/HypreSystem.cpp:1021-1318)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from gatefix import prepare
    with tempfile.TemporaryDirectory() as tmp:
        _, y4 = prepare(tmp)
        return _run_gate_cli("gate4_momentum_ij_bicgstab_ilu_48^3", y4)


_FULL_CASES = {
    "bdia_unstructured": _case_bdia_unstructured,
    "flagship_solve": _case_flagship_solve,
    "amg_setup": _case_amg_setup,
    "device_setup_256": _case_device_setup_256,
    "big_solve": _case_big_solve,
    "big_solve_child": _case_big_solve_child,
    "ilu_device_setup": _case_ilu_device_setup,
    "ell_setup": _case_ell_setup,
    "gate3_file": _case_gate3_file,
    "gate4_file": _case_gate4_file,
}
# cases that start child processes themselves and so run in the parent,
# which never touches the device
_PARENT_CASES = ("big_solve", "gate3_file", "gate4_file")


def _run_child_case(name: str) -> dict:
    import subprocess
    p = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--case", name],
        capture_output=True, text=True, timeout=3600, env=_child_env(),
        cwd=HERE)
    for ln in reversed(p.stdout.splitlines()):
        if ln.startswith("{"):
            try:
                return json.loads(ln)
            except json.JSONDecodeError:
                continue
    return {"metric": name,
            "error": f"subprocess rc={p.returncode}: {p.stderr[-400:]}"}


def run_full() -> int:
    """The headline and every case, each device case in a child process of
    its own (a fresh process starts with the device's memory free); this
    process never imports JAX, so one process holds the device at a
    time."""
    results = []
    for name in ("head",) + tuple(_FULL_CASES):
        if name == "big_solve_child":
            continue
        if name in _PARENT_CASES:
            try:
                r = _FULL_CASES[name]()
            except Exception as e:  # record the case's failure, go on
                r = {"metric": name, "error": f"{type(e).__name__}: {e}"}
        else:
            r = _run_child_case(name)
        print(json.dumps(r), flush=True)
        results.append(r)
    with open("BENCH_FULL.json", "w") as fh:
        json.dump(results, fh, indent=1)
    return 0


def head_case() -> dict:
    """The headline: SpMV effective bandwidth, 27-pt 128^3 f32."""
    import jax
    import jax.numpy as jnp
    from jax import lax
    from tpusolve.mesh import make_mesh
    from tpusolve.stencil import laplace27
    from tpusolve.matrix.spmv import spmv

    dev = jax.devices()[0]
    sol = peak_hbm_gbps(dev.device_kind)
    side = 128                            # per-device box (ref default)
    mesh = make_mesh(1)
    A, b, _ = laplace27(mesh, side, side, side, dtype=np.float32)
    n = A.shape[0]

    # bytes actually streamed per SpMV (format-dependent) + vector I/O
    itemsize = 4
    if A.uses_dia:
        mat_bytes = int(np.prod(A.dia_vals.shape)) * itemsize  # values only
    else:
        mat_bytes = 2 * int(np.prod(A.diag_vals.shape)) * itemsize
    if A.has_offd:
        mat_bytes += 2 * int(np.prod(A.offd_vals.shape)) * itemsize
    bytes_per = (mat_bytes
                 + A.padded_ncols * itemsize         # x read
                 + A.padded_nrows * itemsize)        # y write
    # one chain of n_it SpMVs, minus the cost of a trivial dispatch+fetch
    n_it = 192

    @jax.jit
    def chain(x):
        # power-iteration-style chain keeps data on device; scaling by the
        # spectral bound prevents overflow
        def body(_, x):
            return spmv(A, x) * jnp.float32(1.0 / 52.0)
        y = lax.fori_loop(0, n_it, body, x)
        return jnp.sum(jnp.abs(y))         # scalar forces real execution

    @jax.jit
    def trivial(x):
        return jnp.sum(x) * jnp.float32(1.0)

    float(trivial(b))                      # compile
    float(chain(b))                        # compile + warm up
    overhead = float("inf")
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        float(trivial(b))
        overhead = min(overhead, time.perf_counter() - t0)
        t0 = time.perf_counter()
        float(chain(b))
        best = min(best, time.perf_counter() - t0)
    per_spmv = max(best - overhead, 1e-9) / n_it
    gbps = bytes_per / per_spmv / 1e9
    target = 0.8 * sol
    print(f"# device={dev.device_kind} n={n} nnz={A.nnz} "
          f"bytes/spmv={bytes_per/1e6:.1f}MB per_spmv={per_spmv*1e3:.3f}ms "
          f"peak={sol}GB/s target(0.8*peak)={target}GB/s", file=sys.stderr)
    return {"metric": f"spmv_effective_bandwidth_27pt_{side}^3_f32",
            "value": round(gbps, 2), "unit": "GB/s",
            "vs_baseline": round(gbps / target, 4)}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--full" in argv:
        return run_full()
    from tpusolve.runtime import enable_compile_cache
    enable_compile_cache()
    if "--case" in argv:                   # child mode: one case, one line
        name = argv[argv.index("--case") + 1]
        fn = head_case if name == "head" else _FULL_CASES[name]
        try:
            r = fn()
        except Exception as e:  # the case's failure is its record
            r = {"metric": name, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(r), flush=True)
        return 0
    try:
        head = head_case()
    except ValueError as e:                # no peak on record: not a GPU
        print(f"bench.py: {e}", file=sys.stderr)
        return 2
    print(json.dumps(head), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
