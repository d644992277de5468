"""Smoke test of the solve path on the GPU.

    python chip_smoke.py              # one card: phases 0-6
    python chip_smoke.py --cards 4    # four cards: the sharded path only

Each phase prints one JSON line: its name, ``ok``, its seconds and what it
checked.  The card's name and power limit (from ``nvidia-smi``) follow, and
the last line is ``{"ok": true, "device": {...}}`` — printed only when every
phase passed.  Otherwise the script exits non-zero.

The parent process never imports JAX.  Every phase runs in a child process
of its own (``--phase NAME``), so exactly one process holds the cards at a
time and the x64 switch of one phase does not leak into the next.  Children
use the persistent compile cache (``tpusolve.runtime``).  Logs of each
child's full output go to ``chiprun_out/chip_smoke/``.

The phase functions are importable and take their sizes as arguments, so
the CPU tests rehearse each one at a tiny size.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
LOG_DIR = os.path.join(HERE, "chiprun_out", "chip_smoke")
BUDGET_S = 1140          # whole run, compilation included

# Tolerances and their reasons.
#
# SpMV, max-norm error relative to max|y|, against the f64 scipy product of
# the f64 values: in f32 the values are rounded once (2^-24 each) and summed
# over <= 27 terms in f32, so errors sit near 1e-7; 1e-5 leaves two orders
# of margin yet fails a wrong window, a dropped entry or a TF32 product
# (~5e-4).  In f64 the same argument with 2^-53 gives 1e-12.
SPMV_TOL = {"float32": 1e-5, "float64": 1e-12}
# Device AMG setup (f32) against the host pipeline (f64 arithmetic on the
# same f32 operator), Frobenius norm of the difference over that of the
# host operator.  The operators the device computes from the shared input
# (P0 and A1): each entry sums O(100) f32 products of O(1) terms, so f32
# rounding gives ~1e-7; a TF32 contraction gives ~1e-4.
AMG_TOL = 1e-5
# Deeper levels are computed by the host pipeline in both hierarchies, the
# device one starting from its f32 A1.  Extended+i interpolation amplifies
# that f32 rounding (3.8e-4 at level 3 of the 128^3 hierarchy on an H100),
# so these levels get a sanity bound only.
AMG_TOL_HOST_LEVELS = 1e-2

_ONE_CARD = (("device", 120), ("spmv", 300), ("amg", 420),
             ("cli_single", 300), ("cli_double", 300), ("gate3", 420),
             ("gate4", 300), ("chip_tests", 300))
_FOUR_CARDS = (("device", 120), ("spmv", 300), ("cli_single", 400),
               ("gate3", 500))


# ----------------------------------------------------------------------
# phases (run in child processes; importable for the CPU rehearsals)

def phase_device(platform: str = "gpu", cards: int = 1) -> dict:
    """The backend JAX starts with: ``platform`` and at least ``cards``
    devices."""
    import jax
    devs = jax.devices()
    d = devs[0]
    return {"ok": d.platform == platform and len(devs) >= cards,
            "platform": d.platform, "kind": d.device_kind,
            "count": len(devs), "jax": jax.__version__}


def _mesh(cards: int):
    from tpusolve.mesh import make_mesh
    return make_mesh(cards)


def _spmv_error(A, A_host, x, dtype) -> float:
    """max|spmv(A, x) - A_host @ x| / max|A_host @ x|, reference in f64."""
    import numpy as np
    from tpusolve.matrix.spmv import spmv
    from tpusolve.matrix.vectors import to_device_vector, from_device_vector
    xd = to_device_vector(A.mesh, x, A.col_offsets, A.col_pad, dtype=dtype)
    y = from_device_vector(spmv(A, xd), A.row_offsets, A.row_pad)
    ref = A_host @ x.astype(np.float64)
    return float(np.abs(y - ref).max() / np.abs(ref).max())


def phase_spmv(side_dia: int = 128, side_graph: int = 96,
               cards: int = 1) -> dict:
    """SpMV in every layout against the scipy CSR product, f32 and f64:
    DIA on the 27-pt Laplacian at side_dia^3 rows per card (sharded over
    ``cards``); on one card, BDIA and padded ELL forced with the ``allow_*``
    flags and the BELL kernel, on the clustered-band graph with
    side_graph^3 rows."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from tpusolve.stencil import laplace27
    from tpusolve.matrix.sharded import ShardedMatrix
    from tpusolve.kernels import bell
    sys.path.insert(0, os.path.join(HERE, "tools"))
    from gatefix import clustered_band

    mesh = _mesh(cards)
    rng = np.random.default_rng(5)
    checks, ok = {}, True
    n = side_graph ** 3
    r, c, v = clustered_band(n)
    S = sp.csr_matrix((v, (r, c)), shape=(n, n))
    forced = {"bdia": dict(allow_bell=False),
              "ell": dict(allow_bell=False, allow_bdia=False)}
    for dt in (np.float32, np.float64):
        name = np.dtype(dt).name
        tol = SPMV_TOL[name]
        A, _, _, Ah = laplace27(mesh, side_dia, side_dia, side_dia,
                                dtype=dt, with_host=True)
        x = rng.standard_normal(A.shape[0]).astype(dt)
        err = _spmv_error(A, Ah, x, dt)
        checks[f"dia_{name}"] = {"layout": A.layout, "rows": A.shape[0],
                                 "err": err, "tol": tol}
        ok &= A.layout == "dia" and err <= tol
        del A, Ah
        if cards != 1:
            continue
        x = rng.standard_normal(n).astype(dt)
        ref = S @ x.astype(np.float64)
        scale = np.abs(ref).max()
        for layout, flags in forced.items():
            A = ShardedMatrix.from_coo(mesh, (n, n), r, c, v, dtype=dt,
                                       allow_dia=False, **flags)
            err = _spmv_error(A, S, x, dt)
            checks[f"{layout}_{name}"] = {"layout": A.layout, "rows": n,
                                          "err": err, "tol": tol}
            ok &= A.layout == layout and err <= tol
            del A
        # BELL: on this graph its tiles exceed the assembly's tile budget
        # (~60x the nonzeros), so the layout never gets chosen here; the
        # kernel is checked on device-built tiles instead
        k = bell.bell_plan_k(r, c, n)
        ids, flat, vo = bell.bell_compact(r, c, v, n, n, k, dtype=dt)
        G = bell._ngroups(n)
        tiles = jnp.zeros(G * k * bell.TM * bell.TN, dt).at[
            jnp.asarray(flat)].set(jnp.asarray(vo)).reshape(
                G, k, bell.TM, bell.TN)
        y = np.asarray(jax.jit(bell.bell_spmv_local, static_argnums=(3, 4))(
            tiles, jnp.asarray(ids), jnp.asarray(x),
            (n + bell.TN - 1) // bell.TN, n))
        err = float(np.abs(y - ref).max() / scale)
        checks[f"bell_kernel_{name}"] = {"tiles": int(G * k), "err": err,
                                         "tol": tol}
        ok &= err <= tol
        del tiles
    return {"ok": bool(ok), "checks": checks,
            "peak_bytes_in_use": _peak_bytes()}


def _rel_fro(A_d, A_h) -> float:
    import numpy as np
    import scipy.sparse.linalg as spla
    den = spla.norm(A_h)
    return float(spla.norm(A_d - A_h) / den) if den else 0.0


def _scrambled_27pt(mesh, side):
    """The 27-pt Laplacian (side^3 rows, f32) under a random symmetric
    permutation: host CSR and the ELL-layout sharded matrix."""
    import numpy as np
    import scipy.sparse as sp
    from tpusolve.stencil import laplace27
    from tpusolve.matrix.sharded import ShardedMatrix
    _, _, _, Ah = laplace27(mesh, side, side, side, dtype=np.float32,
                            with_host=True)
    n = Ah.shape[0]
    perm = np.random.default_rng(0).permutation(n)
    coo = Ah.tocoo()
    Ah = sp.csr_matrix((coo.data, (perm[coo.row], perm[coo.col])),
                       shape=(n, n))
    Ah.sort_indices()
    A = ShardedMatrix.from_csr_host(mesh, Ah, dtype=np.float32,
                                    allow_bell=False, allow_bdia=False)
    return A, Ah


def phase_amg(side: int = 128, exti_side: int = 96) -> dict:
    """Device AMG setup (generic-ELL pipeline, f32) on the scrambled 27-pt
    operator against the host pipeline: classical-modified interpolation
    (interp_type 0) at side^3 rows, extended+i (6) at exti_side^3 rows —
    the gate-3 size, whose compiled programs gate 3 then reuses.  Checks
    the same level count and sizes, P0 and the coarse operators within
    AMG_TOL where the device computed them and within AMG_TOL_HOST_LEVELS
    where the host pipeline continued.  Uses the host PMIS tie-break
    (TPUSOLVE_PMIS_HOST_RANK=1) so both coarsen alike."""
    from tpusolve.config import BoomerAMGConfig
    from tpusolve.amg.builder import boomeramg_setup
    from tpusolve.amg import device_setup_ell

    os.environ["TPUSOLVE_PMIS_HOST_RANK"] = "1"
    mesh = _mesh(1)
    checks, ok = {}, True
    for interp, s in ((0, side), (6, exti_side)):
        A, Ah = _scrambled_27pt(mesh, s)
        cfg = BoomerAMGConfig(interp_type=interp)
        if not device_setup_ell.eligible(A, cfg, Ah):
            return {"ok": False, "error": "generic-ELL device setup "
                    f"not eligible (n={A.shape[0]}, interp_type={interp})"}
        t0 = time.perf_counter()
        dev = boomeramg_setup(A, cfg, A_host=Ah)
        t_dev = time.perf_counter() - t0
        os.environ["TPUSOLVE_HOST_SETUP"] = "1"
        try:
            t0 = time.perf_counter()
            host = boomeramg_setup(A, cfg, A_host=Ah)
            t_host = time.perf_counter() - t0
        finally:
            del os.environ["TPUSOLVE_HOST_SETUP"]
        sizes_d = [lev.n for lev in dev.levels]
        sizes_h = [lev.n for lev in host.levels]
        # levels the device pipeline built (it recurses while a level has
        # at least the device-setup threshold of rows)
        n_dev = 1 + sum(1 for s_ in dev.notes if "recursed on device" in s_)
        errs, tols, p0 = [], [], None
        if sizes_d == sizes_h:
            p0 = _rel_fro(dev.levels[0].P.to_scipy(),
                          host.levels[0].P.to_scipy())
            for lvl in range(1, len(sizes_d)):
                errs.append(_rel_fro(dev.levels[lvl].A.to_scipy(),
                                     host.levels[lvl].A.to_scipy()))
                tols.append(AMG_TOL if lvl <= n_dev
                            else AMG_TOL_HOST_LEVELS)
        on_device = any("generic ELL" in s_ for s_ in dev.notes)
        good = (on_device and sizes_d == sizes_h and p0 <= AMG_TOL
                and all(e <= t for e, t in zip(errs, tols)))
        checks[f"interp{interp}"] = {
            "rows": A.shape[0], "device_path": on_device,
            "levels": sizes_d, "host_levels": sizes_h,
            "device_levels": n_dev, "p0_rel_fro": p0,
            "coarse_rel_fro": errs, "tol": tols,
            "device_setup_s": round(t_dev, 3),
            "host_setup_s": round(t_host, 3)}
        ok &= good
        del dev, host, A, Ah
    return {"ok": bool(ok), "checks": checks}


def _peak_bytes() -> list:
    import jax
    out = []
    for d in jax.devices():
        stats = d.memory_stats() or {}
        out.append(stats.get("peak_bytes_in_use"))
    return out


def _run_cli(doc: dict, log_name: str) -> dict:
    """Run ``tpusolve.harness.cli.main`` on a YAML document, output to a
    log; returns exit code, golden-check verdict and the solve report."""
    import yaml
    from tpusolve.harness import cli
    os.makedirs(LOG_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.yaml")
        with open(path, "w") as fh:
            yaml.safe_dump(doc, fh)
        log = os.path.join(LOG_DIR, f"{log_name}.log")
        with open(log, "w") as fh, contextlib.redirect_stdout(fh):
            rc = cli.main([path])
        with open(log) as fh:
            out = fh.read()
    solves = re.findall(r"Solve \d+: iters=(\d+) relres=([\d.e+-]+)", out)
    layout = re.search(r"Matrix layout: (\w+)", out)
    return {"exit": rc, "passed": "Check solution: PASSED" in out
            and "Check solution: FAILED" not in out,
            "iters": [int(i) for i, _ in solves],
            "relres": [float(r) for _, r in solves],
            "layout": layout.group(1) if layout else None,
            "device_setup": ("generic ELL" in out or "on device" in out),
            "peak_bytes_in_use": _peak_bytes(), "log": log}


def phase_cli_stencil(side: int = 128, precision: str = "single",
                      cards: int = 1) -> dict:
    """The weak-scaling example (27-pt, side^3 rows per card, PCG +
    BoomerAMG with device setup) through the CLI at ``precision``."""
    import yaml
    with open(os.path.join(HERE, "examples",
                           "weakscale_pcg_boomeramg_devsetup.yaml")) as fh:
        doc = yaml.safe_load(fh)
    doc["linear_system"].update(nx=side, ny=side, nz=side)
    doc["solver_settings"].update(precision=precision, check_memory=True)
    r = _run_cli(doc, f"cli_{precision}_{cards}card")
    r["rows"] = side ** 3 * len(r["peak_bytes_in_use"])
    r["ok"] = r["exit"] == 0 and r["passed"]
    return r


def phase_gate3(side: int = 96) -> dict:
    """Gate 3: the file-loaded pressure system (MatrixMarket, side^3 rows,
    RCM), GMRES(20) + BoomerAMG ext+i, double precision."""
    import yaml
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import gatefix
    with tempfile.TemporaryDirectory() as tmp:
        m, rhs, sln, n = gatefix.write_pressure_mm(tmp, side, side, side)
        doc = yaml.safe_load(gatefix.GATE3_YAML.format(mat=m, rhs=rhs,
                                                       sln=sln))
        doc["solver_settings"].update(precision="double", check_memory=True)
        r = _run_cli(doc, "gate3")
    r["rows"] = n
    r["ok"] = r["exit"] == 0 and r["passed"]
    return r


def phase_gate4(side: int = 48) -> dict:
    """Gate 4: the file-loaded momentum system (HYPRE-IJ, side^3 rows, 3
    components), BiCGSTAB + ILU(0), mixed precision."""
    import yaml
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import gatefix
    with tempfile.TemporaryDirectory() as tmp:
        m, rhs, sln, n = gatefix.write_momentum_ij(tmp, side, side, side,
                                                   ncomp=3)
        doc = yaml.safe_load(gatefix.GATE4_YAML_3COMP.format(
            mat=m, rhs0=rhs[0], rhs1=rhs[1], rhs2=rhs[2], sln0=sln[0],
            sln1=sln[1], sln2=sln[2], nfiles=2))
        doc["solver_settings"]["check_memory"] = True
        r = _run_cli(doc, "gate4")
    r["rows"] = n
    r["ok"] = r["exit"] == 0 and r["passed"] and len(r["iters"]) == 3
    return r


def phase_chip_tests(platforms: str = "cuda", timeout: float = 300) -> dict:
    """``pytest -m chip`` in a child process on ``platforms``.  Passes when
    pytest exits 0 with at least one test passed and none skipped."""
    env = dict(os.environ, JAX_PLATFORMS=platforms,
               PYTHONPATH=os.pathsep.join(
                   [HERE] + [p for p in os.environ.get(
                       "PYTHONPATH", "").split(os.pathsep) if p]))
    p = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "chip", "tests/", "-q",
         "-p", "no:cacheprovider", "-rs", "--durations=5"],
        cwd=HERE, env=env, capture_output=True, text=True, timeout=timeout)
    counts = {k: int(v) for v, k in re.findall(
        r"(\d+) (passed|failed|skipped|error|errors)", p.stdout)}
    return {"ok": p.returncode == 0 and counts.get("passed", 0) > 0
            and not counts.get("skipped"), "exit": p.returncode,
            "counts": counts, "tail": p.stdout[-900:]}


# phases that take the card count (the rest run on one card)
_SHARDED_PHASES = ("device", "spmv", "cli_single", "cli_double")
_PHASES = {
    "device": phase_device,
    "spmv": phase_spmv,
    "amg": phase_amg,
    "cli_single": lambda cards=1: phase_cli_stencil(precision="single",
                                                    cards=cards),
    "cli_double": lambda cards=1: phase_cli_stencil(precision="double",
                                                    cards=cards),
    "gate3": phase_gate3,
    "gate4": phase_gate4,
}


def _child(name: str, cards: int) -> int:
    """Child-process entry: run one phase, print its JSON record."""
    from tpusolve.runtime import enable_compile_cache
    enable_compile_cache()
    if name == "spmv":          # its f64 half needs 64-bit arrays
        import jax
        jax.config.update("jax_enable_x64", True)
    t0 = time.perf_counter()
    try:
        fn = _PHASES[name]
        rec = fn(cards=cards) if name in _SHARDED_PHASES else fn()
    except Exception as e:  # report the failure as the phase's record
        rec = {"ok": False, "error": f"{type(e).__name__}: {e}"[:2000]}
    rec = {"phase": name, "ok": bool(rec.pop("ok")),
           "seconds": round(time.perf_counter() - t0, 3), **rec}
    print(json.dumps(rec, default=str), flush=True)
    return 0 if rec["ok"] else 1


# ----------------------------------------------------------------------
# parent (no JAX)

def card_line() -> str | None:
    """``name, power.limit`` of each card from nvidia-smi, or None."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return p.stdout.strip() if p.returncode == 0 else None


def _run_child(name: str, cards: int, timeout: float) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [HERE] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    t0 = time.perf_counter()
    try:
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--phase", name,
             "--cards", str(cards)],
            cwd=HERE, env=env, stdout=subprocess.PIPE, text=True,
            timeout=max(timeout, 1))
    except subprocess.TimeoutExpired:
        return {"phase": name, "ok": False,
                "seconds": round(time.perf_counter() - t0, 3),
                "error": f"timed out after {timeout:.0f} s"}
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    if not lines:
        return {"phase": name, "ok": False,
                "seconds": round(time.perf_counter() - t0, 3),
                "error": f"no record (exit {p.returncode})"}
    return json.loads(lines[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    ap.add_argument("--phase", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.phase:
        return _child(args.phase, args.cards)
    if not os.path.isdir(os.path.join(HERE, "tpusolve")):
        print("chip_smoke.py: the tpusolve package is not next to this "
              "script", file=sys.stderr)
        return 2
    start = time.perf_counter()
    card = card_line()
    device = None
    all_ok = True
    for name, limit in (_ONE_CARD if args.cards == 1 else _FOUR_CARDS):
        left = BUDGET_S - (time.perf_counter() - start)
        if name == "chip_tests":
            t0 = time.perf_counter()
            rec = {"phase": name, **phase_chip_tests(
                timeout=max(min(limit, left), 1))}
            rec["seconds"] = round(time.perf_counter() - t0, 3)
        else:
            rec = _run_child(name, args.cards, min(limit, left))
        if name == "device":
            rec["card"] = card
            device = {"platform": rec.get("platform"),
                      "kind": rec.get("kind"), "count": rec.get("count")}
        print(json.dumps(rec, default=str), flush=True)
        all_ok &= bool(rec["ok"])
        if name == "device" and not rec["ok"]:
            break
    print(card if card else "nvidia-smi: no card found", flush=True)
    if not all_ok:
        print("chip_smoke.py: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
