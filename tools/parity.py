"""Convergence-parity harness.

Runs matched-settings AMG-Krylov fixtures and compares achieved iteration
counts against *recorded* BoomerAMG expectations (tools/parity_expected.json
— values from published BoomerAMG results, with provenance; NOT chosen from
this framework's output).  The north star (BASELINE.md) is iterations within
10% of BoomerAMG at matched tolerance; the budget column additionally folds
in the documented l1-Jacobi-for-hybrid-GS smoother delta.

Usage:
    python tools/parity.py                  # print the table
    python tools/parity.py --write-readme   # refresh the README section

Runs on the CPU (8 virtual devices); ``--chip`` runs on the GPU instead,
where the fixtures marked ``chip`` (>=2M rows) run too.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EXPECTED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "parity_expected.json")
README = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "README.md")
MARK_BEGIN = "<!-- parity-table-begin -->"
MARK_END = "<!-- parity-table-end -->"


def _select_backend(chip: bool):
    import jax
    if chip:
        if jax.devices()[0].platform != "gpu":
            raise SystemExit("--chip: no GPU found")
    else:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8")
        jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def run_fixture(fx: dict, mesh):
    import numpy as np
    import scipy.sparse as sp
    from tpusolve.config import BoomerAMGConfig
    from tpusolve.amg import boomeramg_setup
    from tpusolve.krylov import pcg_setup, gmres_setup
    from tpusolve.matrix.sharded import ShardedMatrix
    from tpusolve.matrix.vectors import to_device_vector
    from tpusolve.stencil import laplace27

    name = fx["name"]
    s = fx["settings"]
    theta = float(s.get("strong_threshold", 0.25))
    sweeps = 2 if "V(2,2)" in s.get("cycle", "V(1,1)") else 1

    if name.startswith("laplace27"):
        dims = fx.get("dims", [8, 8, 8])
        dt = np.float32 if fx.get("chip") else np.float64
        A, b, _ = laplace27(mesh, *dims, dtype=dt)
        A_host = None
    else:
        def lap1(n):
            return sp.diags([-np.ones(n - 1), 2 * np.ones(n),
                             -np.ones(n - 1)], [-1, 0, 1])
        n2 = 64
        Ah = (sp.kron(sp.eye(n2), lap1(n2))
              + sp.kron(lap1(n2), sp.eye(n2))).tocsr()
        Ah.eliminate_zeros()
        A = ShardedMatrix.from_csr_host(mesh, Ah, dtype=np.float64)
        x_true = np.ones(Ah.shape[0])
        b = to_device_vector(mesh, Ah @ x_true, A.row_offsets, A.row_pad,
                             dtype=np.float64)
        A_host = Ah

    extra = {k: s[k] for k in ("relax_type", "cheby_order",
                               "cheby_variant", "relax_order") if k in s}
    cfg = BoomerAMGConfig(strong_threshold=theta, num_sweeps=sweeps,
                          interp_type=int(s.get("interp_type", 0)),
                          max_coarse_size=64, **extra)
    pre = boomeramg_setup(A, cfg, A_host=A_host)
    tol = float(s.get("tolerance", 1e-8))
    if fx["solver"].startswith("gmres"):
        solve = gmres_setup(A, pre.apply, tol=tol, restart=20, maxiter=200)
    else:
        solve = pcg_setup(A, pre.apply, tol=tol, maxiter=200)
    res = solve(b)
    return int(res.iters), bool(res.converged)


def build_table() -> str:
    from tpusolve.mesh import make_mesh
    import jax
    on_chip = jax.devices()[0].platform == "gpu"
    mesh = make_mesh(min(8, len(jax.devices())))
    with open(EXPECTED) as fh:
        doc = json.load(fh)
    lines = [
        "| fixture | solver | expected (BoomerAMG, recorded) | budget "
        "(1.10x north-star margin; +l1-Jacobi delta where measured) | "
        "achieved | ratio | verdict |",
        "|---|---|---|---|---|---|---|",
    ]
    ok_all = True
    for fx in doc["fixtures"]:
        if fx.get("chip") and not on_chip:
            lines.append(f"| {fx['name']} | {fx['solver']} | "
                         f"{fx['expected_iters']} | {fx['budget_iters']} | "
                         "not run (GPU only) | | |")
            print(lines[-1], flush=True)
            continue
        iters, conv = run_fixture(fx, mesh)
        exp, budget = fx["expected_iters"], fx["budget_iters"]
        ratio = iters / exp
        ok = conv and iters <= budget
        ok_all &= ok
        lines.append(
            f"| {fx['name']} | {fx['solver']} | {exp} | {budget} | "
            f"{iters} | {ratio:.2f}x | {'PASS' if ok else 'FAIL'} |")
        print(lines[-1], flush=True)
    return "\n".join(lines), ok_all


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--write-readme", action="store_true")
    ap.add_argument("--chip", action="store_true",
                    help="run on the GPU, chip-only fixtures included")
    args = ap.parse_args()
    _select_backend(args.chip)
    table, ok = build_table()
    print(table)
    if args.write_readme:
        with open(README) as fh:
            text = fh.read()
        if MARK_BEGIN in text:
            head, rest = text.split(MARK_BEGIN, 1)
            _, tail = rest.split(MARK_END, 1)
            text = head + MARK_BEGIN + "\n" + table + "\n" + MARK_END + tail
            with open(README, "w") as fh:
                fh.write(text)
            print("README parity table updated")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
