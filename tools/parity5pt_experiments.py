"""Smoother experiments on the 1.50x parity fixture (VERDICT r3 weak #7).

laplace5pt_64x64_pcg_amg records expected 8 iterations (BoomerAMG,
hybrid-GS V(1,1)); the l1-Jacobi substitution achieved 12 (1.50x).  This
sweep tries the data-parallel alternatives — CF-ordered
l1-Jacobi (relax_order 1), Chebyshev 1st kind (orders 2/3), Chebyshev
4th kind (Lottes), V(2,2), plain weighted Jacobi — and prints achieved
iterations for each so parity_expected.json can record the best attempt.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402
from tpusolve.mesh import make_mesh  # noqa: E402
from tpusolve.matrix.sharded import ShardedMatrix  # noqa: E402
from tpusolve.matrix.vectors import to_device_vector  # noqa: E402
from tpusolve.amg import boomeramg_setup  # noqa: E402
from tpusolve.config import BoomerAMGConfig  # noqa: E402
from tpusolve.krylov import pcg_setup  # noqa: E402


def fixture(mesh):
    def lap1(n):
        return sp.diags([-np.ones(n - 1), 2 * np.ones(n),
                         -np.ones(n - 1)], [-1, 0, 1])
    n2 = 64
    Ah = (sp.kron(sp.eye(n2), lap1(n2))
          + sp.kron(lap1(n2), sp.eye(n2))).tocsr()
    Ah.eliminate_zeros()
    A = ShardedMatrix.from_csr_host(mesh, Ah, dtype=np.float64)
    b = to_device_vector(mesh, Ah @ np.ones(Ah.shape[0]), A.row_offsets,
                         A.row_pad, dtype=np.float64)
    return A, b, Ah


def run(mesh, A, b, Ah, label, **kw):
    cfg = BoomerAMGConfig(strong_threshold=0.25, interp_type=6,
                          max_coarse_size=64, **kw)
    pre = boomeramg_setup(A, cfg, A_host=Ah)
    res = pcg_setup(A, pre.apply, tol=1e-8, maxiter=200)(b)
    print(f"{label:44s} iters={int(res.iters):3d} "
          f"conv={bool(res.converged)} ratio={int(res.iters)/8:.2f}x",
          flush=True)
    return int(res.iters)


def main():
    mesh = make_mesh(8)
    A, b, Ah = fixture(mesh)
    best = []
    best.append(("l1-jacobi V(1,1) [current]",
                 run(mesh, A, b, Ah, "l1-jacobi V(1,1) [current]")))
    best.append(("l1-jacobi CF-ordered V(1,1)",
                 run(mesh, A, b, Ah, "l1-jacobi CF-ordered V(1,1)",
                     relax_order=1)))
    best.append(("l1-jacobi V(2,2)",
                 run(mesh, A, b, Ah, "l1-jacobi V(2,2)", num_sweeps=2)))
    best.append(("cheby(2) V(1,1)",
                 run(mesh, A, b, Ah, "cheby(2) V(1,1)", relax_type=16,
                     cheby_order=2)))
    best.append(("cheby(3) V(1,1)",
                 run(mesh, A, b, Ah, "cheby(3) V(1,1)", relax_type=16,
                     cheby_order=3)))
    best.append(("cheby4th(3) V(1,1)",
                 run(mesh, A, b, Ah, "cheby4th(3) V(1,1)", relax_type=16,
                     cheby_order=3, cheby_variant=4)))
    best.append(("cheby4th(4) V(1,1)",
                 run(mesh, A, b, Ah, "cheby4th(4) V(1,1)", relax_type=16,
                     cheby_order=4, cheby_variant=4)))
    best.append(("cheby(2) CF V(1,1)",
                 run(mesh, A, b, Ah, "cheby(2) CF V(1,1)", relax_type=16,
                     cheby_order=2, relax_order=1)))
    best.append(("jacobi(w) V(2,2)",
                 run(mesh, A, b, Ah, "jacobi(w) V(2,2)", relax_type=0,
                     num_sweeps=2)))
    best.sort(key=lambda t: t[1])
    print("\nbest:", best[0])


if __name__ == "__main__":
    main()
