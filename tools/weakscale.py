"""Weak-scaling benchmark on the virtual multi-device mesh.

The gate-2 shape (BASELINE.md): one 27-pt box per device, GMRES+Chebyshev-
AMG-style work, scaled by adding devices.  It runs the same `shard_map`
program on real devices or on an N-device virtual CPU mesh
(`--xla_force_host_platform_device_count`), which exercises the real halo
`all_to_all` and `psum` paths.

CAVEAT (read before quoting numbers): on the virtual CPU mesh the N devices
share the host's cores — "weak scaling" degrades by construction, comm
shares are inflated, and overlap cannot materialize.  There the output is
functional: the multi-device program compiles, runs, produces identical
results with overlap on/off, and the comm/compute split is measurable.
Real ratios need real cards.

Reports, per device count:
  - SpMV time/box, interior-only SpMV time/box (comm share = 1 - ratio)
  - halo overlap ON vs OFF delta
Writes BENCH_WEAK.json and prints one JSON line per mesh size.

Usage: python tools/weakscale.py [--side 32] [--devices 1 2 4 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "BENCH_WEAK.json")


def _setup(ndev: int):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count={ndev}")
    import jax
    jax.config.update("jax_platforms", "cpu")


def _time_chain(fn, x, n_lo=4, n_hi=16):
    """Slope timing: (t(n_hi) - t(n_lo)) / (n_hi - n_lo)."""
    import jax
    ts = {}
    for n in (n_lo, n_hi):
        r = fn(x, n)
        jax.block_until_ready(r)
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(x, n))
            best = min(best, time.perf_counter() - t0)
        ts[n] = best
    return max(ts[n_hi] - ts[n_lo], 1e-12) / (n_hi - n_lo)


def run(side: int, ndev: int) -> dict:
    import jax
    import jax.numpy as jnp
    from jax import lax
    import numpy as np
    from tpusolve.mesh import make_mesh
    from tpusolve.stencil import laplace27
    import importlib
    spmv_mod = importlib.import_module('tpusolve.matrix.spmv')

    mesh = make_mesh(ndev)
    A, b, _ = laplace27(mesh, side, side, side, dtype=np.float32)

    def chain_fn():
        @jax.jit
        def chain(x, n):
            def body(_, x):
                return spmv_mod.spmv(A, x) * jnp.float32(1 / 52.0)
            return jnp.sum(jnp.abs(lax.fori_loop(0, n, body, x)))
        return chain

    # interior-only operator: same matrix with the offd/halo path disabled
    import dataclasses
    A_int = dataclasses.replace(A, has_offd=False)

    def chain_interior():
        @jax.jit
        def chain(x, n):
            def body(_, x):
                return spmv_mod.spmv(A_int, x) * jnp.float32(1 / 52.0)
            return jnp.sum(jnp.abs(lax.fori_loop(0, n, body, x)))
        return chain

    spmv_mod.HALO_OVERLAP = True
    t_on = _time_chain(chain_fn(), b)
    spmv_mod.HALO_OVERLAP = False
    t_off = _time_chain(chain_fn(), b)
    spmv_mod.HALO_OVERLAP = True
    t_int = _time_chain(chain_interior(), b)

    n = A.shape[0]
    rec = {
        "devices": ndev,
        "rows_per_device": side ** 3,
        "global_rows": n,
        "spmv_ms": round(t_on * 1e3, 3),
        "spmv_interior_ms": round(t_int * 1e3, 3),
        "comm_share": round(max(0.0, 1 - t_int / t_on), 3),
        "spmv_no_overlap_ms": round(t_off * 1e3, 3),
        "overlap_speedup": round(t_off / t_on, 3),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=32)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()
    _setup(max(args.devices))
    recs = [run(args.side, nd) for nd in args.devices]
    base = recs[0]["spmv_ms"]
    for r in recs:
        r["weak_efficiency"] = round(base / r["spmv_ms"], 3)
    with open(OUT, "w") as fh:
        json.dump({"side": args.side, "results": recs,
                   "_validity": "CORRECTNESS artifact only: virtual CPU devices on one host core measure serialization, not ICI scaling (no pod reachable here)"}, fh, indent=1)
    print(f"# weak-scaling efficiency at {recs[-1]['devices']} devices: "
          f"{recs[-1]['weak_efficiency']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
