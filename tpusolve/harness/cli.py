"""CLI driver — the main() of the rebuild.

Mirrors the reference driver (src/main.cpp:31-229)::

    python -m tpusolve INPUT.yaml

Lifecycle per test (src/main.cpp:164-192): construct -> setup solver ->
load -> solve -> check -> output -> timers, repeated ``num_tests`` times
with deterministic seeding (the analog of
``hypre_ResetDeviceRandGenerator(1234, 0)``, src/main.cpp:169), with an
optional cross-test CSV profile (``csv_profile_file``, src/main.cpp:195-216).

Where the reference binds one GPU per MPI rank (src/main.cpp:9-29), here the
device mesh spans all addressable devices of the JAX process.
"""

from __future__ import annotations

import sys
import time

import numpy as np


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("ERROR!! Usage: python -m tpusolve INPUT_FILE", file=sys.stderr)
        return 1

    from tpusolve.config import load_config
    cfg = load_config(argv[0])

    import jax
    if cfg.solver.precision in ("double", "mixed"):
        # mixed runs its refinement residuals in f64
        jax.config.update("jax_enable_x64", True)
    # persistent XLA compilation cache: repeat runs skip the compile phase
    from tpusolve.runtime import enable_compile_cache
    enable_compile_cache(cfg.solver.extra.get("compilation_cache_dir"))

    from tpusolve.mesh import make_mesh, init_distributed
    from tpusolve.harness.system import LinearSystem
    from tpusolve.timers import CsvProfile

    # multi-host pods: one process per host, coordinator from env (the
    # reference's MPI_Init analog, src/main.cpp:33-35)
    multi = init_distributed()
    mesh = make_mesh()
    ndev = mesh.devices.size
    print(f"tpusolve: {ndev} device(s)"
          + (f" across {jax.process_count()} hosts" if multi else "")
          + f": {[str(d) for d in mesh.devices.ravel()][:8]}", flush=True)

    # device-memory probe at lifecycle boundaries (ref checkMemory,
    # src/HypreSystem.cpp:638-671) and optional profiler trace
    from tpusolve.harness.memory import check_memory
    probe_memory = bool(cfg.solver.extra.get("check_memory", False))
    trace_dir = cfg.solver.extra.get("profile_trace_dir")
    if trace_dir:
        jax.profiler.start_trace(str(trace_dir))

    num_tests = cfg.solver.num_tests
    profile = CsvProfile()
    ok = True
    # reuse_preconditioner (ref yaml surface, etc/hypre_app.yaml:21): one
    # shared cache across the test loop; the first test builds, later tests
    # reuse the preconditioner/solver pair
    reuse_cache = {} if cfg.solver.reuse_preconditioner else None
    t_start = time.perf_counter()
    for test in range(num_tests):
        if num_tests > 1:
            print(f"\n=== test {test + 1}/{num_tests} ===", flush=True)
        # deterministic per-test seeding (ref: src/main.cpp:169)
        np.random.seed(1234)
        sys_ = LinearSystem(mesh, cfg, reuse_cache=reuse_cache)
        sys_.setup_precon_and_solver()
        sys_.load()
        if probe_memory:
            check_memory()
        sys_.solve()
        if probe_memory:
            check_memory()
        ok &= sys_.check_solution()
        sys_.output_linear_system()
        sys_.summarize_timers()
        sys_.retrieve_timers(profile)
        sys_.destroy_system()

    if trace_dir:
        jax.profiler.stop_trace()
        print(f"Wrote profiler trace: {trace_dir}")
    total = time.perf_counter() - t_start
    print(f"\nTotal time: {total:.6f} s", flush=True)
    if cfg.solver.csv_profile_file:
        profile.write(cfg.solver.csv_profile_file)
        print(f"Wrote CSV profile: {cfg.solver.csv_profile_file}")
    return 0 if ok else 2


if __name__ == "__main__":
    sys.exit(main())
