"""True multi-process run: sharded ingestion -> AMG setup -> solve.

Launches TWO OS processes joined via ``jax.distributed`` (CPU backend,
4 virtual devices each -> one 8-device global mesh), runs the CLI on a
file-loaded system with a BoomerAMG preconditioner, and requires the
golden check to PASS in both.  This exercises the per-host ``row_range``
ingestion filter plus the cross-process A_host allgather that feeds the
algebraic setup (the reference's per-rank reads feeding a distributed
assembly, src/HypreSystem.cpp:1203-1236, 600-636; VERDICT r2 missing #2).
"""

import os
import socket
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

YAML = """\
linear_system:
  type: matrix_market
  matrix_file: {mat}
  rhs_file: {rhs}
  sln_file: {sln}
solver_settings:
  method: gmres
  preconditioner: boomeramg
  tolerance: 1.0e-8
  max_iterations: 200
  kspace: 20
boomeramg_settings:
  coarsen_type: 8
  interp_type: 6
  strong_threshold: 0.25
  max_coarse_size: 64
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_ingest_amg_solve(tmp_path):
    import gatefix
    m, r, s, n = gatefix.write_pressure_mm(str(tmp_path), 10, 10, 10)
    y = tmp_path / "run.yaml"
    y.write_text(YAML.format(mat=m, rhs=r, sln=s))

    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        pp = [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
        env.update({
            "JAX_PLATFORMS": "cpu",
            "XLA_FLAGS": (env.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4"),
            "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
            "JAX_NUM_PROCESSES": "2",
            "JAX_PROCESS_ID": str(pid),
            "PYTHONPATH": os.pathsep.join([ROOT] + pp),
            # each process gets its own compile cache dir (no write races)
            "JAX_COMPILATION_CACHE_DIR": str(tmp_path / f"cache{pid}"),
        })
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "tpusolve", str(y)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env))
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=540)
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid}:\n{out[-2000:]}"
        assert "Check solution: PASSED" in out, f"proc {pid}:\n{out[-2000:]}"
    # both processes saw the full 8-device mesh
    assert "8 device(s) across 2 hosts" in outs[0], outs[0][:400]
