"""Driver-contract tests: bench.py refuses to report without a GPU; the
graft entry points compile and run on the virtual multi-device mesh, and
never fall back to the CPU for a backend with too few devices."""

import importlib.util
import pytest
import jax


def test_bench_refuses_without_gpu(capsys):
    # the headline is a device bandwidth: on the CPU there is no peak on
    # record, so bench.py prints no result and exits non-zero
    spec = importlib.util.spec_from_file_location("bench", "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    rc = bench.main([])
    out, err = capsys.readouterr()
    assert rc != 0
    assert out == ""
    assert "no peak bandwidth on record" in err
    with pytest.raises(ValueError):
        bench.peak_hbm_gbps("cpu")
    assert bench.peak_hbm_gbps("NVIDIA H100 80GB HBM3") == 3350.0


def test_graft_entry_and_dryrun():
    spec = importlib.util.spec_from_file_location("graft", "__graft_entry__.py")
    graft = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(graft)
    # multi-chip dry run on the 8-device virtual mesh
    graft.dryrun_multichip(8)
    # single-chip jittable forward step
    fn, args = graft.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    x, iters, relres = out
    assert int(iters) > 0
    assert float(relres) < 1e-5
    # more devices than the live backend has: an error, not a CPU rerun
    with pytest.raises(RuntimeError, match="needs 16 devices"):
        graft.dryrun_multichip(16)
