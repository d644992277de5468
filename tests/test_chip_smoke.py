"""chip_smoke.py: refuses to run without a GPU, and each phase rehearsed on
the CPU at a tiny size through its importable phase function."""

import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def logs(smoke, tmp_path, monkeypatch):
    monkeypatch.setattr(smoke, "LOG_DIR", str(tmp_path / "logs"))
    # the tiny operators sit below the device-path thresholds
    monkeypatch.setenv("TPUSOLVE_DEVICE_SETUP_MIN_N", "1")
    return tmp_path


def _run(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_exits_nonzero_on_cpu():
    p = _run(os.path.join(ROOT, "chip_smoke.py"), ROOT)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert '"phase": "device"' in p.stdout      # the refusal is reported


def test_exits_nonzero_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run(str(tmp_path / "chip_smoke.py"), tmp_path)
    assert p.returncode != 0
    assert p.stdout == ""


def test_phase_device(smoke):
    assert smoke.phase_device(platform="cpu", cards=8)["ok"]
    rec = smoke.phase_device()                 # wants a GPU
    assert not rec["ok"] and rec["platform"] == "cpu"


@pytest.mark.parametrize("cards", [1, 8])
def test_phase_spmv(smoke, cards):
    rec = smoke.phase_spmv(side_dia=8, side_graph=32, cards=cards)
    assert rec["ok"], rec
    layouts = {k: c.get("layout") for k, c in rec["checks"].items()}
    assert layouts["dia_float64"] == "dia"
    if cards == 1:
        assert layouts["bdia_float32"] == "bdia"
        assert layouts["ell_float32"] == "ell"
        assert rec["checks"]["bell_kernel_float64"]["err"] <= 1e-12


def test_phase_amg(smoke, logs):
    rec = smoke.phase_amg(side=12, exti_side=10)
    assert rec["ok"], rec
    for chk in rec["checks"].values():
        assert chk["device_path"] and chk["levels"] == chk["host_levels"]
        assert chk["p0_rel_fro"] <= smoke.AMG_TOL


@pytest.mark.parametrize("precision", ["single", "double"])
def test_phase_cli_stencil(smoke, logs, precision):
    rec = smoke.phase_cli_stencil(side=8, precision=precision)
    assert rec["ok"], rec
    assert rec["iters"] and rec["device_setup"]


def test_phase_gate3(smoke, logs):
    rec = smoke.phase_gate3(side=10)
    assert rec["ok"], rec
    assert rec["layout"] in ("bdia", "bell", "ell")


def test_phase_gate4(smoke, logs):
    rec = smoke.phase_gate4(side=8)
    assert rec["ok"], rec
    assert len(rec["iters"]) == 3


def test_phase_chip_tests_skip_on_cpu(smoke):
    rec = smoke.phase_chip_tests(platforms="cpu")
    assert rec["exit"] == 0, rec["tail"]
    assert rec["counts"].get("skipped", 0) >= 1
    assert not rec["counts"].get("failed")
    assert not rec["ok"]                       # skipped is not passed
