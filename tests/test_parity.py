"""Convergence-parity harness (tools/parity.py): achieved iteration counts
vs RECORDED BoomerAMG expectations (tools/parity_expected.json), per the
north star (BASELINE.md: within 10% of BoomerAMG at matched settings, with
the documented l1-Jacobi smoother delta folded into the budget)."""

import json
import os

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
EXPECTED = os.path.join(HERE, "..", "tools", "parity_expected.json")


def _fixtures():
    with open(EXPECTED) as fh:
        return json.load(fh)["fixtures"]


def _check(fx, mesh):
    from tools.parity import run_fixture
    iters, converged = run_fixture(fx, mesh)
    assert converged
    assert iters <= fx["budget_iters"], (
        f"{fx['name']}: {iters} iters > budget {fx['budget_iters']} "
        f"(recorded BoomerAMG expectation {fx['expected_iters']})")


@pytest.mark.parametrize("fx", [
    pytest.param(fx, marks=pytest.mark.chip) if fx.get("chip") else fx
    for fx in _fixtures()], ids=lambda fx: fx["name"])
def test_parity_fixture(fx, request):
    # >=2M-row fixtures run on one GPU (tools/parity.py --chip), the rest
    # on the 8-device CPU mesh
    if fx.get("chip"):
        _check(fx, request.getfixturevalue("gpu_mesh"))
    else:
        _check(fx, request.getfixturevalue("mesh8"))
