"""Assembly-time layout selection: BDIA, BELL and padded ELL are ranked by
the bytes one SpMV streams, computed from their shapes — the same decision
on every backend and for every dtype (the analog of the reference's
vendor-SpMV toggles, src/main.cpp:127-156)."""

import numpy as np
import pytest

from tpusolve.kernels import bdia, bell
from tpusolve.matrix.sharded import ShardedMatrix, BELL_MIN_NNZ
from tests.test_bdia import _banded, _clustered

DTYPES = [np.float32, np.float64]


@pytest.mark.parametrize("dtype", DTYPES)
def test_clustered_band_selects_bdia(rng, mesh8, dtype):
    n = 160_000
    r, c, v = _clustered(rng, n)
    A = ShardedMatrix.from_coo(mesh8, (n, n), r, c, v, dtype=dtype,
                               allow_dia=False)
    assert A.layout == "bdia"
    assert A.bdia_vals.dtype == dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_scattered_band_selects_ell(rng, mesh8, dtype):
    # uniform jitter over +-30: every R-row block needs ~60 offset slots
    # and every 8-row group several sparse tiles, so the padded ELL rows
    # stream the fewest bytes
    n = 60_000
    r, c, v = _banded(rng, n, bw=30, per_row=6)
    A = ShardedMatrix.from_coo(mesh8, (n, n), r, c, v, dtype=dtype,
                               allow_dia=False)
    assert A.layout == "ell"


@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_tiles_select_bell(mesh1, dtype):
    # each 8-row group fills one whole 128-column window: full tiles
    # stream fewer bytes than ELL's values+columns+gathered x, and the
    # window's 128+ distinct offsets defeat BDIA
    n = 4096
    rows = np.repeat(np.arange(n, dtype=np.int64), bell.TN)
    win = (rows // bell.TM) % (n // bell.TN)
    cols = win * bell.TN + np.tile(np.arange(bell.TN), n)
    vals = np.random.default_rng(0).standard_normal(rows.size)
    assert rows.size >= BELL_MIN_NNZ
    A = ShardedMatrix.from_coo(mesh1, (n, n), rows, cols, vals,
                               dtype=dtype, allow_dia=False)
    assert A.layout == "bell"


def test_tile_budget_falls_back_to_ell(mesh1, monkeypatch):
    # full tiles would win on bytes, but not past the tile memory budget
    from tpusolve.matrix import sharded
    monkeypatch.setattr(sharded, "BELL_MAX_BYTES", 1 << 20)
    n = 4096
    rows = np.repeat(np.arange(n, dtype=np.int64), bell.TN)
    cols = ((rows // bell.TM) % (n // bell.TN)) * bell.TN + \
        np.tile(np.arange(bell.TN), n)
    vals = np.ones(rows.size)
    A = ShardedMatrix.from_coo(mesh1, (n, n), rows, cols, vals,
                               dtype=np.float32, allow_dia=False,
                               allow_bdia=False)
    assert A.layout == "ell"


def test_streamed_bytes_counts_windows_and_overflow():
    B, D, R = 10, 7, 256
    for itemsize in (4, 8):
        base = bdia.streamed_bytes(B, D, R, itemsize)
        assert base == 2 * B * D * R * itemsize + 4 * B * D
        assert bdia.streamed_bytes(B, D, R, itemsize, k_ovf=5) == \
            base + 5 * (8 + 2 * itemsize)
