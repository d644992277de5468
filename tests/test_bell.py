"""Block-ELL (BELL) unstructured SpMV fast path.

The role the reference fills with vendor SpMV on file-loaded (unstructured)
systems (ref: src/main.cpp:137-145; readers src/HypreSystem.cpp:1021-1969).
The fixtures fill whole (8, 128) tiles, where BELL streams fewer bytes
than padded ELL and BDIA and so is the layout the selector takes.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp

from tpusolve.matrix.sharded import ShardedMatrix, BELL_MIN_NNZ
from tpusolve.matrix.spmv import spmv
from tpusolve.matrix.vectors import to_device_vector, from_device_vector
from tpusolve.kernels import bell


def _dense_tiles(rng, n):
    """Dense diagonal 128 x 128 blocks: DIA-ineligible (255 offsets), and
    where the shards start on a block boundary every (8, 128) tile is full,
    which makes BELL the layout that streams the fewest bytes."""
    rows = np.repeat(np.arange(n, dtype=np.int64), bell.TN)
    cols = rows // bell.TN * bell.TN + np.tile(np.arange(bell.TN), n)
    keep = cols < n
    rows, cols = rows[keep], cols[keep]
    return rows, cols, rng.standard_normal(rows.size)


# uneven row count on one device (a padded 8-row group); on eight devices
# 4096 rows keep each shard's start on a tile boundary
N_FOR = {"mesh1": 4003, "mesh8": 4096}


class TestBellKernel:
    def test_assembly_roundtrip(self, rng):
        n, m = 613, 517
        lr = rng.integers(0, n, 4000)
        lc = rng.integers(0, m, 4000)
        v = rng.standard_normal(4000)
        key = lr * m + lc
        _, idx = np.unique(key, return_index=True)
        lr, lc, v = lr[idx], lc[idx], v[idx]
        k = bell.bell_plan_k(lr, lc, n)
        vals, ids = bell.bell_from_entries(lr, lc, v, n, m, k,
                                           dtype=np.float64)
        assert vals.shape[:2] == (bell._ngroups(n), k)
        A = sp.coo_matrix((v, (lr, lc)), shape=(n, m)).toarray()
        x = rng.standard_normal(m)
        nwin = (m + bell.TN - 1) // bell.TN
        y = np.asarray(bell.bell_spmv_local(
            jnp.asarray(vals), jnp.asarray(ids), jnp.asarray(x), nwin, n))
        np.testing.assert_allclose(y[:n], A @ x, rtol=1e-10, atol=1e-10)


class TestBellSharded:
    @pytest.mark.parametrize("nparts_fixture", ["mesh1", "mesh8"])
    def test_spmv_matches_scipy(self, request, rng, nparts_fixture):
        mesh = request.getfixturevalue(nparts_fixture)
        n = N_FOR[nparts_fixture]
        rows, cols, vals = _dense_tiles(rng, n)
        assert rows.size >= BELL_MIN_NNZ
        A = ShardedMatrix.from_coo(mesh, (n, n), rows, cols, vals,
                                   dtype=np.float64, allow_bdia=False)
        assert A.uses_bell and not A.uses_dia
        As = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        x = rng.standard_normal(n)
        xd = to_device_vector(mesh, x, A.col_offsets, A.col_pad,
                              dtype=np.float64)
        y = from_device_vector(spmv(A, xd), A.row_offsets, A.row_pad)
        np.testing.assert_allclose(y, As @ x, rtol=1e-10, atol=1e-10)

    def test_to_scipy_roundtrip(self, rng, mesh8):
        n = N_FOR["mesh8"]
        rows, cols, vals = _dense_tiles(rng, n)
        A = ShardedMatrix.from_coo(mesh8, (n, n), rows, cols, vals,
                                   dtype=np.float64, allow_bdia=False)
        assert A.uses_bell
        As = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).toarray()
        np.testing.assert_allclose(A.to_scipy().toarray(), As,
                                   rtol=1e-12, atol=1e-12)

    def test_astype_casts_bell(self, rng, mesh8):
        n = N_FOR["mesh8"]
        rows, cols, vals = _dense_tiles(rng, n)
        A = ShardedMatrix.from_coo(mesh8, (n, n), rows, cols, vals,
                                   dtype=np.float64, allow_bdia=False)
        A32 = A.astype(np.float32)
        assert A32.uses_bell and A32.bell_vals.dtype == np.float32

    def test_allow_bell_false_falls_back_to_ell(self, rng, mesh8):
        n = 4003
        rows, cols, vals = _dense_tiles(rng, n)
        A = ShardedMatrix.from_coo(mesh8, (n, n), rows, cols, vals,
                                   dtype=np.float64, allow_bell=False,
                                   allow_bdia=False)
        assert not A.uses_bell and A.layout == "ell"
        As = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
        x = rng.standard_normal(n)
        xd = to_device_vector(mesh8, x, A.col_offsets, A.col_pad,
                              dtype=np.float64)
        y = from_device_vector(spmv(A, xd), A.row_offsets, A.row_pad)
        np.testing.assert_allclose(y, As @ x, rtol=1e-10, atol=1e-10)
