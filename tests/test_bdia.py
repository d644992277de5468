"""BDIA (blocked-DIA) unstructured SpMV fast path.

The banded-after-RCM shape of the reference's file-loaded nalu-wind
systems (readers ref: src/HypreSystem.cpp:1021-1969); kernel selection is
the analog of the vendor-SpMV toggle (ref: src/main.cpp:137-145).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp

from tpusolve.matrix.sharded import ShardedMatrix
from tpusolve.matrix.spmv import spmv
from tpusolve.matrix.vectors import to_device_vector, from_device_vector
from tpusolve.kernels import bdia


def _banded(rng, n, bw=40, per_row=9):
    """Random banded matrix with per-row drifting offsets — DIA-ineligible
    globally, BDIA-friendly locally (the post-RCM shape)."""
    rows = np.repeat(np.arange(n, dtype=np.int64), per_row)
    jitter = rng.integers(-bw, bw + 1, size=n * per_row)
    cols = np.clip(rows + jitter, 0, n - 1)
    vals = rng.standard_normal(n * per_row)
    rows = np.concatenate([rows, np.arange(n)])
    cols = np.concatenate([cols, np.arange(n)])
    vals = np.concatenate([vals, np.full(n, 4.0 * per_row)])
    key = rows * n + cols
    _, idx = np.unique(key, return_index=True)
    return rows[idx], cols[idx], vals[idx]


class TestBdiaKernel:
    def test_plan_and_roundtrip(self, rng):
        n = 1100
        r, c, v = _banded(rng, n, bw=25)
        R = 128
        D = bdia.plan_d(r, c, n, n, R)
        assert D >= 1
        starts, flat_idx, vo = bdia.compact(r, c, v, n, n, R, D,
                                            dtype=np.float64)
        B = (n + R - 1) // R
        vals = np.zeros(B * D * R, np.float64)
        vals[flat_idx] = vo
        vals = vals.reshape(B, D, R)
        lo = int(min(0, starts.min()))
        xpad = -lo
        xlen = xpad + int(max(n, starts.max() + R))
        starts_adj = (starts + xpad).astype(np.int32)
        x = rng.standard_normal(n)
        y = np.asarray(bdia.bdia_spmv_local(
            jnp.asarray(vals), jnp.asarray(starts_adj), jnp.asarray(x),
            xpad, xlen, n))
        A = sp.coo_matrix((v, (r, c)), shape=(n, n))
        np.testing.assert_allclose(y[:n], A @ x, rtol=1e-10, atol=1e-10)

    def test_dmax_too_small_raises(self, rng):
        n = 256
        r, c, v = _banded(rng, n, bw=30)
        with pytest.raises(ValueError):
            bdia.compact(r, c, v, n, n, 64, 1)

    def test_fill_profile_and_overflow_roundtrip(self, rng):
        """plan_fill_profile predicts exactly how many entries a D cap
        spills, and compact(overflow=True) reproduces the full matrix as
        (layout entries) + (overflow entries)."""
        n = 1024
        r, c, v = _banded(rng, n, bw=35)
        R = 128
        prof = bdia.plan_fill_profile(r, c, n, n, R)
        assert prof.sum() == r.size
        Dfull = len(prof)
        D = max(1, Dfull // 2)
        expected_spill = int(prof[D:].sum())
        starts, flat_idx, vo, o_r, o_c, o_v = bdia.compact(
            r, c, v, n, n, R, D, dtype=np.float64, overflow=True)
        assert o_r.size == expected_spill
        assert flat_idx.size + o_r.size == r.size
        # reconstruct: layout entries + overflow entries == original
        B = (n + R - 1) // R
        vals = np.zeros(B * D * R, np.float64)
        vals[flat_idx] = vo
        vals = vals.reshape(B, D, R)
        b_i, d_i, r_i = np.nonzero(vals)
        lr = b_i * R + r_i
        lc = starts[b_i, d_i] + r_i
        A_lay = sp.coo_matrix((vals[b_i, d_i, r_i], (lr, lc)), shape=(n, n))
        A_ovf = sp.coo_matrix((o_v, (o_r, o_c)), shape=(n, n))
        A_ref = sp.coo_matrix((v, (r, c)), shape=(n, n))
        diff = abs((A_lay + A_ovf) - A_ref)
        assert (diff.max() if diff.nnz else 0.0) < 1e-14

    def test_overflow_spmv_matches_scipy(self, rng, mesh8):
        """A clipped boundary cluster (the fan-out case _clustered avoids)
        selects BDIA with an overflow list and still matches scipy."""
        n = 160_000
        rr_ = np.arange(n, dtype=np.int64)
        rows, cols = [], []
        for base in (-600, 0, 600):
            for dd in (-1, 0, 1):
                # CLIP at the boundary: the first/last blocks fan out to
                # ~|base| distinct offsets — the overflow-list scenario
                cc = np.clip(rr_ + base + dd, 0, n - 1)
                rows.append(rr_)
                cols.append(cc)
        rows = np.concatenate(rows + [rr_])
        cols = np.concatenate(cols + [rr_])
        vals = rng.standard_normal(rows.size)
        key = rows * n + cols
        _, idx = np.unique(key, return_index=True)
        rows, cols, vals = rows[idx], cols[idx], vals[idx]
        A = ShardedMatrix.from_coo(mesh8, (n, n), rows, cols, vals,
                                   dtype=np.float64, allow_dia=False,
                                   allow_bell=False)
        assert A.uses_bdia
        assert A.bdia_ovf_vals is not None, \
            "clipped boundary blocks should spill to the overflow list"
        S = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
        x = rng.standard_normal(n)
        xd = to_device_vector(mesh8, x, np.asarray(A.col_offsets),
                              A.col_pad, dtype=np.float64)
        y = from_device_vector(np.asarray(spmv(A, xd)),
                               np.asarray(A.row_offsets), A.row_pad)
        np.testing.assert_allclose(y, S @ x, rtol=1e-10, atol=1e-8)
        back = A.to_scipy()
        assert abs(back - S).max() < 1e-12


def _clustered(rng, n, centers=(-700, 0, 700), spread=1, drift_amp=40):
    """Mesh-like banded matrix: a few offset clusters whose centers drift
    slowly — the genuinely BDIA-friendly (post-RCM) shape.  Uniform-jitter
    bands are intrinsically scattered and correctly select BELL instead."""
    rr = np.arange(n, dtype=np.int64)
    drift = (drift_amp * np.sin(rr / (n / 6.0))).astype(np.int64)
    rows, cols = [], []
    for base in centers:
        for dd in range(-spread, spread + 1):
            c = rr + base + drift + dd
            ok = (c >= 0) & (c < n)   # drop, don't clip: clipping fans a
            rows.append(rr[ok])       # boundary block out to ~|base|
            cols.append(c[ok])        # distinct offsets
    rows = np.concatenate(rows + [rr])
    cols = np.concatenate(cols + [rr])
    vals = rng.standard_normal(rows.size)
    key = rows * n + cols
    _, idx = np.unique(key, return_index=True)
    return rows[idx], cols[idx], vals[idx]


class TestBdiaSharded:
    def test_selected_for_banded_and_matches_scipy(self, rng, mesh8):
        n = 160_000   # above BELL_MIN_NNZ
        r, c, v = _clustered(rng, n)
        A = ShardedMatrix.from_coo(mesh8, (n, n), r, c, v,
                                   dtype=np.float64, allow_dia=False)
        assert A.uses_bdia, \
            "clustered band: BDIA streams fewer bytes than BELL and ELL"
        S = sp.csr_matrix((v, (r, c)), shape=(n, n))
        x = rng.standard_normal(n)
        xd = to_device_vector(mesh8, x, np.asarray(A.col_offsets),
                              A.col_pad, dtype=np.float64)
        y = from_device_vector(np.asarray(spmv(A, xd)),
                               np.asarray(A.row_offsets), A.row_pad)
        np.testing.assert_allclose(y, S @ x, rtol=1e-10, atol=1e-8)

    def test_to_scipy_roundtrip(self, rng, mesh8):
        n = 60_000
        r, c, v = _clustered(rng, n, centers=(-300, 0, 300))
        A = ShardedMatrix.from_coo(mesh8, (n, n), r, c, v,
                                   dtype=np.float64, allow_dia=False,
                                   allow_bell=False)
        assert A.uses_bdia
        S = sp.csr_matrix((v, (r, c)), shape=(n, n))
        back = A.to_scipy()
        diff = abs(back - S)
        assert diff.max() < 1e-12

    def test_disabled_falls_back(self, rng, mesh8):
        n = 60_000
        r, c, v = _banded(rng, n, bw=30, per_row=6)
        A = ShardedMatrix.from_coo(mesh8, (n, n), r, c, v,
                                   dtype=np.float64, allow_dia=False,
                                   allow_bdia=False)
        assert not A.uses_bdia
