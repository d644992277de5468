"""Nalu-wind-shaped file-system fixtures for the gate-3/4 bench runs.

The reference loads its pressure/momentum systems from MatrixMarket or
HYPRE-IJ dumps of nalu-wind runs (readers: src/HypreSystem.cpp:1613-1969,
1021-1318).  Those dumps are 27-pt-stencil finite-volume operators on
unstructured node numberings: banded *after* reordering, scattered as
stored.  This module writes equivalently-shaped synthetic systems:

* pressure (gate 3): SPD jittered-coefficient 27-pt Laplacian under a
  random node permutation; GMRES+BoomerAMG, rtol 1e-8.
* momentum (gate 4): the same graph with a first-order upwind convection
  term (non-symmetric, diagonally dominant) under a permutation;
  BiCGSTAB+ILU, precision mixed.

Both carry ``b = A @ 1`` so the CLI golden check (x_ref = 1) applies
(ref check: src/HypreSystem.cpp:771-845).
"""

from __future__ import annotations

import os

import numpy as np

import tpusolve  # noqa: F401  (allocator/THP tuning before big buffers)


def _box_27pt_graph(nx: int, ny: int, nz: int):
    """COO pattern of the 27-pt stencil on an nx*ny*nz box (int64)."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix = idx % nx
    iy = (idx // nx) % ny
    iz = idx // (nx * ny)
    rows, cols, kinds = [], [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                jx, jy, jz = ix + dx, iy + dy, iz + dz
                ok = ((jx >= 0) & (jx < nx) & (jy >= 0) & (jy < ny)
                      & (jz >= 0) & (jz < nz))
                rows.append(idx[ok])
                cols.append((jx + nx * (jy + ny * jz))[ok])
                kinds.append(np.full(int(ok.sum()), dx, np.int8))
    return (np.concatenate(rows), np.concatenate(cols),
            np.concatenate(kinds), n)


def clustered_band(n: int, seed: int = 11):
    """(rows, cols, vals) of an n x n clustered-band graph: 7 offset
    clusters (-n^(2/3), -n^(1/3), -1, 0, 1, n^(1/3), n^(2/3) for a cube
    side n^(1/3)), each 3 wide, drifting slowly with the row — a
    DIA-ineligible, RCM-like profile (the shape of a reordered file-loaded
    mesh system).  Values are standard normal."""
    side = round(n ** (1.0 / 3.0))
    rng = np.random.default_rng(seed)
    rr = np.arange(n, dtype=np.int64)
    drift = (60 * np.sin(rr / (n / 8.0))).astype(np.int64)
    rows, cols = [], []
    for base in (-side * side, -side, -1, 0, 1, side, side * side):
        for dd in (-1, 0, 1):
            c = rr + base + drift + dd
            ok = (c >= 0) & (c < n)
            rows.append(rr[ok])
            cols.append(c[ok])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    vals = rng.standard_normal(rows.size)
    _, idx = np.unique(rows * n + cols, return_index=True)
    return rows[idx], cols[idx], vals[idx]


def make_system(nx: int = 64, ny: int = 64, nz: int = 64, *,
                seed: int = 7, nonsym: float = 0.0, permute: bool = True):
    """(rows, cols, vals, b, n) with b = A @ 1 and x_ref = 1.

    ``nonsym > 0`` adds an upwind convection skew of that relative
    magnitude on the +/-x couplings (momentum-equation shape).
    """
    rows, cols, dxk, n = _box_27pt_graph(nx, ny, nz)
    rng = np.random.default_rng(seed)
    off = rows != cols
    # jittered FV coefficients in [-1.2, -0.8], keyed on the undirected
    # edge so the base operator is symmetric (pressure Poisson is SPD)
    ekey = (np.minimum(rows, cols) * np.int64(n)
            + np.maximum(rows, cols)).astype(np.uint64)
    ekey = (ekey ^ np.uint64(seed)) * np.uint64(0x9E3779B97F4A7C15)
    ekey ^= ekey >> np.uint64(31)
    ekey *= np.uint64(0xBF58476D1CE4E5B9)
    u = (ekey >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    vals = np.where(off, -(1.0 + 0.4 * (u - 0.5)), 0.0)
    if nonsym:
        # upwind convection along +x: strengthens the -x coupling,
        # weakens +x (keeps row-sum dominance via the diagonal below)
        vals = vals * (1.0 + nonsym * dxk)
    # diagonal = |row sum of off-diag| * (1 + eps): strictly dominant SPD
    # (or M-matrix-like when nonsym) — AMG/ILU-friendly like the FV originals
    dsum = np.zeros(n)
    np.add.at(dsum, rows, -vals)
    dom = 1.0 + 0.02 * rng.random(n)
    diag_rows = rows[~off]
    vals[~off] = (dsum * dom)[diag_rows]
    if permute:
        p = rng.permutation(n).astype(np.int64)
        rows, cols = p[rows], p[cols]
    b = np.zeros(n)
    np.add.at(b, rows, vals)     # b = A @ ones
    return rows, cols, vals, b, n


def write_pressure_mm(dirpath: str, nx: int = 64, ny: int = 64,
                      nz: int = 64, seed: int = 7):
    """Gate-3 pressure fixture as MatrixMarket files; returns the paths."""
    from tpusolve.formats import mmio
    os.makedirs(dirpath, exist_ok=True)
    rows, cols, vals, b, n = make_system(nx, ny, nz, seed=seed)
    mpath = os.path.join(dirpath, "pressure.mm")
    rpath = os.path.join(dirpath, "pressure_rhs.mm")
    spath = os.path.join(dirpath, "pressure_sln.mm")
    mmio.write_matrix(mpath, rows, cols, vals, (n, n),
                      comment="gate-3 pressure fixture (tools/gatefix.py)")
    mmio.write_vector(rpath, b)
    mmio.write_vector(spath, np.ones(n))
    return mpath, rpath, spath, n


def write_momentum_ij(dirpath: str, nx: int = 48, ny: int = 48,
                      nz: int = 48, seed: int = 11, nfiles: int = 2,
                      ncomp: int = 1):
    """Gate-4 momentum fixture as HYPRE-IJ multi-file dumps.

    ``ncomp=3`` writes per-component rhs/sln files (x/y/z momentum — the
    reference's segregated multi-RHS path, src/HypreSystem.cpp:1636-1645):
    component k solves against a distinct smooth reference field."""
    import scipy.sparse as sp
    from tpusolve.formats import ij
    from tpusolve.mesh import row_decomposition
    os.makedirs(dirpath, exist_ok=True)
    rows, cols, vals, b, n = make_system(nx, ny, nz, seed=seed,
                                         nonsym=0.35)
    offsets = row_decomposition(n, nfiles)
    mprefix = os.path.join(dirpath, "momentum.IJ.mat")
    order = np.argsort(rows, kind="stable")
    ij.write_matrix(mprefix, rows[order], cols[order], vals[order],
                    offsets, ncols=n)
    if ncomp == 1:
        rprefix = os.path.join(dirpath, "momentum_rhs.IJ.vec")
        sprefix = os.path.join(dirpath, "momentum_sln.IJ.vec")
        ij.write_vector(rprefix, b, offsets)
        ij.write_vector(sprefix, np.ones(n), offsets)
        return mprefix, rprefix, sprefix, n
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    rpres, spres = [], []
    idx = np.arange(n)
    for k in range(ncomp):
        # distinct smooth reference per component (constant + low-freq)
        xk = 1.0 + 0.25 * np.sin(2 * np.pi * (k + 1) * idx / n)
        rp = os.path.join(dirpath, f"momentum_rhs{k}.IJ.vec")
        sps = os.path.join(dirpath, f"momentum_sln{k}.IJ.vec")
        ij.write_vector(rp, A @ xk, offsets)
        ij.write_vector(sps, xk, offsets)
        rpres.append(rp)
        spres.append(sps)
    return mprefix, rpres, spres, n


GATE3_YAML = """\
# gate 3: file-loaded pressure system, GMRES + BoomerAMG (BASELINE.json
# config 3; reference readers src/HypreSystem.cpp:1613-1969)
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
  matrix_ordering: rcm
boomeramg_settings:
  coarsen_type: 8
  interp_type: 6
  strong_threshold: 0.25
  relax_type: 18
  max_levels: 20
"""

GATE4_YAML = """\
# gate 4: file-loaded momentum system, BiCGSTAB + ILU, mixed precision
# (BASELINE.json config 4; reference readers src/HypreSystem.cpp:1021-1318)
linear_system:
  type: hypre_ij
  matrix_file: {mat}
  rhs_file: {rhs}
  sln_file: {sln}
  num_partitions: {nfiles}
solver_settings:
  method: bicg
  preconditioner: ilu
  tolerance: 1.0e-8
  max_iterations: 500
  precision: mixed
  matrix_ordering: rcm
ilu_preconditioner_settings:
  ilu_type: 0
  ilu_fill_level: 0
  ilu_lower_jacobi_iters: 5
  ilu_upper_jacobi_iters: 5
"""

GATE4_YAML_3COMP = """\
# gate 4 (3-component): momentum x/y/z as segregated multi-RHS solves
# against one IJ matrix (ref: src/HypreSystem.cpp:1636-1645)
linear_system:
  type: hypre_ij
  matrix_file: {mat}
  num_components: 3
  segregated_solve: yes
  rhs_file0: {rhs0}
  rhs_file1: {rhs1}
  rhs_file2: {rhs2}
  sln_file0: {sln0}
  sln_file1: {sln1}
  sln_file2: {sln2}
  num_partitions: {nfiles}
solver_settings:
  method: bicg
  preconditioner: ilu
  tolerance: 1.0e-8
  max_iterations: 500
  precision: mixed
ilu_preconditioner_settings:
  ilu_type: 0
  ilu_fill_level: 0
  ilu_lower_jacobi_iters: 5
  ilu_upper_jacobi_iters: 5
"""


def prepare(dirpath: str, side3: int = 64, side4: int = 48):
    """Write both fixtures + YAMLs; returns (gate3_yaml, gate4_yaml).
    Gate 4 is the 3-component (x/y/z momentum) segregated form."""
    m3, r3, s3, _ = write_pressure_mm(dirpath, side3, side3, side3)
    m4, r4s, s4s, _ = write_momentum_ij(dirpath, side4, side4, side4,
                                        ncomp=3)
    y3 = os.path.join(dirpath, "gate3.yaml")
    y4 = os.path.join(dirpath, "gate4.yaml")
    with open(y3, "w") as fh:
        fh.write(GATE3_YAML.format(mat=m3, rhs=r3, sln=s3))
    with open(y4, "w") as fh:
        fh.write(GATE4_YAML_3COMP.format(
            mat=m4, rhs0=r4s[0], rhs1=r4s[1], rhs2=r4s[2],
            sln0=s4s[0], sln1=s4s[1], sln2=s4s[2], nfiles=2))
    return y3, y4


if __name__ == "__main__":
    import sys
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/tpusolve_gates"
    print(prepare(out))
