"""ShardedMatrix — the ParCSR-analog distributed sparse format.

HYPRE stores a distributed matrix as a 1-D row-block partition with each
rank holding a *diag* CSR block (columns it owns) and an *offd* CSR block
(ghost columns) plus a communication package for SpMV halo exchange
(consumed by the reference via ``HYPRE_ParCSRMatrix``, ref:
src/HypreSystem.cpp:552-636, 679).

The equivalent here:

* the row dimension is sharded over a 1-D ``jax.sharding.Mesh`` axis;
* each device's **diag block** is stored in one of five layouts chosen at
  assembly (the kernel-selection analog of the reference's vendor-SpMV
  toggles, src/main.cpp:137-145):

  - **DIA (diagonal)** when the block's entries concentrate on few
    (col - row) offsets — true for every mesh/stencil operator.  SpMV is
    then D statically-shifted fused multiply-adds: no gathers, no index
    array to stream.
  - otherwise whichever of **BDIA** (blocked DIA, kernels/bdia.py),
    **BELL** (dense tiles, kernels/bell.py) and **padded-ELL** (every row
    padded to a fixed width; padding entries carry value 0 / column 0)
    streams the fewest bytes per SpMV.

* the **offd block** (ghost columns) stays padded-ELL;
* the halo exchange is a precomputed static plan executed as one
  ``lax.all_to_all`` over the mesh axis per SpMV;
* rows and columns may have different decompositions (rectangular
  operators: AMG interpolation/restriction).

All per-device arrays are stacked along a leading mesh axis of size
``nparts`` and placed with ``NamedSharding(mesh, P(axis))``, so a
``shard_map`` over the same mesh sees exactly one shard each.

Rows are padded per shard to the max shard size (``row_pad``); padded vector
entries are maintained as exact zeros by every kernel in the framework, and
padded diagonal entries are 1, so smoothers and dot products need no masks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from tpusolve.mesh import ROWS_AXIS, row_decomposition
from tpusolve.matrix import coo as coo_mod
from tpusolve.matrix.build import materialize_sharded

# DIA is used when the diag block has at most this many distinct offsets...
DIA_MAX_OFFSETS = 96
# ...and the dense-diagonal storage is at least this full of real entries
DIA_MIN_FILL = 0.2

# Tile layouts (BDIA, BELL) are planned only for diag blocks with at least
# this many entries; smaller blocks take padded ELL without planning.  The
# dense-tile expansion must also stay within a memory budget per shard.
BELL_MIN_NNZ = 20_000
BELL_MAX_BYTES = 4 << 30
# Dense-tile layouts also may not expand the compact nnz bytes by more than
# this factor (plus a small-matrix floor): AMG coarse operators with
# scattered sparsity can otherwise expand 30-60x, which a whole hierarchy
# (or a 256^3-scale level) cannot afford in device memory.
TILE_MAX_EXPANSION = 12.0
TILE_EXPANSION_FLOOR = 256 << 20


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ShardedMatrix:
    # --- device data (leading axis = shard) ---
    diag_vals: jax.Array   # (Pn, R, Kd) float ELL values (minimal if DIA/BELL)
    diag_cols: jax.Array   # (Pn, R, Kd) int32, local col index
    dia_vals: jax.Array | None  # (Pn, D, R) or (Pn, D, *dia_shape)
    bell_vals: jax.Array | None  # (Pn, G, K, 8, 128) dense tiles
    bell_ids: jax.Array | None   # (Pn, G, K) int32 column-window ids
    bdia_vals: jax.Array | None   # (Pn, B, D, R) blocked-DIA rows
    bdia_starts: jax.Array | None  # (Pn, B, D) int32 x-window starts
    offd_vals: jax.Array   # (Pn, R, Ko) float
    offd_cols: jax.Array   # (Pn, R, Ko) int32, ghost slot index
    send_idx: jax.Array    # (Pn, Pn, S) int32, local x-indices sent to peer q
    ghost_slot: jax.Array  # (Pn, G) int32, index into all_to_all recv buffer
    diag: jax.Array        # (Pn, R) main diagonal (1.0 on padded rows); square only
    # --- static metadata ---
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    row_offsets: tuple = dataclasses.field(metadata=dict(static=True))
    col_offsets: tuple = dataclasses.field(metadata=dict(static=True))
    row_pad: int = dataclasses.field(metadata=dict(static=True))
    col_pad: int = dataclasses.field(metadata=dict(static=True))
    dia_offsets: tuple | None = dataclasses.field(metadata=dict(static=True))
    # 2-D view (rows, lanes) of the shard's padded row space for which all
    # DIA offsets are "box-consistent": any slice crossing a lane boundary
    # lands only on zero coefficients.  Enables the lane-aligned static-slice
    # SpMV; None -> 1-D slicing.
    dia_shape: tuple | None = dataclasses.field(metadata=dict(static=True))
    bell_nwin: int | None = dataclasses.field(metadata=dict(static=True))
    bdia_block: int | None = dataclasses.field(metadata=dict(static=True))
    bdia_xpad: int | None = dataclasses.field(metadata=dict(static=True))
    bdia_xlen: int | None = dataclasses.field(metadata=dict(static=True))
    has_offd: bool = dataclasses.field(metadata=dict(static=True))
    mesh: jax.sharding.Mesh = dataclasses.field(metadata=dict(static=True))
    axis: str = dataclasses.field(metadata=dict(static=True))
    nnz: int = dataclasses.field(metadata=dict(static=True))
    # --- BDIA per-block overflow lists: entries spilled when a block has
    # more distinct offsets than the chosen D (e.g. a clipped boundary
    # block) — applied as one small gather + scatter-add per SpMV.  Padded
    # shard-uniform; padding rows point past row_pad (dropped on scatter).
    bdia_ovf_rows: jax.Array | None = None  # (Pn, k) int32 local rows
    bdia_ovf_cols: jax.Array | None = None  # (Pn, k) int32 local cols
    bdia_ovf_vals: jax.Array | None = None  # (Pn, k) dtype

    # ------------------------------------------------------------------
    @property
    def nparts(self) -> int:
        return len(self.row_offsets) - 1

    @property
    def padded_nrows(self) -> int:
        return self.nparts * self.row_pad

    @property
    def padded_ncols(self) -> int:
        return self.nparts * self.col_pad

    @property
    def dtype(self):
        return self.diag_vals.dtype

    @property
    def is_square(self) -> bool:
        return self.shape[0] == self.shape[1] and self.row_offsets == self.col_offsets

    @property
    def uses_dia(self) -> bool:
        return self.dia_offsets is not None

    @property
    def uses_bell(self) -> bool:
        return self.bell_vals is not None

    @property
    def uses_bdia(self) -> bool:
        return self.bdia_vals is not None

    @property
    def layout(self) -> str:
        """Name of the diag-block layout: dia, bdia, bell or ell."""
        return ("dia" if self.uses_dia else "bdia" if self.uses_bdia
                else "bell" if self.uses_bell else "ell")

    # ------------------------------------------------------------------
    @staticmethod
    def from_coo(mesh, shape, rows, cols, vals, *, dtype=None, dedup="add",
                 row_offsets=None, col_offsets=None, axis: str = ROWS_AXIS,
                 ell_align: int = 1, allow_dia: bool = True,
                 allow_bell: bool = True, allow_bdia: bool = True,
                 dia_shape=None):
        """Assemble a global COO into the sharded format.

        Implements the full IJ ``SetValues/AddToValues + Assemble`` pipeline
        (ref: src/HypreSystem.cpp:600-636, 897-955): entries for any global
        (row, col) in any order, duplicates combined per ``dedup``.
        """
        nrows, ncols = shape
        nparts = mesh.devices.size
        if row_offsets is None:
            row_offsets = row_decomposition(nrows, nparts)
        row_offsets = np.asarray(row_offsets, np.int64)
        if col_offsets is None:
            col_offsets = (row_offsets if ncols == nrows
                           else row_decomposition(ncols, nparts))
        col_offsets = np.asarray(col_offsets, np.int64)

        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals)
        if rows.size and (rows.min() < 0 or rows.max() >= nrows):
            raise ValueError("row index out of range")
        if cols.size and (cols.min() < 0 or cols.max() >= ncols):
            raise ValueError("col index out of range")
        r, c, v = coo_mod.dedup_coo(rows, cols, vals, mode=dedup)
        parts = coo_mod.bucket_by_owner(r, c, v, row_offsets)
        return ShardedMatrix.from_local_parts(
            mesh, shape, parts, dtype=dtype, row_offsets=row_offsets,
            col_offsets=col_offsets, axis=axis, ell_align=ell_align,
            allow_dia=allow_dia, allow_bell=allow_bell,
            allow_bdia=allow_bdia, dia_shape=dia_shape)

    @staticmethod
    def from_csr_host(mesh, M, *, dtype=None, row_offsets=None,
                      col_offsets=None, axis: str = ROWS_AXIS,
                      allow_dia: bool = True, allow_bell: bool = True,
                      allow_bdia: bool = True):
        """Shard a host CSR directly: row blocks are contiguous indptr
        slices, already row-sorted — no global COO sort.  This is the fast
        path for AMG-setup products (P, R, Galerkin coarse operators),
        which arrive as CSR from the host setup pipeline."""
        M = M.tocsr()
        nrows, ncols = M.shape
        nparts = mesh.devices.size
        if row_offsets is None:
            row_offsets = row_decomposition(nrows, nparts)
        row_offsets = np.asarray(row_offsets, np.int64)
        parts = []
        for p in range(nparts):
            lo, hi = int(row_offsets[p]), int(row_offsets[p + 1])
            s, e = M.indptr[lo], M.indptr[hi]
            counts = np.diff(M.indptr[lo:hi + 1])
            lr = np.repeat(np.arange(hi - lo, dtype=np.int64), counts)
            parts.append((lr, M.indices[s:e].astype(np.int64), M.data[s:e]))
        return ShardedMatrix.from_local_parts(
            mesh, M.shape, parts, dtype=dtype, row_offsets=row_offsets,
            col_offsets=col_offsets, axis=axis, allow_dia=allow_dia,
            allow_bell=allow_bell, allow_bdia=allow_bdia)

    @staticmethod
    def from_local_parts(mesh, shape, parts, *, dtype=None, row_offsets=None,
                         col_offsets=None, axis: str = ROWS_AXIS,
                         ell_align: int = 1, allow_dia: bool = True,
                         allow_bell: bool = True, allow_bdia: bool = True,
                         dia_shape=None):
        # dia_shape: caller-guaranteed box-consistent 2-D/3-D view of each
        # shard's row space (see class docstring); ignored unless DIA is
        # selected and the product matches the padded shard size.
        """Assemble from per-shard (local_rows, global_cols, vals) triples.

        ``parts[p]`` holds entries whose global row lies in part ``p``'s row
        block, with rows already localized.  Entries must be unique per
        (row, col) but may be in any order.  This is the fast path used by
        generators that build their shard directly (the analog of the
        reference's on-device stencil assembly, src/HypreSystem.cpp:1476-1608).
        """
        nrows, ncols = shape
        nparts = mesh.devices.size
        if len(parts) != nparts:
            raise ValueError(f"need {nparts} parts, got {len(parts)}")
        if row_offsets is None:
            row_offsets = row_decomposition(nrows, nparts)
        row_offsets = np.asarray(row_offsets, np.int64)
        if col_offsets is None:
            col_offsets = (row_offsets if ncols == nrows
                           else row_decomposition(ncols, nparts))
        col_offsets = np.asarray(col_offsets, np.int64)
        if dtype is None:
            dtype = parts[0][2].dtype if parts[0][2].size else np.float64
            if np.issubdtype(dtype, np.integer):
                dtype = np.float64

        row_counts = np.diff(row_offsets)
        col_counts = np.diff(col_offsets)
        row_pad = max(1, int(row_counts.max()))
        col_pad = max(1, int(col_counts.max()))
        same_partition = np.array_equal(row_offsets, col_offsets)

        # --- split diag/offd, DIA candidacy ---
        diag_parts, offd_parts = [], []
        dia_offset_sets = []
        total_diag_nnz = 0
        for p in range(nparts):
            lr, gc, v = parts[p]
            lr = np.asarray(lr, np.int64)
            gc = np.asarray(gc, np.int64)
            v = np.asarray(v, dtype)
            lo, hi = col_offsets[p], col_offsets[p + 1]
            is_diag = (gc >= lo) & (gc < hi)
            dlr, dlc, dv = lr[is_diag], (gc[is_diag] - lo), v[is_diag]
            diag_parts.append((dlr, dlc, dv))
            offd_parts.append((lr[~is_diag], gc[~is_diag], v[~is_diag]))
            total_diag_nnz += dlr.size
            if allow_dia and same_partition and dlr.size:
                dia_offset_sets.append(np.unique(dlc - dlr))

        use_dia = False
        dia_union = None
        if allow_dia and same_partition and dia_offset_sets and total_diag_nnz:
            dia_union = np.unique(np.concatenate(dia_offset_sets))
            D = dia_union.size
            fill = total_diag_nnz / max(D * nparts * row_pad, 1)
            if dia_shape is not None and int(np.prod(dia_shape)) == row_pad:
                # caller vouches for box structure (e.g. Galerkin coarse
                # levels): DIA is then taken at much lower fill and higher
                # offset counts
                use_dia = 0 < D <= 4 * DIA_MAX_OFFSETS and fill >= 0.05
            else:
                use_dia = 0 < D <= DIA_MAX_OFFSETS and fill >= DIA_MIN_FILL

        # --- offd block + halo plan (shared implementation) ---
        (ovals, ocols, send_idx, ghost_slot, offd_nnz) = _build_offd_and_halo(
            mesh, axis, nparts, row_pad, row_counts, col_offsets, offd_parts,
            dtype, ell_align)

        # --- diag block: DIA, BDIA, BELL, or ELL ---
        # The three non-DIA layouts are ranked by the bytes one SpMV
        # streams, computed from their shapes: BDIA its coefficient rows
        # and x windows plus overflow entries (kernels/bdia.py), BELL its
        # tiles plus the gathered x windows, ELL its values, columns and
        # gathered x.
        use_bell = False
        use_bdia = False
        bdia_R = bdia_D = 0
        itemsize = np.dtype(dtype).itemsize
        tile_budget = min(BELL_MAX_BYTES,
                          max(TILE_EXPANSION_FLOOR,
                              int(TILE_MAX_EXPANSION *
                                  total_diag_nnz * itemsize)))
        if not use_dia and total_diag_nnz >= BELL_MIN_NNZ:
            kd_ell = max((int(np.bincount(dp[0]).max())
                          for dp in diag_parts if dp[0].size), default=1)
            ell_bytes = nparts * row_pad * kd_ell * (2 * itemsize + 4)
            bell_bytes = bdia_bytes = float("inf")
            if allow_bell:
                from tpusolve.kernels import bell as bell_mod
                bk = max((bell_mod.bell_plan_k(dp[0], dp[1], row_pad)
                          for dp in diag_parts), default=0)
                G = bell_mod._ngroups(row_pad)
                tile_bytes = nparts * G * bk * bell_mod.TM * bell_mod.TN * \
                    itemsize
                if bk > 0 and tile_bytes <= tile_budget:
                    bell_bytes = tile_bytes * (bell_mod.TM + 1) / bell_mod.TM
            if allow_bdia:
                from tpusolve.kernels import bdia as bdia_mod
                for R in bdia_mod.BLOCK_SIZES:
                    profs = [bdia_mod.plan_fill_profile(
                        dp[0], dp[1], row_pad, col_pad, R)
                        for dp in diag_parts]
                    Dfull = max((len(pr) for pr in profs), default=0)
                    if Dfull <= 0:
                        continue
                    rank_totals = np.zeros(Dfull, np.int64)
                    for pr in profs:
                        rank_totals[:len(pr)] += pr
                    # ovf[D] = entries spilled to the overflow list at cap D
                    ovf = np.concatenate([
                        np.cumsum(rank_totals[::-1])[::-1], [0]])
                    B = (row_pad + R - 1) // R
                    for D in range(1, Dfull + 1):
                        if nparts * B * D * R * itemsize > tile_budget:
                            break   # grows with D: no larger D fits either
                        k = int(ovf[D])
                        # overflow must stay a correction, not a layout:
                        # a large spill list is just ELL with extra steps
                        if k > max(4096, total_diag_nnz // 8):
                            continue
                        nb = bdia_mod.streamed_bytes(nparts * B, D, R,
                                                     itemsize, k)
                        if nb < bdia_bytes:
                            bdia_bytes = nb
                            bdia_R, bdia_D = R, D
            if min(bdia_bytes, bell_bytes) < ell_bytes:
                use_bdia = bdia_bytes <= bell_bytes
                use_bell = not use_bdia

        if use_bell:
            from tpusolve.kernels import bell as bell_mod
            G = bell_mod._ngroups(row_pad)
            bids = np.zeros((nparts, G, bk), np.int32)
            b_idx, b_val = [], []
            for p in range(nparts):
                dlr, dlc, dv = diag_parts[p]
                bids[p], fi, vo = bell_mod.bell_compact(
                    dlr, dlc, dv, row_pad, col_pad, bk, dtype=dtype)
                b_idx.append(fi)
                b_val.append(vo)
            bvals = materialize_sharded(
                mesh, axis, b_idx, b_val,
                (G, bk, bell_mod.TM, bell_mod.TN), dtype)
            bell_nwin = (col_pad + bell_mod.TN - 1) // bell_mod.TN
            dvals = np.zeros((nparts, row_pad, 1), dtype)
            dcols = np.zeros((nparts, row_pad, 1), np.int32)
            kd = 1
        else:
            bvals = bids = None
            bell_nwin = None
        if use_bdia:
            from tpusolve.kernels import bdia as bdia_mod
            Bb = (row_pad + bdia_R - 1) // bdia_R
            starts_raw = np.zeros((nparts, Bb, bdia_D), np.int64)
            s_idx, s_val = [], []
            ovf_parts = []
            for p in range(nparts):
                dlr, dlc, dv = diag_parts[p]
                starts_raw[p], fi, vo, o_r, o_c, o_v = bdia_mod.compact(
                    dlr, dlc, dv, row_pad, col_pad, bdia_R, bdia_D,
                    dtype=dtype, overflow=True)
                s_idx.append(fi)
                s_val.append(vo)
                ovf_parts.append((o_r, o_c, o_v))
            lo = int(min(0, starts_raw.min()))
            hi = int(max(col_pad, starts_raw.max() + bdia_R))
            bdia_xpad = -lo
            bdia_xlen = bdia_xpad + hi
            bdia_starts = (starts_raw + bdia_xpad).astype(np.int32)
            bdia_vals = materialize_sharded(mesh, axis, s_idx, s_val,
                                            (Bb, bdia_D, bdia_R), dtype)
            # overflow lists: pad shard-uniform; padding rows scatter past
            # row_pad (dropped), padding cols/vals are harmless zeros
            k_ovf = max((p_[0].size for p_ in ovf_parts), default=0)
            if k_ovf > 0:
                k_pad = _ceil_to(k_ovf, 8)
                ovf_rows = np.full((nparts, k_pad), row_pad, np.int32)
                ovf_cols = np.zeros((nparts, k_pad), np.int32)
                ovf_vals = np.zeros((nparts, k_pad), dtype)
                for p, (o_r, o_c, o_v) in enumerate(ovf_parts):
                    ovf_rows[p, :o_r.size] = o_r
                    ovf_cols[p, :o_c.size] = o_c
                    ovf_vals[p, :o_v.size] = o_v
            else:
                ovf_rows = ovf_cols = ovf_vals = None
            dvals = np.zeros((nparts, row_pad, 1), dtype)
            dcols = np.zeros((nparts, row_pad, 1), np.int32)
            kd = 1
        else:
            bdia_vals = bdia_starts = None
            bdia_xpad = bdia_xlen = None
            bdia_R = None
            ovf_rows = ovf_cols = ovf_vals = None
        if use_dia:
            D = dia_union.size
            d_idx, d_val = [], []
            for p in range(nparts):
                dlr, dlc, dv = diag_parts[p]
                slot = (np.searchsorted(dia_union, dlc - dlr) if dlr.size
                        else np.zeros(0, np.int64))
                d_idx.append(slot * row_pad + dlr)
                d_val.append(dv)
            if dia_shape is not None and int(np.prod(dia_shape)) == row_pad:
                dia_tail = (D,) + tuple(dia_shape)
            else:
                dia_shape = None
                dia_tail = (D, row_pad)
            dia_vals = materialize_sharded(mesh, axis, d_idx, d_val,
                                           dia_tail, dtype)
            kd = 1
            dvals = np.zeros((nparts, row_pad, 1), dtype)
            dcols = np.zeros((nparts, row_pad, 1), np.int32)
            dia_offsets = tuple(int(o) for o in dia_union)
        elif use_bell or use_bdia:
            dia_shape = None
            dia_vals = None
            dia_offsets = None
        else:
            dia_shape = None
            kd = 1
            for p in range(nparts):
                dlr = diag_parts[p][0]
                if dlr.size:
                    kd = max(kd, int(np.bincount(
                        dlr, minlength=int(row_counts[p])).max()))
            kd = _ceil_to(kd, ell_align)
            e_idx, e_val, e_col = [], [], []
            for p in range(nparts):
                flat, vo, co = _ell_compact(kd, *diag_parts[p])
                e_idx.append(flat)
                e_val.append(vo)
                e_col.append(co)
            dvals = materialize_sharded(mesh, axis, e_idx, e_val,
                                        (row_pad, kd), dtype)
            dcols = materialize_sharded(mesh, axis, e_idx, e_col,
                                        (row_pad, kd), np.int32)
            dia_vals = None
            dia_offsets = None

        # --- main diagonal (square, same partition) ---
        diag_main = np.zeros((nparts, row_pad), dtype)
        for p in range(nparts):
            nr = int(row_counts[p])
            diag_main[p, nr:] = 1.0  # padded rows: unit diagonal
            if same_partition and row_offsets[p] == col_offsets[p]:
                dlr, dlc, dv = diag_parts[p]
                if dlr.size:
                    on_diag = dlc == dlr
                    diag_main[p, dlr[on_diag]] += dv[on_diag]

        from tpusolve.mesh import put_sharded
        put = lambda a: (a if isinstance(a, jax.Array)
                         else put_sharded(a, mesh, P(axis)))
        nnz = int(sum(np.asarray(p[2]).size for p in parts))
        return ShardedMatrix(
            diag_vals=put(dvals), diag_cols=put(dcols),
            dia_vals=put(dia_vals) if use_dia else None,
            bell_vals=put(bvals) if use_bell else None,
            bell_ids=put(bids) if use_bell else None,
            bdia_vals=put(bdia_vals) if use_bdia else None,
            bdia_starts=put(bdia_starts) if use_bdia else None,
            offd_vals=put(ovals), offd_cols=put(ocols),
            send_idx=put(send_idx), ghost_slot=put(ghost_slot),
            diag=put(diag_main),
            shape=(int(nrows), int(ncols)),
            row_offsets=tuple(int(o) for o in row_offsets),
            col_offsets=tuple(int(o) for o in col_offsets),
            row_pad=row_pad, col_pad=col_pad, dia_offsets=dia_offsets,
            dia_shape=(tuple(int(v) for v in dia_shape)
                       if dia_shape is not None else None),
            bell_nwin=bell_nwin,
            bdia_block=bdia_R, bdia_xpad=bdia_xpad, bdia_xlen=bdia_xlen,
            bdia_ovf_rows=put(ovf_rows) if ovf_rows is not None else None,
            bdia_ovf_cols=put(ovf_cols) if ovf_cols is not None else None,
            bdia_ovf_vals=put(ovf_vals) if ovf_vals is not None else None,
            has_offd=offd_nnz > 0,
            mesh=mesh, axis=axis, nnz=nnz)

    # ------------------------------------------------------------------
    @staticmethod
    def from_dia_parts(mesh, shape, dia_offsets, dia_vals, offd_parts, *,
                       dtype=None, row_offsets=None, col_offsets=None,
                       axis: str = ROWS_AXIS, dia_shape=None,
                       dia_nnz: int | None = None):
        """Assemble directly from per-shard diagonal-format diag blocks.

        ``dia_vals``: (nparts, D, row_pad) host array — the diag block in
        diagonal-major DIA layout (row-padded, zeros in padding).
        ``offd_parts``: list of (local_rows, global_cols, vals) for
        off-owner entries per shard.  ``dia_shape=(rows, lanes)`` declares a
        2-D view of the row space for which the offsets are box-consistent
        (caller guarantee) — unlocks the lane-aligned SpMV.
        This is the zero-copy fast path for structured generators (the
        stencil generator's diag block is pure local-box geometry).
        """
        nrows, ncols = shape
        nparts = mesh.devices.size
        if row_offsets is None:
            row_offsets = row_decomposition(nrows, nparts)
        row_offsets = np.asarray(row_offsets, np.int64)
        col_offsets = (row_offsets if col_offsets is None
                       else np.asarray(col_offsets, np.int64))
        if dtype is None:
            dtype = dia_vals.dtype
        # device-resident dia_vals (e.g. the on-device stencil generator)
        # are accepted as-is: no GB-scale host round-trip
        on_device = isinstance(dia_vals, jax.Array)
        if not on_device:
            dia_vals = np.asarray(dia_vals, dtype)
        nparts_d, D, row_pad = dia_vals.shape
        if dia_shape is not None:
            if int(np.prod(dia_shape)) != row_pad:
                raise ValueError("dia_shape does not tile the row space")
        if nparts_d != nparts:
            raise ValueError("dia_vals leading dim != mesh size")
        row_counts = np.diff(row_offsets)

        (ovals, ocols, send_idx, ghost_slot, offd_nnz) = _build_offd_and_halo(
            mesh, axis, nparts, row_pad, row_counts, col_offsets, offd_parts,
            dtype, 1)

        dia_offsets = tuple(int(o) for o in dia_offsets)
        if on_device:
            import jax.numpy as jnp
            dm = (dia_vals[:, dia_offsets.index(0), :]
                  if 0 in dia_offsets else jnp.zeros((nparts, row_pad), dtype))
            tail = (jnp.arange(row_pad)[None, :]
                    >= jnp.asarray(row_counts)[:, None])
            diag_main = jnp.where(tail, jnp.asarray(1.0, dtype), dm)
        else:
            diag_main = np.zeros((nparts, row_pad), dtype)
            if 0 in dia_offsets:
                diag_main[:] = dia_vals[:, dia_offsets.index(0), :]
            for p in range(nparts):
                diag_main[p, int(row_counts[p]):] = 1.0
        # nnz BEFORE the box reshape: any large reduce over the 5-D
        # box-tiled layout exhausts the backend at 384^3 (measured r5),
        # while the flat (P, D, R) layout counts fine.  Callers with an
        # analytic count (stencil generators) pass dia_nnz and skip the
        # 6 GB device reduce entirely.
        if dia_nnz is not None:
            nnz = int(dia_nnz) + offd_nnz
        elif on_device:
            import jax.numpy as jnp
            from jax import lax

            # per-plane: bounds the bool/int reduce temps to one plane,
            # and per-plane counts fit int32 (a 1.5e9 total would not)
            @jax.jit
            def _plane_counts(v):
                def body(d, acc):
                    pl = lax.dynamic_slice_in_dim(v, d, 1, axis=1)
                    return acc.at[d].set(
                        jnp.sum(pl != 0, dtype=jnp.int32))

                return lax.fori_loop(0, v.shape[1], body,
                                     jnp.zeros((v.shape[1],), jnp.int32))

            nnz = int(np.asarray(_plane_counts(dia_vals))
                      .astype(np.int64).sum()) + offd_nnz
        else:
            nnz = int(np.count_nonzero(dia_vals)) + offd_nnz
        if dia_shape is not None:
            # store box-shaped: per-diagonal planes keep the tiled layout the
            # SpMV slices need (a flat (D, R) layout forces a relayout copy
            # per diagonal per SpMV)
            shp = (nparts, D) + tuple(dia_shape)
            if on_device:
                # donated: GB-scale device stacks must not copy
                dia_vals = jax.jit(lambda v: v.reshape(shp),
                                   donate_argnums=0)(dia_vals)
            else:
                dia_vals = dia_vals.reshape(shp)

        from tpusolve.mesh import put_sharded
        put = lambda a: (a if isinstance(a, jax.Array)
                         else put_sharded(a, mesh, P(axis)))
        if on_device:
            diag_main = jax.device_put(diag_main,
                                       NamedSharding(mesh, P(axis)))
        dummy = np.zeros((nparts, row_pad, 1), dtype)
        return ShardedMatrix(
            diag_vals=put(dummy), diag_cols=put(dummy.astype(np.int32)),
            dia_vals=put(dia_vals), bell_vals=None, bell_ids=None,
            bdia_vals=None, bdia_starts=None,
            offd_vals=put(ovals), offd_cols=put(ocols),
            send_idx=put(send_idx), ghost_slot=put(ghost_slot),
            diag=put(diag_main),
            shape=(int(nrows), int(ncols)),
            row_offsets=tuple(int(o) for o in row_offsets),
            col_offsets=tuple(int(o) for o in col_offsets),
            row_pad=row_pad, col_pad=row_pad, dia_offsets=dia_offsets,
            dia_shape=(tuple(int(v) for v in dia_shape)
                       if dia_shape is not None else None),
            bell_nwin=None, bdia_block=None, bdia_xpad=None,
            bdia_xlen=None,
            has_offd=offd_nnz > 0, mesh=mesh, axis=axis, nnz=nnz)

    # ------------------------------------------------------------------
    @staticmethod
    def from_device_ell_parts(mesh, shape, ell_v, ell_c, *, row_offsets,
                              col_offsets, axis: str = ROWS_AXIS,
                              row_counts=None, diag_main=None, nnz=None):
        """Device-resident per-part padded-ELL with GLOBAL columns ->
        ShardedMatrix, without shipping the bulk to the host.

        ``ell_v``/``ell_c``: (P, row_pad, K) sharded value/column arrays
        (columns arbitrary at zero-valued slots; rows beyond each part's
        count all-zero).  The diag/offd split runs ON DEVICE; only the
        off-owner entries (seam surface, O(boundary)) are fetched to build
        the halo plan — the device-first analog of the reference's on-GPU
        assembly feeding hypre's comm-pkg setup
        (src/HypreSystem.cpp:1540-1597 + hypre internals).
        ``diag_main``: (P, row_pad) main-diagonal (device or host); ones
        where absent (rectangular operators).
        """
        import jax
        import jax.numpy as jnp
        from tpusolve.mesh import put_sharded, fetch_host
        nrows, ncols = int(shape[0]), int(shape[1])
        P_ = mesh.devices.size
        ro = np.asarray(row_offsets, np.int64)
        co = np.asarray(col_offsets, np.int64)
        if row_counts is None:
            row_counts = np.diff(ro)
        row_counts = np.asarray(row_counts, np.int64)
        _, row_pad, K = ell_v.shape
        col_pad = max(1, int(np.diff(co).max()))
        dtype = np.dtype(ell_v.dtype)

        lo = put_sharded(co[:-1].reshape(P_, 1, 1).astype(np.int64),
                         mesh, P(axis))
        hi = put_sharded(co[1:].reshape(P_, 1, 1).astype(np.int64),
                         mesh, P(axis))

        @jax.jit
        def split(v, c, lo, hi):
            c = c.astype(jnp.int64) if c.dtype != jnp.int64 else c
            inr = (c >= lo) & (c < hi) & (v != 0)
            dv = jnp.where(inr, v, jnp.zeros((), v.dtype))
            dc = jnp.where(inr, c - lo, 0).astype(jnp.int32)
            om = (v != 0) & ~inr
            return dv, dc, om

        dv, dc, om = split(ell_v, ell_c, lo, hi)
        ocnt = fetch_host(jnp.sum(om.reshape(P_, -1), axis=1)).astype(
            np.int64)
        if nnz is None:
            nnz = int(fetch_host(
                jnp.sum((ell_v != 0).reshape(P_, -1), axis=1)).sum())

        if ocnt.sum() == 0:
            z = np.zeros((P_, row_pad, 1), dtype)
            ovals = put_sharded(z, mesh, P(axis))
            ocols = put_sharded(z.astype(np.int32), mesh, P(axis))
            send_idx = np.zeros((P_, P_, 1), np.int32)
            ghost_slot = np.zeros((P_, 1), np.int32)
        else:
            cap = max(1, int(ocnt.max()))

            @jax.jit
            @jax.vmap
            def extract(v, c, m):
                pos = jnp.nonzero(m.reshape(-1), size=cap,
                                  fill_value=-1)[0]
                ok = pos >= 0
                p = jnp.where(ok, pos, 0)
                return (p.astype(jnp.int32), ok,
                        v.reshape(-1)[p], c.reshape(-1)[p])

            pos_h, ok_h, v_h, c_h = (fetch_host(x) for x in
                                     extract(ell_v, ell_c, om))
            offd_parts = []
            for p in range(P_):
                k = ok_h[p]
                offd_parts.append(((pos_h[p][k] // K).astype(np.int64),
                                   c_h[p][k].astype(np.int64),
                                   v_h[p][k].astype(dtype)))
            (ovals, ocols, send_idx, ghost_slot, _) = _build_offd_and_halo(
                mesh, axis, P_, row_pad, row_counts, co, offd_parts,
                dtype, 1)

        if diag_main is None:
            diag_main = np.ones((P_, row_pad), dtype)
        put = lambda a: (a if isinstance(a, jax.Array)
                         else put_sharded(np.asarray(a), mesh, P(axis)))
        return ShardedMatrix(
            diag_vals=dv, diag_cols=dc,
            dia_vals=None, bell_vals=None, bell_ids=None,
            bdia_vals=None, bdia_starts=None,
            offd_vals=put(ovals), offd_cols=put(ocols),
            send_idx=put(send_idx), ghost_slot=put(ghost_slot),
            diag=put(diag_main),
            shape=(nrows, ncols),
            row_offsets=tuple(int(x) for x in ro),
            col_offsets=tuple(int(x) for x in co),
            row_pad=row_pad, col_pad=col_pad,
            dia_offsets=None, dia_shape=None, bell_nwin=None,
            bdia_block=None, bdia_xpad=None, bdia_xlen=None,
            has_offd=bool(ocnt.sum() > 0), mesh=mesh, axis=axis,
            nnz=int(nnz))

    def to_scipy(self):
        """Reconstruct the global matrix as scipy CSR (testing/host use).

        Note: fetches every device array; where the host CSR from assembly
        time is at hand (``A_host`` plumbing), prefer it.
        """
        import scipy.sparse as sp
        from tpusolve.mesh import fetch_host
        ro = np.asarray(self.row_offsets)
        co = np.asarray(self.col_offsets)
        ovals = fetch_host(self.offd_vals)
        ocols = fetch_host(self.offd_cols)
        send_idx = fetch_host(self.send_idx)
        ghost_slot = fetch_host(self.ghost_slot)
        # one fetch per array, NOT per part (a device->host transfer — or a
        # multi-process allgather — per loop iteration)
        dia_h = fetch_host(self.dia_vals) if self.uses_dia else None
        bellv_h = fetch_host(self.bell_vals) if self.uses_bell else None
        belli_h = fetch_host(self.bell_ids) if self.uses_bell else None
        bdiav_h = fetch_host(self.bdia_vals) if self.uses_bdia else None
        bdias_h = fetch_host(self.bdia_starts) if self.uses_bdia else None
        has_ovf = self.uses_bdia and self.bdia_ovf_vals is not None
        ovfr_h = fetch_host(self.bdia_ovf_rows) if has_ovf else None
        ovfc_h = fetch_host(self.bdia_ovf_cols) if has_ovf else None
        ovfv_h = fetch_host(self.bdia_ovf_vals) if has_ovf else None
        ell_h = ellc_h = None
        if not (self.uses_dia or self.uses_bell or self.uses_bdia):
            ell_h = fetch_host(self.diag_vals)
            ellc_h = fetch_host(self.diag_cols)
        S = send_idx.shape[-1]
        rows, cols, vals = [], [], []
        for p in range(self.nparts):
            nr = int(ro[p + 1] - ro[p])
            if self.uses_dia:
                dv = dia_h[p]
                dv = dv.reshape(dv.shape[0], -1)        # (D, R)
                offs = np.asarray(self.dia_offsets)
                k_idx, r_idx = np.nonzero(dv[:, :nr] != 0)
                lc = r_idx + offs[k_idx]
                rows.append(ro[p] + r_idx)
                cols.append(co[p] + lc)
                vals.append(dv[:, :nr][k_idx, r_idx])
            elif self.uses_bell:
                from tpusolve.kernels import bell as bell_mod
                bv = bellv_h[p]       # (G, K, 8, 128)
                bi = belli_h[p]        # (G, K)
                g_i, k_i, r_i, c_i = np.nonzero(bv)
                lr = g_i * bell_mod.TM + r_i
                lc = bi[g_i, k_i].astype(np.int64) * bell_mod.TN + c_i
                keep = lr < nr
                rows.append(ro[p] + lr[keep])
                cols.append(co[p] + lc[keep])
                vals.append(bv[g_i, k_i, r_i, c_i][keep])
            elif self.uses_bdia:
                bv = bdiav_h[p]       # (B, D, R)
                bs = bdias_h[p]     # (B, D)
                R = self.bdia_block
                b_i, d_i, r_i = np.nonzero(bv)
                lr = b_i * R + r_i
                lc = bs[b_i, d_i].astype(np.int64) - self.bdia_xpad + r_i
                keep = lr < nr
                rows.append(ro[p] + lr[keep])
                cols.append(co[p] + lc[keep])
                vals.append(bv[b_i, d_i, r_i][keep])
                if has_ovf:
                    olr = ovfr_h[p].astype(np.int64)
                    keep = olr < nr    # padding rows sit at row_pad
                    rows.append(ro[p] + olr[keep])
                    cols.append(co[p] + ovfc_h[p][keep].astype(np.int64))
                    vals.append(ovfv_h[p][keep])
            else:
                ev = ell_h[p]
                ec = ellc_h[p]
                r_idx, k_idx = np.nonzero(ev[:nr] != 0)
                rows.append(ro[p] + r_idx)
                cols.append(co[p] + ec[:nr][r_idx, k_idx])
                vals.append(ev[:nr][r_idx, k_idx])
            # offd: rebuild ghost globals from the plan
            owners = ghost_slot[p] // S
            pos = ghost_slot[p] % S
            ghost_globals = co[owners] + send_idx[owners, p, pos]
            ev, ec = ovals[p], ocols[p]
            r_idx, k_idx = np.nonzero(ev[:nr] != 0)
            rows.append(ro[p] + r_idx)
            cols.append(ghost_globals[ec[:nr][r_idx, k_idx]])
            vals.append(ev[:nr][r_idx, k_idx])
        rows = np.concatenate(rows) if rows else np.zeros(0, np.int64)
        cols = np.concatenate(cols) if cols else np.zeros(0, np.int64)
        vals = np.concatenate(vals) if vals else np.zeros(0)
        return sp.csr_matrix((vals, (rows, cols)), shape=self.shape)

    def astype(self, dtype) -> "ShardedMatrix":
        """Value-dtype cast of the same operator (layout, plan and index
        arrays shared/unchanged).  Used for the mixed-precision f32 twin —
        a device-side cast instead of a second full assembly
        (ref analog: one IJ matrix, two exec precisions)."""
        if self.dtype == dtype:
            return self
        cast = lambda a: a.astype(dtype) if a is not None else None
        return dataclasses.replace(
            self, diag_vals=cast(self.diag_vals), dia_vals=cast(self.dia_vals),
            bell_vals=cast(self.bell_vals),
            bdia_vals=cast(self.bdia_vals),
            bdia_ovf_vals=cast(self.bdia_ovf_vals),
            offd_vals=cast(self.offd_vals), diag=cast(self.diag))

    def diagonal_padded(self) -> jax.Array:
        """Main diagonal as a padded sharded vector of shape
        (nparts * row_pad,), 1.0 at padded slots."""
        return self.diag.reshape(self.padded_nrows)


def _build_offd_and_halo(mesh, axis, nparts, row_pad, row_counts,
                         col_offsets, offd_parts, dtype, ell_align):
    """Shared offd-ELL + halo-plan construction.

    offd_parts: per shard (local_rows, global_cols, vals) of off-owner
    entries.  Returns (ovals, ocols, send_idx, ghost_slot, total_offd_nnz)
    with ocols indexing each shard's sorted ghost list; ovals/ocols are
    device arrays (materialized sharded), the plan arrays host.
    """
    ghost_lists = []
    local_offd = []
    ko = 1
    total = 0
    for p in range(nparts):
        olr, ogc, ov = offd_parts[p]
        olr = np.asarray(olr, np.int64)
        ogc = np.asarray(ogc, np.int64)
        ov = np.asarray(ov, dtype)
        ghosts = np.unique(ogc)
        og = np.searchsorted(ghosts, ogc)
        ghost_lists.append(ghosts)
        local_offd.append((olr, og, ov))
        total += olr.size
        if olr.size:
            ko = max(ko, int(np.bincount(
                olr, minlength=int(row_counts[p])).max()))
    ko = _ceil_to(ko, ell_align)
    ghost_pad = max(1, max(g.size for g in ghost_lists))

    send_counts = np.zeros((nparts, nparts), np.int64)
    for q in range(nparts):
        st = np.searchsorted(ghost_lists[q], col_offsets)
        send_counts[:, q] = np.diff(st)
    send_pad = max(1, int(send_counts.max()))

    send_idx = np.zeros((nparts, nparts, send_pad), np.int32)
    ghost_slot = np.zeros((nparts, ghost_pad), np.int32)
    for q in range(nparts):
        gl = ghost_lists[q]
        st = np.searchsorted(gl, col_offsets)
        owners = np.searchsorted(col_offsets, gl, side="right") - 1
        pos = np.arange(gl.size) - st[owners]
        ghost_slot[q, :gl.size] = owners * send_pad + pos
        for p in range(nparts):
            seg = gl[st[p]:st[p + 1]] - col_offsets[p]
            send_idx[p, q, :seg.size] = seg

    o_idx, o_val, o_col = [], [], []
    for p in range(nparts):
        flat, vo, co = _ell_compact(ko, *local_offd[p])
        o_idx.append(flat)
        o_val.append(vo)
        o_col.append(co)
    ovals = materialize_sharded(mesh, axis, o_idx, o_val, (row_pad, ko),
                                dtype)
    ocols = materialize_sharded(mesh, axis, o_idx, o_col, (row_pad, ko),
                                np.int32)
    return ovals, ocols, send_idx, ghost_slot, total


def _ell_compact(k, lrows, lcols, vals):
    """Compact ELL staging: flat indices into a (row_pad, k) layout plus
    row-ordered values/columns (position = rank within row).  Entries may
    arrive in any order; a stable row sort assigns slots."""
    if lrows.size == 0:
        return (np.zeros(0, np.int64), np.zeros(0, vals.dtype),
                np.zeros(0, np.int32))
    if np.all(lrows[:-1] <= lrows[1:]):      # already row-sorted (CSR path)
        lr = lrows
        vo, co = vals, lcols
    else:
        order = np.argsort(lrows, kind="stable")
        lr = lrows[order]
        vo, co = vals[order], lcols[order]
    nr = int(lr[-1]) + 1
    starts = np.searchsorted(lr, np.arange(nr + 1))
    pos = np.arange(lr.size) - starts[lr]
    return lr * k + pos, vo, co.astype(np.int32)
