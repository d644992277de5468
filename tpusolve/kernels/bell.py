"""Block-ELL (BELL) — dense-tile layout for clustered sparse blocks.

The role the reference fills with vendor SpMV on file-loaded (unstructured)
systems (MM reader ref: src/HypreSystem.cpp:1613-1969; IJ reader
:1021-1318).

BELL restructures the local diag block into dense (tm x tn) = (8 x 128)
tiles — one tile per nonempty (8-row group, 128-column window) pair, padded
block-ELL style to ``K`` tiles per group:

* ``vals``: (G, K, 8, 128) dense tile values (zeros in padding)
* ``ids``:  (G, K) int32 column-window index per tile

SpMV then needs one 128-wide row gather of x per tile instead of one element
gather per nonzero, and the multiply-reduce is a dense (8,128)x(128,)
contraction.  Per SpMV it streams ``tiles * 4.5 KB`` (f32: tile values plus
the gathered x windows), so it pays off only where the tiles are dense;
matrix/sharded.py ranks it against BDIA and padded ELL by those bytes.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

TM = 8    # tile rows
TN = 128  # tile cols (x window width)


# ----------------------------------------------------------------------
# Host-side assembly
# ----------------------------------------------------------------------

def _sorted_unique_inverse(key_s: np.ndarray):
    """(uniq, inverse) of an already-sorted key array — O(n), no re-sort
    (``np.unique(..., return_inverse=True)`` re-sorts and was measured
    pathologically slow on large inputs)."""
    flag = np.empty(key_s.size, bool)
    flag[0] = True
    np.not_equal(key_s[1:], key_s[:-1], out=flag[1:])
    return key_s[flag], np.cumsum(flag) - 1


def bell_plan_k(lr: np.ndarray, lc: np.ndarray, row_pad: int) -> int:
    """Max tiles per 8-row group for one shard's entries (K before
    cross-shard padding)."""
    if lr.size == 0:
        return 0
    gid = np.asarray(lr, np.int64) // TM
    wid = np.asarray(lc, np.int64) // TN
    nwin = int(wid.max()) + 1
    keys = np.unique(gid * nwin + wid)
    return int(np.bincount(keys // nwin, minlength=_ngroups(row_pad)).max())


def _ngroups(row_pad: int) -> int:
    return max(1, (row_pad + TM - 1) // TM)


def bell_compact(lr, lc, v, row_pad: int, col_pad: int, kmax: int,
                 dtype=np.float32):
    """Plan one shard's BELL layout without materializing the dense tiles.

    Returns ``(ids, flat_idx, vals_ordered)``: ``ids`` is the small
    (G, kmax) int32 tile->column-window table; ``flat_idx``/``vals_ordered``
    are nnz-compact scatter staging for the (G, kmax, 8, 128) value array
    (``tiles.reshape(-1)[flat_idx] = vals_ordered``) — materialized on
    device (see matrix/build.py; the dense expansion can be 100x nnz).
    """
    G = _ngroups(row_pad)
    kmax = max(kmax, 1)
    ids = np.zeros((G, kmax), np.int32)
    lr = np.asarray(lr, np.int64)
    if lr.size == 0:
        return ids, np.zeros(0, np.int64), np.zeros(0, dtype)
    lc = np.asarray(lc, np.int64)
    v = np.asarray(v, dtype)
    gid = lr // TM
    wid = lc // TN
    nwin = (col_pad + TN - 1) // TN
    key = gid * nwin + wid
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, tile_of = _sorted_unique_inverse(key_s)
    # slot of each tile within its group (tiles sorted by key => by gid)
    tile_gid = uniq // nwin
    starts = np.searchsorted(tile_gid, np.arange(G + 1))
    slot_of_tile = np.arange(uniq.size) - starts[tile_gid]
    if uniq.size and slot_of_tile.max() >= kmax:
        raise ValueError("kmax too small for this shard")
    ids[tile_gid, slot_of_tile] = (uniq % nwin).astype(np.int32)
    slot = slot_of_tile[tile_of]                 # per (sorted) entry
    lro, lco, vo = lr[order], lc[order], v[order]
    flat_idx = ((lro // TM * kmax + slot) * TM + lro % TM) * TN + lco % TN
    return ids, flat_idx, vo


def bell_from_entries(lr, lc, v, row_pad: int, col_pad: int, kmax: int,
                      dtype=np.float32):
    """Host-materialized variant of :func:`bell_compact` (small shards,
    tests).  Returns (vals (G, kmax, 8, 128), ids (G, kmax) int32)."""
    ids, flat_idx, vo = bell_compact(lr, lc, v, row_pad, col_pad, kmax, dtype)
    G = _ngroups(row_pad)
    vals = np.zeros(G * max(kmax, 1) * TM * TN, dtype)
    vals[flat_idx] = vo
    return vals.reshape(G, max(kmax, 1), TM, TN), ids


# ----------------------------------------------------------------------
# Device kernels
# ----------------------------------------------------------------------

def _x_windows(x, nwin: int):
    """Local x as (nwin, 128) window matrix (zero-padded)."""
    need = nwin * TN
    if x.shape[0] < need:
        x = jnp.pad(x, (0, need - x.shape[0]))
    return x[:need].reshape(nwin, TN)


def bell_spmv_local(vals, ids, x, nwin: int, row_pad: int):
    """XLA formulation: row-gather the tiles' x windows, then a batched
    (8, K*128) @ (K*128,) contraction per group."""
    x2d = _x_windows(x, nwin)
    g = x2d[ids]                                   # (G, K, 128) row gather
    y = jnp.einsum("gkrc,gkc->gr", vals, g,
                   preferred_element_type=vals.dtype,
                   precision=lax.Precision.HIGHEST)
    return y.reshape(-1)[:row_pad]
