"""BDIA (blocked-DIA) — the unstructured-SpMV fast path for banded matrices.

The role the reference fills with vendor SpMV on its file-loaded nalu-wind
systems (toggle ref: src/main.cpp:137-145; readers src/HypreSystem.cpp:
1021-1969): those matrices are unstructured, but after bandwidth-reducing
(RCM) ordering their entries hug the diagonal — *almost* DIA, except the
offset set drifts from row to row, so global DIA storage explodes.

BDIA localizes DIA: rows are cut into blocks of ``R`` (default 256); each
block stores the union of its own (col - row) offsets:

* ``vals``:   (B, D, R) — per (block, offset-slot) coefficient rows
              (zeros in padding; D = max offsets per block, shard-uniform)
* ``starts``: (B, D) int32 — where each slot's x window begins in the
              zero-padded local x (start = xpad + b*R + offset)

SpMV is then, per (block, slot), one contiguous (R,)-window read of x and
one (R,)-wide fused multiply-add:

    y[b*R : (b+1)*R] = sum_d vals[b, d] * x_pad[starts[b, d] : +R]

**Zero per-element gathers.**  The x windows are B*D contiguous R-wide
slices, so the SpMV streams ~ 2 * B*D*R * itemsize bytes (vals + windows;
:func:`streamed_bytes`).  Its efficiency against CSR is set by the *slot
fill* nnz / (B*D*R) the ordering provides (natural stencil order: 100% =
global DIA; RCM'd meshes: tens of percent).

Selection between BDIA, BELL (kernels/bell.py) and padded ELL happens at
assembly (matrix/sharded.py) by comparing streamed bytes; several block
sizes are tried.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

BLOCK_SIZES = (2048, 1024, 512, 256, 128)  # candidate R values


def streamed_bytes(B: int, D: int, R: int, itemsize: int, k_ovf: int = 0
                   ) -> int:
    """Bytes one SpMV streams for a (B, D, R) layout with ``k_ovf``
    overflow entries: the coefficient rows, one equal-size x window per
    slot, the int32 window starts, and per overflow entry its row, column,
    value and gathered x."""
    return (2 * B * D * R * itemsize + 4 * B * D
            + k_ovf * (8 + 2 * itemsize))


def plan_d(lr, lc, row_pad: int, col_pad: int, R: int) -> int:
    """Max distinct (col - row) offsets per R-row block for one shard's
    diag entries (the D this shard needs at block size R)."""
    if len(lr) == 0:
        return 0
    lr = np.asarray(lr, np.int64)
    d = np.asarray(lc, np.int64) - lr
    b = lr // R
    # offsets span [-(row_pad-1), col_pad-1] (rectangular operators too)
    W = row_pad + col_pad + 1
    keys = np.unique(b * W + (d + row_pad))
    B = (row_pad + R - 1) // R
    return max(1, int(np.bincount(keys // W, minlength=B).max()))


def plan_fill_profile(lr, lc, row_pad: int, col_pad: int,
                      R: int) -> np.ndarray:
    """Per-rank slot-fill profile at block size R: ``out[r]`` = total
    entries landing in each block's r-th *most-populated* offset slot,
    summed over the shard's blocks.  Capping the layout at D slots per
    block therefore overflows exactly ``out[D:].sum()`` entries — the
    trade-off the assembly-time selection optimizes (a single clipped
    boundary block would otherwise inflate the uniform D for the whole
    shard and push selection to BELL)."""
    if len(lr) == 0:
        return np.zeros(0, np.int64)
    lr = np.asarray(lr, np.int64)
    d = np.asarray(lc, np.int64) - lr
    b = lr // R
    W = row_pad + col_pad + 1
    uniq, counts = np.unique(b * W + (d + row_pad), return_counts=True)
    key_b = uniq // W
    # rank slots within each block by descending count (stable: offset
    # order breaks ties) — same ordering compact() assigns slots in
    order_u = np.lexsort((-counts, key_b))
    B = (row_pad + R - 1) // R
    blk_starts = np.searchsorted(key_b, np.arange(B + 1))
    rank_sorted = np.arange(uniq.size) - blk_starts[key_b[order_u]]
    maxrank = int(rank_sorted.max()) + 1
    return np.bincount(rank_sorted, weights=counts[order_u],
                       minlength=maxrank).astype(np.int64)


def compact(lr, lc, v, row_pad: int, col_pad: int, R: int, dmax: int,
            dtype=np.float32, overflow: bool = False):
    """Build one shard's BDIA staging.

    Returns (starts (B, dmax) int32 *relative to unpadded x* (may be
    negative), flat_idx, vals_ordered) — flat indices into the (B, dmax, R)
    value array, materialized on device (matrix/build.py).

    Slots are assigned within each block by DESCENDING fill, so when a
    block has more distinct offsets than ``dmax`` the entries that don't
    fit are the fewest possible.  With ``overflow=False`` (the strict
    default) that condition raises; with ``overflow=True`` the spilled
    entries are returned as three extra arrays (local rows, local cols,
    vals) for the per-block overflow list (applied in the SpMV as one
    small gather + scatter-add)."""
    B = (row_pad + R - 1) // R
    dmax = max(dmax, 1)
    starts = np.full((B, dmax), _SENTINEL, np.int64)
    lr = np.asarray(lr, np.int64)
    if lr.size == 0:
        starts[:] = np.clip(np.arange(B, dtype=np.int64) * R, 0,
                            max(0, col_pad - R))[:, None]
        empty = (starts, np.zeros(0, np.int64), np.zeros(0, dtype))
        if overflow:
            return empty + (np.zeros(0, np.int64), np.zeros(0, np.int64),
                            np.zeros(0, dtype))
        return empty
    lc = np.asarray(lc, np.int64)
    d = lc - lr
    v = np.asarray(v, dtype)
    b = lr // R
    W = row_pad + col_pad + 1
    key = b * W + (d + row_pad)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    flag = np.empty(key_s.size, bool)
    flag[0] = True
    np.not_equal(key_s[1:], key_s[:-1], out=flag[1:])
    uniq = key_s[flag]
    slot_of_key = np.cumsum(flag) - 1
    counts_u = np.diff(np.append(np.flatnonzero(flag), key_s.size))
    key_b = uniq // W
    blk_starts = np.searchsorted(key_b, np.arange(B + 1))
    # rank slots within each block by descending fill (stable tie-break on
    # offset order) — a dmax cap then overflows the emptiest slots
    order_u = np.lexsort((-counts_u, key_b))
    rank_sorted = np.arange(uniq.size) - blk_starts[key_b[order_u]]
    rank_u = np.empty(uniq.size, np.int64)
    rank_u[order_u] = rank_sorted
    over_u = rank_u >= dmax
    if over_u.any() and not overflow:
        raise ValueError("dmax too small for this shard")
    keep_u = ~over_u
    starts[key_b[keep_u], rank_u[keep_u]] = \
        key_b[keep_u] * R + (uniq[keep_u] % W) - row_pad
    slot = rank_u[slot_of_key]
    lro, lco, vo = lr[order], lc[order], v[order]
    keep = slot < dmax
    flat_idx = (lro[keep] // R * dmax + slot[keep]) * R + lro[keep] % R
    # unused slots: park them on a window near the block's own diagonal
    # (vals are zero there, so any in-range window works; a nearby one
    # keeps the block's x reads local)
    park = np.clip(np.arange(B, dtype=np.int64) * R, 0,
                   max(0, col_pad - R))
    parked = starts == _SENTINEL
    starts = np.where(parked, park[:, None], starts)
    if overflow:
        spill = ~keep
        return (starts, flat_idx, vo[keep],
                lro[spill], lco[spill], vo[spill])
    return starts, flat_idx, vo


_SENTINEL = np.iinfo(np.int64).min // 2


def finalize_starts(starts: np.ndarray, col_pad: int, R: int):
    """Shift per-shard window starts into the zero-padded x coordinate
    system.  Returns (starts_adj int32, xpad_lo, xlen)."""
    lo = int(min(0, starts.min()))
    hi = int(max(col_pad, starts.max() + R))
    xpad_lo = -lo
    xlen = xpad_lo + hi
    return (starts + xpad_lo).astype(np.int32), xpad_lo, xlen


def bdia_spmv_local(vals, starts, x, xpad_lo: int, xlen: int, row_pad: int):
    """XLA formulation: the window reads are a vmap'd ``dynamic_slice``
    (an XLA gather with ``slice_sizes=(R,)``) feeding the multiply-reduce
    over slots.  XLA fuses pad, gather, multiply and reduce into one
    kernel, so the (B, D, R) window array never reaches device memory."""
    B, D, R = vals.shape
    xp = jnp.pad(x, (xpad_lo, max(0, xlen - xpad_lo - x.shape[0])))
    win = jax.vmap(lambda s: lax.dynamic_slice(xp, (s,), (R,)))(
        starts.reshape(-1))
    win = win.reshape(B, D, R)
    y = jnp.sum(vals * win, axis=1)
    return y.reshape(-1)[:row_pad]
