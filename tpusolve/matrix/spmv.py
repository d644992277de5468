"""Distributed SpMV: halo exchange + local DIA/ELL kernels.

This is the hot kernel of the entire framework — the operation HYPRE
performs inside every Krylov iteration and AMG cycle (consumed by the
reference through ``HYPRE_ParCSRMatrix``; vendor-SpMV toggle ref:
src/main.cpp:137-145).

Design:

* ``shard_map`` over the matrix's 1-D mesh axis; each device sees its own
  blocks;
* halo exchange = gather of the statically planned send entries followed by
  **one** ``lax.all_to_all`` over the mesh axis (replacing HYPRE's MPI
  neighbor point-to-point machinery);
* **DIA local kernel** (structured matrices — chosen at assembly): each
  stored diagonal contributes one statically-shifted fused multiply-add.
  No gathers and no index traffic: the matrix bytes stream once;
* **BDIA / BELL local kernels** (unstructured but banded or clustered
  blocks, kernels/): contiguous x-window reads instead of per-element
  gathers;
* **ELL local kernel** (general fallback): two gathers + multiply-reduce
  over the padded row width.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

shard_map = jax.shard_map

# Halo/compute overlap: when True the halo all_to_all is issued before the
# interior sweep with no data dependence between them, letting XLA's
# async-collective scheduler run the transfer under the local compute
# (the comm-pkg overlap of the reference's generator,
# ref: laplace_3d_weak_scaling.hpp:412-602).  False serializes them with an
# optimization_barrier.  Read at trace time.
#
# Default OFF until the overlap has been measured across real cards
# (tools/weakscale.py).
HALO_OVERLAP = False


def halo_exchange(x_loc, send_idx, ghost_slot, axis):
    """Exchange ghost values over the mesh axis.

    x_loc:      (col_pad,)    local slice of the input vector
    send_idx:   (Pn, S) int32 local indices each peer needs from us
    ghost_slot: (G,) int32    position of each of our ghosts in the flat
                              receive buffer (owner * S + slot)
    Returns ghosts (G,).
    """
    sendbuf = x_loc[send_idx]                       # (Pn, S)
    recv = lax.all_to_all(sendbuf, axis, 0, 0)      # recv[q] = from device q
    return recv.reshape(-1)[ghost_slot]


def ell_spmv_local(vals, cols, x):
    """Padded-ELL block SpMV: y_i = sum_k vals[i,k] * x[cols[i,k]]."""
    return jnp.sum(vals * x[cols], axis=-1)


def dia_spmv_local(dia_vals, offsets, dia_shape, x):
    """Diagonal-format block SpMV: y_i = sum_d dia_vals[d,i] * x[i+off_d].

    All shifts are *static slices of one padded buffer* — the pattern XLA
    fuses into a single streaming pass.

    With ``dia_shape=(rows, lanes)`` (box-consistent offsets, e.g. the
    stencil's (nz*ny, nx)), each offset decomposes as a whole-row shift plus
    a small minor-dim shift, so every slice is a contiguous box read; the
    1-D form instead shifts the flat vector by arbitrary offsets.
    """
    if dia_shape is not None:
        dims = tuple(dia_shape)
        R = 1
        for d in dims:
            R *= d
        decs = [_decompose_offset(off, dims) for off in offsets]
        pads = [max(1, max(abs(c[i]) for c in decs))
                for i in range(len(dims))]
        xs = x[:R].reshape(dims)
        xp = jnp.pad(xs, [(p, p) for p in pads])
        acc = jnp.zeros(dims, x.dtype)
        for k, comps in enumerate(decs):
            start = tuple(p + c for p, c in zip(pads, comps))
            seg = lax.slice(xp, start,
                            tuple(s + d for s, d in zip(start, dims)))
            acc = acc + dia_vals[k] * seg      # dia_vals is (D, *dims)
        return acc.reshape(R)
    R = dia_vals.shape[1]
    M = max(1, max(abs(o) for o in offsets))
    xp = jnp.pad(x[:R], (M, M))
    acc = jnp.zeros(R, x.dtype)
    for k, off in enumerate(offsets):
        seg = lax.slice(xp, (M + off,), (M + off + R,))
        acc = acc + dia_vals[k] * seg
    return acc


def _decompose_offset(off: int, dims: tuple) -> tuple:
    """Mixed-radix decomposition of a flat offset into per-dim components of
    minimal magnitude: off = ((c0*dims[1] + c1)*dims[2] + c2)... for the
    stencil this recovers (dz, dy, dx)."""
    comps = []
    rem = off
    for d in reversed(dims[1:]):
        c = rem % d
        if c > d // 2:
            c -= d
        comps.append(c)
        rem = (rem - c) // d
    comps.append(rem)
    return tuple(reversed(comps))


def _offd_add(axis, x_loc, interior_fn, ov, oc, sidx, gslot):
    """interior ⊕ halo with the overlap policy applied."""
    if HALO_OVERLAP:
        ghosts = halo_exchange(x_loc, sidx, gslot, axis)   # async, under…
        y = interior_fn(x_loc)                             # …this sweep
    else:
        y = interior_fn(x_loc)
        x_ser, _ = lax.optimization_barrier((x_loc, y))    # force ordering
        ghosts = halo_exchange(x_ser, sidx, gslot, axis)
    return y + ell_spmv_local(ov, oc, ghosts)


def _spmv_shard_dia(axis, offsets, dia_shape, has_offd, dia, ov, oc, sidx,
                    gslot, x_loc):
    dia, ov, oc, sidx, gslot = (a[0] for a in (dia, ov, oc, sidx, gslot))
    interior = lambda x: dia_spmv_local(dia, offsets, dia_shape, x)
    if has_offd:
        return _offd_add(axis, x_loc, interior, ov, oc, sidx, gslot)
    return interior(x_loc)


def _ovf_wrap(interior, ovf):
    """Add the BDIA overflow term (entries spilled from blocks wider than
    the chosen D): one small gather + scatter-add; padding rows sit at
    row_pad and are dropped by the OOB scatter."""
    if ovf is None:
        return interior

    orows, ocols, ovals = ovf

    def fn(x):
        y = interior(x)
        return y.at[orows].add(ovals * x[ocols], mode="drop")

    return fn


def _spmv_shard_bdia(axis, xpad, xlen, row_pad, has_offd, has_ovf,
                     bv, bs, ov, oc, sidx, gslot, x_loc, *ovf_args):
    from tpusolve.kernels import bdia as bdia_mod
    bv, bs, ov, oc, sidx, gslot = (a[0] for a in (bv, bs, ov, oc, sidx,
                                                  gslot))
    interior = lambda x: bdia_mod.bdia_spmv_local(bv, bs, x, xpad, xlen,
                                                  row_pad)
    ovf = tuple(a[0] for a in ovf_args) if has_ovf else None
    interior = _ovf_wrap(interior, ovf)
    if has_offd:
        return _offd_add(axis, x_loc, interior, ov, oc, sidx, gslot)
    return interior(x_loc)


def _spmv_shard_bell(axis, nwin, row_pad, has_offd, bv, bi, ov, oc, sidx,
                     gslot, x_loc):
    from tpusolve.kernels import bell as bell_mod
    bv, bi, ov, oc, sidx, gslot = (a[0] for a in (bv, bi, ov, oc, sidx, gslot))
    interior = lambda x: bell_mod.bell_spmv_local(bv, bi, x, nwin, row_pad)
    if has_offd:
        return _offd_add(axis, x_loc, interior, ov, oc, sidx, gslot)
    return interior(x_loc)


def _spmv_shard_ell(axis, has_offd, dv, dc, ov, oc, sidx, gslot, x_loc):
    dv, dc, ov, oc, sidx, gslot = (a[0] for a in (dv, dc, ov, oc, sidx, gslot))
    interior = lambda x: ell_spmv_local(dv, dc, x)
    if has_offd:
        return _offd_add(axis, x_loc, interior, ov, oc, sidx, gslot)
    return interior(x_loc)


def spmv(A, x):
    """y = A @ x.

    ``x`` is a padded sharded vector over A's *column* decomposition
    (shape ``(nparts * col_pad,)``); returns a padded sharded vector over
    A's *row* decomposition (shape ``(nparts * row_pad,)``).
    """
    spec = P(A.axis)
    if A.uses_dia:
        fn = shard_map(
            partial(_spmv_shard_dia, A.axis, A.dia_offsets, A.dia_shape,
                    A.has_offd),
            mesh=A.mesh, in_specs=(spec,) * 6, out_specs=spec)
        return fn(A.dia_vals, A.offd_vals, A.offd_cols,
                  A.send_idx, A.ghost_slot, x)
    if A.uses_bdia:
        has_ovf = A.bdia_ovf_vals is not None
        ovf = ((A.bdia_ovf_rows, A.bdia_ovf_cols, A.bdia_ovf_vals)
               if has_ovf else ())
        fn = shard_map(
            partial(_spmv_shard_bdia, A.axis, A.bdia_xpad, A.bdia_xlen,
                    A.row_pad, A.has_offd, has_ovf),
            mesh=A.mesh, in_specs=(spec,) * (7 + len(ovf)), out_specs=spec)
        return fn(A.bdia_vals, A.bdia_starts, A.offd_vals, A.offd_cols,
                  A.send_idx, A.ghost_slot, x, *ovf)
    if A.uses_bell:
        fn = shard_map(
            partial(_spmv_shard_bell, A.axis, A.bell_nwin, A.row_pad,
                    A.has_offd),
            mesh=A.mesh, in_specs=(spec,) * 7, out_specs=spec)
        return fn(A.bell_vals, A.bell_ids, A.offd_vals, A.offd_cols,
                  A.send_idx, A.ghost_slot, x)
    fn = shard_map(
        partial(_spmv_shard_ell, A.axis, A.has_offd),
        mesh=A.mesh, in_specs=(spec,) * 7, out_specs=spec)
    return fn(A.diag_vals, A.diag_cols, A.offd_vals, A.offd_cols,
              A.send_idx, A.ghost_slot, x)


def matvec_fn(A):
    """Closure y = A @ x suitable for passing to Krylov solvers."""
    return partial(spmv, A)
