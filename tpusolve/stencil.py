"""27-point 3-D Laplacian weak-scaling generator.

JAX rebuild of the reference's HIP-only generator
(``build_27pt_stencil``, ref: src/HypreSystem.cpp:1323-1608, device kernels
in src/laplace_3d_weak_scaling.hpp:171-602): each part owns an
``nx x ny x nz`` box of the global ``(px*nx) x (py*ny) x (pz*nz)`` grid
(per-rank 128^3 default, ref: src/HypreSystem.cpp:1487-1489), the process
grid comes from prime factorization (ref: hpp:98-169), the matrix is the
27-point Laplacian with diagonal 26 and off-diagonal -1, and the RHS is
``26 - (row_nnz - 1)`` (ref: hpp:321) so the exact solution is x = 1
everywhere — the built-in determinism fixture.

Global row ordering is block-by-part (each part owns a contiguous row range,
matching the reference's iLower/iUpper contract), with x-fastest
lexicographic order inside each box.  Generation is vectorized NumPy per
part feeding ``ShardedMatrix.from_local_parts`` — entries never materialize
as a global COO, and the halo plan (the reference's hand-built
``kernel_setup_halo`` machinery, hpp:412-602) falls out of the generic
ghost-column analysis.
"""

from __future__ import annotations

import numpy as np

from tpusolve.mesh import ROWS_AXIS, compute_3d_process_distribution
from tpusolve.matrix.sharded import ShardedMatrix
from tpusolve.matrix.vectors import to_device_vector

_OFFSETS = np.array([(dx, dy, dz)
                     for dz in (-1, 0, 1)
                     for dy in (-1, 0, 1)
                     for dx in (-1, 0, 1)], dtype=np.int64)  # (27, 3)


def part_to_grid(part: int, pgrid: tuple[int, int, int]) -> tuple[int, int, int]:
    px, py, pz = pgrid
    return part % px, (part // px) % py, part // (px * py)


def _local_part(part, nx, ny, nz, pgrid, dtype):
    """Entries + rhs for one part: (local_rows, global_cols, vals), rhs."""
    px, py, pz = pgrid
    ipx, ipy, ipz = part_to_grid(part, pgrid)
    box = nx * ny * nz
    gx_max, gy_max, gz_max = px * nx, py * ny, pz * nz

    i = np.arange(nx, dtype=np.int64)
    j = np.arange(ny, dtype=np.int64)
    k = np.arange(nz, dtype=np.int64)
    # x fastest: lrow = k*(nx*ny) + j*nx + i
    gx = (ipx * nx + i)[None, None, :]
    gy = (ipy * ny + j)[None, :, None]
    gz = (ipz * nz + k)[:, None, None]
    lrow = (k[:, None, None] * (ny * nx) + j[None, :, None] * nx
            + i[None, None, :]).reshape(-1)                    # (box,)

    ngx = gx + _OFFSETS[:, 0][:, None, None, None]             # (27,nz,ny,nx)
    ngy = gy + _OFFSETS[:, 1][:, None, None, None]
    ngz = gz + _OFFSETS[:, 2][:, None, None, None]
    valid = ((ngx >= 0) & (ngx < gx_max) & (ngy >= 0) & (ngy < gy_max)
             & (ngz >= 0) & (ngz < gz_max))
    full = (27, nz, ny, nx)
    ngx = np.broadcast_to(ngx, full).reshape(27, -1)
    ngy = np.broadcast_to(ngy, full).reshape(27, -1)
    ngz = np.broadcast_to(ngz, full).reshape(27, -1)
    valid = valid.reshape(27, -1)                              # (27, box)

    # owner part + local index of each neighbor -> global column
    opx, olx = np.divmod(ngx, nx)
    opy, oly = np.divmod(ngy, ny)
    opz, olz = np.divmod(ngz, nz)
    opart = opz * (px * py) + opy * px + opx
    ocol = opart * box + olz * (ny * nx) + oly * nx + olx

    is_center = (_OFFSETS == 0).all(axis=1)[:, None]           # (27, 1)
    vals = np.where(is_center, 26.0, -1.0)
    vals = np.broadcast_to(vals, (27, box))

    rows27 = np.broadcast_to(lrow[None, :], (27, box))
    sel = valid
    lr = rows27[sel]
    gc = ocol[sel]
    v = vals[sel].astype(dtype)

    n_neighbors = valid.sum(axis=0) - 1                        # exclude center
    rhs = (26.0 - n_neighbors).astype(dtype)
    # rhs is indexed by lrow order; reorder to local-row order
    rhs_ordered = np.empty(box, dtype)
    rhs_ordered[lrow] = rhs
    return (lr, gc, v), rhs_ordered


def _dia_box(nx, ny, nz, dtype):
    """DIA values of the *diag block* for one local box.

    A neighbor inside the local box is automatically inside the global
    domain, so the diag block is pure local-box geometry — identical for
    every part.  Returns (offsets (27,), dia_vals (box, 27))."""
    ix = np.arange(nx)
    iy = np.arange(ny)
    iz = np.arange(nz)
    dia = np.zeros((27, nz, ny, nx), dtype)
    offs = np.empty(27, np.int64)
    for k, (dx, dy, dz) in enumerate(_OFFSETS):
        offs[k] = dz * ny * nx + dy * nx + dx
        if dx == dy == dz == 0:
            dia[k] = 26.0
            continue
        mx = (ix + dx >= 0) & (ix + dx < nx)
        my = (iy + dy >= 0) & (iy + dy < ny)
        mz = (iz + dz >= 0) & (iz + dz < nz)
        dia[k] = np.where(
            mz[:, None, None] & my[None, :, None] & mx[None, None, :],
            dtype(-1.0), dtype(0.0))
    order = np.argsort(offs)
    return offs[order], dia[order].reshape(27, nx * ny * nz)


def _dia_box_device(nx, ny, nz, dtype):
    """On-device twin of ``_dia_box`` (+ single-part RHS).

    At 256^3 the host DIA table is 1.8 GB of fill and upload; the masks are trivially computable on device and
    the values (-1/26/0, exact in any float) are bit-identical to the host
    generator.  Single-part only (in-domain == in-box so rhs = 26 - count).
    """
    import jax
    import jax.numpy as jnp
    offs = np.array([dz * ny * nx + dy * nx + dx
                     for dx, dy, dz in _OFFSETS], np.int64)
    order = np.argsort(offs)

    @jax.jit
    def gen():
        ix = jnp.arange(nx)
        iy = jnp.arange(ny)
        iz = jnp.arange(nz)
        planes = []
        count = None
        for k in order:
            dx, dy, dz = _OFFSETS[k]
            if dx == dy == dz == 0:
                planes.append(jnp.full((nz, ny, nx), 26.0, dtype))
                continue
            m = (((iz + dz >= 0) & (iz + dz < nz))[:, None, None]
                 & ((iy + dy >= 0) & (iy + dy < ny))[None, :, None]
                 & ((ix + dx >= 0) & (ix + dx < nx))[None, None, :])
            planes.append(jnp.where(m, jnp.asarray(-1.0, dtype),
                                    jnp.asarray(0.0, dtype)))
            mf = m.astype(dtype)
            count = mf if count is None else count + mf
        dia = jnp.stack(planes).reshape(27, nx * ny * nz)
        rhs = (26.0 - count).astype(dtype).reshape(-1)
        return dia, rhs

    return offs[order], gen


def _dia_box_lattice(part, nx, ny, nz, pgrid, dtype):
    """Full-lattice DIA planes for one part: like ``_dia_box`` but masked by
    the GLOBAL domain, so couplings crossing part seams are included (the
    entries the box-consistent diag block zeroes and stores as offd).  This
    is the operator view the sharded device setup consumes
    (amg/device_setup_sharded.py): every part sees its true lattice rows
    and neighbor data arrives via halo exchange."""
    px, py, pz = pgrid
    ipx, ipy, ipz = part_to_grid(part, pgrid)
    gx0, gy0, gz0 = ipx * nx, ipy * ny, ipz * nz
    gx_max, gy_max, gz_max = px * nx, py * ny, pz * nz
    ix = np.arange(nx)
    iy = np.arange(ny)
    iz = np.arange(nz)
    offs = np.array([dz * ny * nx + dy * nx + dx
                     for dx, dy, dz in _OFFSETS], np.int64)
    order = np.argsort(offs)
    planes = np.zeros((27, nz, ny, nx), dtype)
    for k, kk in enumerate(order):
        dx, dy, dz = _OFFSETS[kk]
        if dx == dy == dz == 0:
            planes[k] = 26.0
            continue
        m = (((gz0 + iz + dz >= 0) & (gz0 + iz + dz < gz_max))[:, None, None]
             & ((gy0 + iy + dy >= 0)
                & (gy0 + iy + dy < gy_max))[None, :, None]
             & ((gx0 + ix + dx >= 0)
                & (gx0 + ix + dx < gx_max))[None, None, :])
        planes[k][m] = -1.0
    return offs[order], planes


def _dia_box_device_sharded(mesh, axis, nx, ny, nz, pgrid, dtype):
    """On-device per-part generation for multi-part meshes.

    Returns ``(offs, lat, dia, rhs)``: the offset list plus three SHARDED
    device arrays — the full-lattice plane stack (global-domain masks; the
    sharded device setup's operand), the box-consistent DIA stack (the
    SpMV diag block; box masks, a subset of the global masks), and the
    weak-scaling RHS (= row sums of the lattice stack, i.e. b = A @ 1).
    Host work is O(P) scalars — no GB-scale tables on paravirtual hosts.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from tpusolve.mesh import put_sharded

    px, py, pz = pgrid
    nparts = px * py * pz
    gx_max, gy_max, gz_max = px * nx, py * ny, pz * nz
    offs = np.array([dz * ny * nx + dy * nx + dx
                     for dx, dy, dz in _OFFSETS], np.int64)
    order = np.argsort(offs)
    base = np.array([part_to_grid(p, pgrid) for p in range(nparts)],
                    np.int32) * np.array([nx, ny, nz], np.int32)
    base_d = put_sharded(base, mesh, P(axis))

    @jax.jit
    @jax.vmap
    def gen(base):
        bx, by, bz = base[0], base[1], base[2]
        ix = jnp.arange(nx)
        iy = jnp.arange(ny)
        iz = jnp.arange(nz)
        lat, dia = [], []
        for kk in order:
            dx, dy, dz = _OFFSETS[kk]
            if dx == dy == dz == 0:
                c = jnp.full((nz, ny, nx), 26.0, dtype)
                lat.append(c)
                dia.append(c)
                continue
            gm = (((bz + iz + dz >= 0)
                   & (bz + iz + dz < gz_max))[:, None, None]
                  & ((by + iy + dy >= 0)
                     & (by + iy + dy < gy_max))[None, :, None]
                  & ((bx + ix + dx >= 0)
                     & (bx + ix + dx < gx_max))[None, None, :])
            bm = (((iz + dz >= 0) & (iz + dz < nz))[:, None, None]
                  & ((iy + dy >= 0) & (iy + dy < ny))[None, :, None]
                  & ((ix + dx >= 0) & (ix + dx < nx))[None, None, :])
            neg = jnp.asarray(-1.0, dtype)
            zero = jnp.asarray(0.0, dtype)
            lat.append(jnp.where(gm, neg, zero))
            dia.append(jnp.where(bm, neg, zero))   # box mask subset of gm
        lat = jnp.stack(lat)
        dia = jnp.stack(dia)
        rhs = jnp.sum(lat, axis=0).reshape(-1)     # b = A @ 1 (row sums)
        return lat, dia, rhs

    lat, dia, rhs = gen(base_d)
    return offs[order], lat, dia, rhs


def _local_offd_and_rhs(part, nx, ny, nz, pgrid, dtype):
    """Off-owner (ghost shell) entries + RHS for one part."""
    px, py, pz = pgrid
    ipx, ipy, ipz = part_to_grid(part, pgrid)
    gx_max, gy_max, gz_max = px * nx, py * ny, pz * nz
    box = nx * ny * nz
    ix = np.arange(nx)
    iy = np.arange(ny)
    iz = np.arange(nz)
    gx0, gy0, gz0 = ipx * nx, ipy * ny, ipz * nz

    count = np.zeros((nz, ny, nx), np.int8)
    olr, ogc = [], []
    for dx, dy, dz in _OFFSETS:
        if dx == dy == dz == 0:
            continue
        dom_x = (gx0 + ix + dx >= 0) & (gx0 + ix + dx < gx_max)
        dom_y = (gy0 + iy + dy >= 0) & (gy0 + iy + dy < gy_max)
        dom_z = (gz0 + iz + dz >= 0) & (gz0 + iz + dz < gz_max)
        in_dom = (dom_z[:, None, None] & dom_y[None, :, None]
                  & dom_x[None, None, :])
        count += in_dom
        box_x = (ix + dx >= 0) & (ix + dx < nx)
        box_y = (iy + dy >= 0) & (iy + dy < ny)
        box_z = (iz + dz >= 0) & (iz + dz < nz)
        in_box = (box_z[:, None, None] & box_y[None, :, None]
                  & box_x[None, None, :])
        crossing = in_dom & ~in_box
        kz, ky, kx = np.nonzero(crossing)
        if kx.size == 0:
            continue
        ngx = gx0 + kx + dx
        ngy = gy0 + ky + dy
        ngz = gz0 + kz + dz
        opx, olx = np.divmod(ngx, nx)
        opy, oly = np.divmod(ngy, ny)
        opz, olz = np.divmod(ngz, nz)
        opart = opz * (px * py) + opy * px + opx
        olr.append(kz * ny * nx + ky * nx + kx)
        ogc.append(opart * box + olz * (ny * nx) + oly * nx + olx)
    if olr:
        olr = np.concatenate(olr)
        ogc = np.concatenate(ogc)
    else:
        olr = np.zeros(0, np.int64)
        ogc = np.zeros(0, np.int64)
    ov = np.full(olr.shape, -1.0, dtype)
    rhs = (26.0 - count.reshape(-1)).astype(dtype)
    return (olr, ogc, ov), rhs


def laplace27(mesh, nx: int = 128, ny: int = 128, nz: int = 128, *,
              dtype=np.float64, pgrid: tuple[int, int, int] | None = None,
              axis: str = ROWS_AXIS, with_host: bool = False,
              with_parts: bool = False, device: bool | None = None,
              with_lattice: bool = False):
    """Build the sharded 27-pt system on ``mesh``.

    Returns ``(A, b, x_ref)``: the sharded matrix, the padded sharded RHS,
    and the padded reference solution (all-ones), matching the reference's
    weak-scaling fixture where global rows = nx*ny*nz*nparts
    (ref: src/HypreSystem.cpp:1516).

    ``with_host=True`` appends the host CSR as a 4th return value — pass it
    to ``boomeramg_setup(..., A_host=...)`` to avoid a device->host gather
    of the operator during preconditioner setup.  ``with_parts=True``
    appends the structured (dia dict, offd parts) payload instead — for
    ``structured_mg_setup_fast`` — reusing the generator's own arrays (no
    recomputation).
    """
    nparts = mesh.devices.size
    if pgrid is None:
        pgrid = compute_3d_process_distribution(nparts)
    px, py, pz = pgrid
    if px * py * pz != nparts:
        raise ValueError(f"process grid {pgrid} != mesh size {nparts}")
    box = nx * ny * nz
    n = box * nparts

    if device is None:
        # auto: big per-part boxes on an accelerator skip the host tables
        device = (nx >= 3 and ny >= 3
                  and not with_host and not with_parts
                  and box * 27 * np.dtype(dtype).itemsize >= 128 << 20
                  and mesh.devices.flat[0].platform != "cpu")
    if device:
        if nx < 3 or ny < 3 or with_host or with_parts:
            raise ValueError("device stencil generation requires nx/ny >= 3 "
                             "and no host payloads")
        import jax
        import jax.numpy as jnp
        from jax.sharding import NamedSharding, PartitionSpec as P
        sharding = NamedSharding(mesh, P(axis))
        if nparts == 1:
            offs, gen = _dia_box_device(nx, ny, nz, dtype)
            dia_dev, rhs_dev = gen()
            # no seams: lattice == box planes (built only when asked —
            # an eager [None] reshape is a full plane-stack copy)
            lat = dia_dev[None] if with_lattice else None
            # donated reshape: at 384^3 the 27-plane stack is 6.1 GB and
            # an undonated reshape copy (x2 here, x3 with the box
            # reshape in from_dia_parts) OOMs the 16 GB chip
            dia_dev = jax.jit(lambda v: v.reshape(1, 27, box),
                              donate_argnums=0)(dia_dev)
            offd_parts = [(np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, dtype))]
            b = jax.device_put(rhs_dev, sharding)
        else:
            offs, lat, dia_box, rhs_dev = _dia_box_device_sharded(
                mesh, axis, nx, ny, nz, pgrid, dtype)
            dia_dev = dia_box.reshape(nparts, 27, box)
            # offd (ghost shells) stays a host plan build: O(surface) data
            offd_parts = [_local_offd_and_rhs(p, nx, ny, nz, pgrid,
                                              dtype)[0]
                          for p in range(nparts)]
            b = jax.jit(lambda r: r.reshape(-1), out_shardings=sharding)(
                rhs_dev)
        # analytic diag-block nnz: 27-pt in-box couplings per part =
        # prod_d (3 n_d - 2) (each axis shift c in {-1,0,1} keeps
        # n_d - |c| planes)
        box_nnz = nparts * (3 * nz - 2) * (3 * ny - 2) * (3 * nx - 2)
        A = ShardedMatrix.from_dia_parts(
            mesh, (n, n), offs, dia_dev, offd_parts,
            dtype=dtype, axis=axis, dia_shape=(nz, ny, nx),
            dia_nnz=box_nnz)
        x_ref = jax.device_put(jnp.ones(n, dtype), sharding)
        if with_lattice:
            lattice = dict(stack=lat.reshape((nparts, 27, nz, ny, nx)),
                           offsets=offs, pgrid=pgrid, dims=(nz, ny, nx))
            return A, b, x_ref, lattice
        return A, b, x_ref

    if nx >= 3 and ny >= 3:
        # fast path: diag block = shared DIA geometry, offd = boundary shell
        offs, dia_one = _dia_box(nx, ny, nz, dtype)
        dia_vals = np.broadcast_to(dia_one[None], (nparts, 27, box))
        offd_parts, rhs_parts = [], []
        for part in range(nparts):
            offd, rhs = _local_offd_and_rhs(part, nx, ny, nz, pgrid, dtype)
            offd_parts.append(offd)
            rhs_parts.append(rhs)
        # dia_shape: 27-pt offsets are box-consistent on the (nz, ny, nx)
        # view — any dim-boundary crossing lands on zero coefficients
        A = ShardedMatrix.from_dia_parts(mesh, (n, n), offs, dia_vals,
                                         offd_parts, dtype=dtype, axis=axis,
                                         dia_shape=(nz, ny, nx))
        parts = None
        if with_parts:
            host_parts = (_dia_arrays_to_dict(offs, dia_one, (nz, ny, nx)),
                          offd_parts)
        if with_lattice:
            # full-lattice plane stacks (seam couplings included) for the
            # sharded device setup (amg/device_setup_sharded.py)
            import jax
            from jax.sharding import PartitionSpec as P
            from tpusolve.mesh import put_sharded
            stacks = np.stack([
                _dia_box_lattice(p, nx, ny, nz, pgrid, dtype)[1]
                for p in range(nparts)])
            lattice = dict(
                stack=put_sharded(stacks, mesh, P(axis)),
                offsets=offs, pgrid=pgrid, dims=(nz, ny, nx))
    else:
        # tiny boxes can alias DIA offsets; use the generic COO path
        parts, rhs_parts = [], []
        for part in range(nparts):
            p, rhs = _local_part(part, nx, ny, nz, pgrid, dtype)
            parts.append(p)
            rhs_parts.append(rhs)
        A = ShardedMatrix.from_local_parts(mesh, (n, n), parts, dtype=dtype,
                                           axis=axis)
    rhs_global = np.concatenate(rhs_parts)
    b = to_device_vector(mesh, rhs_global, A.row_offsets, A.row_pad,
                         dtype=dtype, axis=axis)
    x_ref = to_device_vector(mesh, np.ones(n, dtype), A.row_offsets,
                             A.row_pad, dtype=dtype, axis=axis)
    if with_lattice:
        if parts is not None:
            raise ValueError("with_lattice requires the DIA fast path "
                             "(nx, ny >= 3)")
        return A, b, x_ref, lattice
    if with_parts:
        if parts is not None:
            raise ValueError("with_parts requires the DIA fast path "
                             "(nx, ny >= 3)")
        return A, b, x_ref, host_parts
    if with_host:
        import scipy.sparse as sp
        if parts is None:
            # reconstruct from the DIA fast path — build the CSR directly
            # in row-major order (a COO detour re-sorts ~nnz entries:
            # minutes at 450M nnz)
            dia_t = np.ascontiguousarray(dia_one.T)       # (box, 27)
            from tpusolve.native import spk
            A_one = spk.dia_to_csr(dia_t, offs)
            if A_one is not None:
                # native one-pass extraction (no 2x-nnz index temporaries)
                cols_one = A_one.indices
                vals_one = A_one.data
                counts_one = np.diff(A_one.indptr)
            else:
                r_k, k_idx = np.nonzero(dia_t)            # row-major
                cols_one = (r_k + offs[k_idx]).astype(np.int32)
                vals_one = dia_t[r_k, k_idx].astype(np.float64)
                counts_one = np.count_nonzero(dia_t, axis=1)
            nnz_one = vals_one.size
            offd_nnz = sum(len(o[0]) for o in offd_parts)
            if nparts == 1 and offd_nnz == 0 and A_one is not None:
                return A, b, x_ref, A_one    # single box: no tiling copies
            indptr = np.empty(n + 1, np.int64)
            indptr[0] = 0
            np.cumsum(np.tile(counts_one, nparts), out=indptr[1:])
            indices = (np.tile(cols_one, nparts).astype(np.int64)
                       + np.repeat(np.arange(nparts) * box, nnz_one))
            data = np.tile(vals_one, nparts)
            A_host = sp.csr_matrix((data, indices, indptr), shape=(n, n))
            A_host.has_sorted_indices = True   # offsets ascend per row
            if offd_nnz:
                rows_l, cols_l, vals_l = [], [], []
                for part in range(nparts):
                    olr, ogc, ov = offd_parts[part]
                    rows_l.append(part * box + olr)
                    cols_l.append(ogc)
                    vals_l.append(ov.astype(np.float64))
                A_host = (A_host + sp.csr_matrix(
                    (np.concatenate(vals_l),
                     (np.concatenate(rows_l), np.concatenate(cols_l))),
                    shape=(n, n))).tocsr()
        else:
            rows_l, cols_l, vals_l = [], [], []
            for q, p in enumerate(parts):
                rows_l.append(p[0] + q * box)
                cols_l.append(p[1])
                # setup math (strength/interp/RAP) runs in f64 on the host
                # even when the device operators are f32
                vals_l.append(p[2].astype(np.float64))
            A_host = sp.csr_matrix(
                (np.concatenate(vals_l),
                 (np.concatenate(rows_l), np.concatenate(cols_l))),
                shape=(n, n))
        return A, b, x_ref, A_host
    return A, b, x_ref


def laplace27_scipy(nx, ny, nz, pgrid=(1, 1, 1)):
    """Host oracle: the same system as a scipy CSR + rhs (for tests)."""
    import scipy.sparse as sp
    nparts = int(np.prod(pgrid))
    rows, cols, vals, rhs_all = [], [], [], []
    box = nx * ny * nz
    for part in range(nparts):
        (lr, gc, v), rhs = _local_part(part, nx, ny, nz, pgrid, np.float64)
        rows.append(lr + part * box)
        cols.append(gc)
        vals.append(v)
        rhs_all.append(rhs)
    n = box * nparts
    A = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    return A, np.concatenate(rhs_all)


def _dia_arrays_to_dict(offs, dia_one, box):
    """(flat offsets, (27, R) values) -> {(dz,dy,dx): box array} views."""
    nz, ny, nx = box
    dia = {}
    for k, off in enumerate(offs):
        dz, r = divmod(int(off), ny * nx)
        if r > (ny * nx) // 2:
            dz, r = dz + 1, r - ny * nx
        dy, dx = divmod(r, nx)
        if dx > nx // 2:
            dy, dx = dy + 1, dx - nx
        # setup math (Galerkin RAP, smoother norms) runs in f64 regardless
        # of the device dtype
        dia[(dz, dy, dx)] = dia_one[k].reshape(box).astype(np.float64)
    return dia


def laplace27_host_parts(nparts: int, nx: int, ny: int, nz: int, *,
                         pgrid: tuple[int, int, int] | None = None,
                         dtype=np.float64):
    """Host-side structured payload for preconditioner setup.

    Returns ``(dia, offd)`` where ``dia`` maps offset tuples (dz, dy, dx) to
    box-shaped value arrays (identical for every device — the diag block is
    pure box geometry), and ``offd`` is the per-device list of
    (local_rows, global_cols, vals) boundary-shell entries.  Feed to
    ``structured_mg_setup(..., host_parts=...)`` to run the whole setup in
    DIA algebra (no sparse matrices, no device gathers).
    """
    from tpusolve.mesh import compute_3d_process_distribution
    if pgrid is None:
        pgrid = compute_3d_process_distribution(nparts)
    offs, dia_one = _dia_box(nx, ny, nz, dtype)
    dia = _dia_arrays_to_dict(offs, dia_one, (nz, ny, nx))
    offd = []
    for part in range(nparts):
        (olr, ogc, ov), _ = _local_offd_and_rhs(part, nx, ny, nz, pgrid,
                                                dtype)
        offd.append((olr, ogc, ov))
    return dia, offd
