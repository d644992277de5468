"""Device mesh construction and 1-D row-block decomposition.

The reference decomposes matrix rows into contiguous blocks across MPI ranks
(ref: src/HypreSystem.cpp:525-544 ``init_row_decomposition``): each rank gets
``total/nproc`` rows and the remainder is spread one row at a time over the
first ranks.  We reproduce that rule exactly so partition-dependent file
formats (HYPRE-IJ multi-file dumps) round-trip bit-identically, and map the
rank dimension onto a 1-D ``jax.sharding.Mesh`` axis (default name
``"rows"``).
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

ROWS_AXIS = "rows"


def row_decomposition(total_rows: int, nparts: int) -> np.ndarray:
    """Contiguous 1-D block partition offsets.

    Returns an int64 array ``offsets`` of shape ``(nparts + 1,)`` with part
    ``p`` owning global rows ``[offsets[p], offsets[p+1])``.  Matches the
    reference rule (src/HypreSystem.cpp:529-535): ``rowsPerProc = total //
    nparts`` with the remainder spread over the first ranks.
    """
    if nparts <= 0:
        raise ValueError(f"nparts must be positive, got {nparts}")
    if total_rows < 0:
        raise ValueError(f"total_rows must be >= 0, got {total_rows}")
    base = total_rows // nparts
    rem = total_rows % nparts
    counts = np.full(nparts, base, dtype=np.int64)
    counts[:rem] += 1
    offsets = np.zeros(nparts + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets


def owner_of(indices: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """Owning part for each global index under a block partition."""
    return np.searchsorted(offsets, np.asarray(indices), side="right") - 1


def fetch_host(x) -> np.ndarray:
    """Host fetch that also works for multi-process (non-addressable)
    arrays: allgather the local shards first.  The host-side consumers
    (setup plans, writers, checks) are rank-replicated, like the
    reference's (src/HypreSystem.cpp:771-845)."""
    if (isinstance(x, jax.Array) and jax.process_count() > 1
            and not x.is_fully_addressable):
        from jax.experimental import multihost_utils
        x = multihost_utils.process_allgather(x, tiled=True)
    return np.asarray(x)


def put_sharded(a, mesh: Mesh, spec) -> jax.Array:
    """Multi-process-safe ``device_put(a, NamedSharding(mesh, spec))``.

    Single-process: a plain ``device_put``.  Multi-process: each host's
    staging arrays carry real data only in the rows its devices own (the
    per-host ingestion filter), so a global ``device_put`` would trip
    JAX's same-value-on-every-process assert; ``make_array_from_callback``
    instead materializes only this host's *addressable* shards from the
    host-global-shaped buffer.  (Ref analog: per-rank SetValues into a
    distributed IJ matrix, src/HypreSystem.cpp:1540-1597.)
    """
    from jax.sharding import NamedSharding
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(a, sharding)
    return jax.make_array_from_callback(a.shape, sharding,
                                        lambda idx: a[idx])


def local_range(offsets: np.ndarray, part: int) -> tuple[int, int]:
    """(iLower, iUpper) inclusive range for a part, reference-style."""
    return int(offsets[part]), int(offsets[part + 1]) - 1


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Multi-process runtime init — the analog of the reference's
    ``MPI_Init`` (src/main.cpp:33-35).  One JAX process per host (or per
    group of cards); afterwards ``jax.devices()`` spans every process, so
    the same ``make_mesh``/``shard_map`` code runs unchanged.

    Multi-process is strictly *opt-in*: it starts only when a coordinator
    address is given (argument or ``JAX_COORDINATOR_ADDRESS``), with
    ``num_processes``/``process_id`` from the arguments or
    ``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``.  Returns True when a
    multi-process runtime was initialized, False when no coordinator was
    given or a backend is already live (library use, tests).  A failed
    initialization raises: a run that asked for several processes must not
    quietly continue as one.
    """
    import os
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return False  # single-process run: nothing to do
    from jax._src import xla_bridge
    if xla_bridge.backends_are_initialized():
        # Backend already up (library use, tests): too late to go
        # multi-process; stay single-process rather than raising.
        return False
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    return True


def make_mesh(n_devices: int | None = None, axis: str = ROWS_AXIS,
              devices=None) -> Mesh:
    """Build a 1-D device mesh over the row axis.

    ``n_devices=None`` uses all available devices — across *all* processes
    after :func:`init_distributed`.  The reference binds
    one GPU per MPI rank (src/main.cpp:9-29); here every addressable device
    is a mesh coordinate and SPMD replaces the process model.
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices but only {len(devices)} available")
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


def host_row_range(mesh: Mesh, offsets: np.ndarray) -> tuple[int, int]:
    """Inclusive global row range owned by this process's addressable
    devices — the analog of the reference's per-rank overlap-filtered
    file reads (src/HypreSystem.cpp:1147, 1203-1236).  Each host needs to
    read/stage only this slice; with one process it is the full range."""
    import jax as _jax
    pid = _jax.process_index()
    devs = list(mesh.devices.ravel())
    local = [i for i, d in enumerate(devs)
             if getattr(d, "process_index", 0) == pid]
    if not local:
        return 0, -1
    return int(offsets[min(local)]), int(offsets[max(local) + 1] - 1)


def allgather_host_coo(rows: np.ndarray, cols: np.ndarray,
                       vals: np.ndarray) -> tuple:
    """Gather per-host COO row blocks into the global triple on every host.

    The sharded readers stage only each host's ``host_row_range`` rows (the
    analog of the reference's per-rank overlap-filtered reads,
    src/HypreSystem.cpp:1203-1236), but host-side factorization (AMG/ILU
    setup) needs the *global* matrix — the reference's setup is distributed
    inside HYPRE (src/HypreSystem.cpp:600-636, 692).  This allgather is the
    correctness bridge: cheap (one round of the raw triples) relative to
    the setup it feeds.  No-op single-process.
    """
    if jax.process_count() == 1:
        return rows, cols, vals
    from jax.experimental import multihost_utils

    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    lens = multihost_utils.process_allgather(
        np.array([rows.size], np.int64)).ravel()
    maxlen = int(lens.max())

    def _pad(a):
        out = np.zeros(maxlen, a.dtype)
        out[:a.size] = a
        return out

    gr = np.asarray(multihost_utils.process_allgather(_pad(rows)))
    gc = np.asarray(multihost_utils.process_allgather(_pad(cols)))
    gv = np.asarray(multihost_utils.process_allgather(_pad(vals)))
    parts_r, parts_c, parts_v = [], [], []
    for p in range(gr.shape[0]):
        k = int(lens[p])
        parts_r.append(gr[p, :k])
        parts_c.append(gc[p, :k])
        parts_v.append(gv[p, :k])
    return (np.concatenate(parts_r), np.concatenate(parts_c),
            np.concatenate(parts_v))


def compute_3d_process_distribution(nparts: int) -> tuple[int, int, int]:
    """Factor ``nparts`` into a 3-D process grid (px, py, pz).

    Functional equivalent of the reference's prime-factorization grid
    builder (src/laplace_3d_weak_scaling.hpp:98-169): distribute prime
    factors across the three dimensions, largest factors first, always onto
    the currently smallest dimension, yielding a near-cubic grid.
    """
    if nparts <= 0:
        raise ValueError(f"nparts must be positive, got {nparts}")
    factors = []
    n = nparts
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.append(d)
            n //= d
        d += 1
    if n > 1:
        factors.append(n)
    grid = [1, 1, 1]
    for f in sorted(factors, reverse=True):
        grid[int(np.argmin(grid))] *= f
    px, py, pz = sorted(grid, reverse=True)
    return px, py, pz
