"""tpusolve — a distributed sparse linear solver framework in JAX.

A from-scratch JAX/XLA rebuild of the capability set of the
Exawind/hypre-mini-app benchmark driver (reference: /root/reference), which
delegates its numerics to LLNL HYPRE.  Here the full solve path — sharded
ParCSR-analog sparse matrices, halo exchange between devices, Krylov solvers
(PCG/GMRES/COGMRES/FlexGMRES/BiCGSTAB), BoomerAMG-style algebraic multigrid,
and ILU smoothing — is implemented as jitted device programs:

* compute path: jitted JAX over DIA, blocked-DIA, block-ELL and padded-ELL
  layouts,
* distribution: ``jax.sharding.Mesh`` + ``shard_map`` with XLA collectives
  (``psum`` for dot products, ``all_to_all`` for halo exchange) in place of
  the reference's MPI (ref: src/main.cpp:33-35),
* harness: the same YAML schema, 8-step lifecycle and named phase timers as
  the reference driver (ref: src/main.cpp:164-216).
"""

__version__ = "0.1.0"

import os as _os

import numpy as _np

if _os.environ.get("TPUSOLVE_HUGEPAGE", "0") != "1":
    # Process-wide THP opt-out (PR_SET_THP_DISABLE): covers glibc arena
    # mmaps and third-party allocators, not just numpy's own madvise —
    # measured 28x faster first-touch of fresh numpy buffers on this
    # fragmented paravirtual host (2.0 s -> 0.07 s per 3M-element op).
    try:
        import ctypes as _ct
        _ct.CDLL("libc.so.6", use_errno=True).prctl(41, 1, 0, 0, 0)
    except Exception:  # pragma: no cover - non-Linux
        pass
    # numpy's default MADV_HUGEPAGE makes every large allocation stall on
    # synchronous THP compaction once host memory fragments — measured
    # multi-second pauses inside basic 7M-element ops on paravirtualized
    # hosts (assembly of a 7M-nnz operator: 36 s -> 2.9 s with it off).
    # The runtime switch works even though numpy is already imported.
    for _mod in ("_core", "core"):
        try:
            getattr(_np, _mod).multiarray._set_madvise_hugepage(False)
            break
        except (AttributeError, TypeError):
            continue

if _os.environ.get("TPUSOLVE_POOL_ALLOC", "1") == "1":
    # Pooling numpy data allocator (native/npool.c): large temporaries are
    # carved from one persistent arena and reused — without it, glibc
    # munmaps them and every reuse re-faults fresh mmap pages at ~45 us/4KB
    # on paravirtual hosts (observed: setup phases >90% in page faults once
    # the main-heap brk is blocked by the JAX runtime's mappings).
    try:
        from tpusolve.native.build import get_npool as _get_npool
        _npool = _get_npool()
        if _npool is not None:
            _npool.install()
    except Exception:
        pass

if _os.environ.get("TPUSOLVE_MALLOC_TUNE", "1") == "1":
    # Large numpy temporaries default to per-allocation mmap, which glibc
    # munmaps on free — so every setup-phase temporary re-faults its pages.
    # On paravirtualized hosts a fresh-mmap fault costs ~45 us/4KB page
    # (measured), making GB-scale sparse setup allocation-bound.  Routing
    # large blocks through the (persistent, fast-faulting) main heap fixed
    # a varied 2 GB alloc+fill loop from ~25 s to 0.3 s.
    try:
        import ctypes as _ct
        _libc = _ct.CDLL("libc.so.6", use_errno=True)
        _libc.mallopt(-3, 2**31 - 1)   # M_MMAP_THRESHOLD: keep on heap
        _libc.mallopt(-1, 2**31 - 1)   # M_TRIM_THRESHOLD: never give back
    except (OSError, AttributeError):
        pass

from tpusolve.mesh import make_mesh, row_decomposition
from tpusolve.matrix.sharded import ShardedMatrix
from tpusolve.matrix.vectors import to_device_vector, from_device_vector
from tpusolve.matrix.spmv import spmv

__all__ = [
    "make_mesh",
    "row_decomposition",
    "ShardedMatrix",
    "spmv",
    "to_device_vector",
    "from_device_vector",
]
