"""Layout materialization: compact COO-style staging -> padded device arrays.

The padded layouts this framework's kernels consume (ELL / DIA / block-ELL
tiles) are *much* larger than the nnz-compact data they're built from — a
7M-nnz unstructured diag block can expand to a multi-GB tile array.  Building
those on the host and shipping them over is wrong twice:

* host first-touch page faults dominate (a GB-scale ``np.zeros`` that is then
  sparsely written touches every page), and
* the host->device link then streams the *expanded* bytes instead of the
  compact ones.

So, like the reference's on-GPU assembly path (device CSR staging +
``HYPRE_IJMatrixSetValues2`` on device pointers, ref:
src/HypreSystem.cpp:1540-1597), large layouts are materialized **on device**:
the host prepares compact ``(flat_index, value)`` staging arrays, uploads
those (sharded), and one jitted ``shard_map`` scatter writes the padded
layout directly into device memory.  Small layouts keep the host fill — not worth a
kernel compilation.

Staging shapes are bucketed to powers of two (index ``-1`` + ``mode="drop"``
padding) so repeated builds (AMG hierarchy levels) reuse compiled scatter
kernels whenever their output shapes coincide.
"""

from __future__ import annotations

import os
import time

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

# Outputs at least this large are scatter-built on device; smaller ones are
# filled on host.  The device path is strictly better for large layouts:
#
# * a host build costs first-touch page faults on the padded array plus the
#   host->device transfer of the *expanded* bytes.
# * a device build transfers only the compact nnz-sized staging and writes
#   the padded layout on the device.  Its one cost is an XLA compilation per
#   new scatter shape — amortized by (a) pow2-bucketing both the staging
#   length and the flat output size so hierarchy levels share compiled
#   kernels, and (b) the persistent compilation cache
#   (tpusolve.runtime.enable_compile_cache) across processes.
#
# TPUSOLVE_DEVICE_BUILD_MIN_MB overrides the threshold.
_DEFAULT_MIN_BYTES = 64 << 20


def device_build_min_bytes() -> int:
    env = os.environ.get("TPUSOLVE_DEVICE_BUILD_MIN_MB")
    if env is not None:
        return int(float(env) * (1 << 20))
    return _DEFAULT_MIN_BYTES


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


_builder_cache: dict = {}


def _scatter_builder(mesh, axis, flat_pad, dtype, nnz_pad):
    """Compiled scatter into a pow2-length flat shard.  Keyed on pow2 sizes
    only, so AMG hierarchy levels of different true sizes share kernels."""
    key = ("scat", id(mesh), axis, flat_pad, np.dtype(dtype).str, nnz_pad)
    fn = _builder_cache.get(key)
    if fn is not None:
        return fn

    def shard_fn(idx, vals):
        flat = jnp.zeros((flat_pad,), dtype)
        flat = flat.at[idx[0]].set(vals[0], mode="drop", unique_indices=True)
        return flat.reshape((1, flat_pad))

    spec = P(axis)
    fn = jax.jit(jax.shard_map(shard_fn, mesh=mesh,
                           in_specs=(spec, spec), out_specs=spec))
    _builder_cache[key] = fn
    return fn


def _reshaper(mesh, axis, flat_pad, per_size, shape_tail, dtype, nparts):
    """Trivial (cheap-to-compile) slice+reshape from the pow2 flat build to
    the layout's true shape."""
    key = ("resh", id(mesh), axis, flat_pad, per_size, tuple(shape_tail),
           np.dtype(dtype).str)
    fn = _builder_cache.get(key)
    if fn is not None:
        return fn
    sharding = NamedSharding(mesh, P(axis))
    fn = jax.jit(
        lambda a: a[:, :per_size].reshape((nparts,) + tuple(shape_tail)),
        out_shardings=sharding)
    _builder_cache[key] = fn
    return fn


def materialize_sharded(mesh, axis, idx_parts, val_parts, shape_tail, dtype):
    """Build an ``(nparts, *shape_tail)`` array sharded over ``axis`` with
    ``out[p].reshape(-1)[idx_parts[p]] = val_parts[p]`` and zeros elsewhere.

    ``idx_parts[p]``: int array of flat indices into one shard's output
    (unique per shard); ``val_parts[p]``: matching values.
    """
    nparts = len(idx_parts)
    shape_tail = tuple(int(s) for s in shape_tail)
    per_size = int(np.prod(shape_tail))
    dtype = np.dtype(dtype)
    total_bytes = nparts * per_size * dtype.itemsize
    sharding = NamedSharding(mesh, P(axis))

    want_device = total_bytes >= device_build_min_bytes() and per_size < 2**31
    if want_device and dtype == np.float64 and not jax.config.jax_enable_x64:
        want_device = False  # jnp would silently downcast the staging values

    log_on = os.environ.get("TPUSOLVE_SETUP_LOG", "0") == "1"
    if not want_device:
        t0 = time.perf_counter()
        out = np.zeros((nparts, per_size), dtype)
        for p in range(nparts):
            if len(idx_parts[p]):
                out[p][np.asarray(idx_parts[p])] = val_parts[p]
        t1 = time.perf_counter()
        from tpusolve.mesh import put_sharded
        res = put_sharded(out.reshape((nparts,) + shape_tail), mesh, P(axis))
        if log_on and total_bytes > (64 << 20):
            res.block_until_ready()
            print(f"      materialize host {total_bytes/1e6:.0f}MB "
                  f"fill {t1 - t0:.2f}s put {time.perf_counter() - t1:.2f}s",
                  flush=True)
        return res

    t0 = time.perf_counter()
    nnz_pad = _pow2ceil(max(1, max(len(i) for i in idx_parts)))
    flat_pad = _pow2ceil(per_size)
    idx_st = np.full((nparts, nnz_pad), -1, np.int32)
    val_st = np.zeros((nparts, nnz_pad), dtype)
    for p in range(nparts):
        k = len(idx_parts[p])
        if k:
            idx_st[p, :k] = idx_parts[p]
            val_st[p, :k] = val_parts[p]
    from tpusolve.mesh import put_sharded
    idx_d = put_sharded(idx_st, mesh, P(axis))
    val_d = put_sharded(val_st, mesh, P(axis))
    fn = _scatter_builder(mesh, axis, flat_pad, dtype, nnz_pad)
    flat = fn(idx_d, val_d)
    if flat_pad == per_size and len(shape_tail) == 1:
        res = flat
    else:
        res = _reshaper(mesh, axis, flat_pad, per_size, shape_tail, dtype,
                        nparts)(flat)
    if log_on and total_bytes > (64 << 20):
        res.block_until_ready()
        print(f"      materialize device {total_bytes/1e6:.0f}MB "
              f"({nparts * nnz_pad * (4 + dtype.itemsize) / 1e6:.0f}MB "
              f"staged) {time.perf_counter() - t0:.2f}s", flush=True)
    return res
