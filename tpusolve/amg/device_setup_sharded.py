"""Sharded (multi-device) device-side fine-level AMG setup.

``device_setup.device_level0`` runs the fine level on ONE device; the
north-star problems (BASELINE.json: 100M rows) shard the fine
operator over a device mesh.  This module runs the same offset-lattice
algebra on every part simultaneously, with part seams handled by explicit
z/y/x halo exchanges (``lax.ppermute`` under ``shard_map`` — the
analog of the reference's distributed BoomerAMGSetup neighbor exchanges,
src/HypreSystem.cpp:692 with hypre's comm pkg underneath).

Inputs: the generator's *full-lattice* plane stacks (stencil.laplace27
``with_lattice=True``): per part, the (D, nz, ny, nx) DIA planes masked by
the GLOBAL domain, so seam couplings (the diag block's offd entries) are
present in the planes and neighbor operands arrive via halo.

Key geometry facts this module relies on:

* parts form a (px, py, pz) grid (stencil.part_to_grid ordering: ipx
  fastest); the global row id is ``part * box + local`` — for a z-major
  1-D grid this is linear in z across seams, but NO index arithmetic is
  used across seams anyway: *identity planes* (global coarse / fine ids)
  are halo-exchanged like data, so column indices are exact for any pgrid;
* every stage's neighbor reads are bounded by the offset extremes, so a
  pre-exchanged halo of width m = _pad_m(comps) (or 1 for distance-1
  stages) makes all inner math part-local — the existing scan-contraction
  machinery (device_setup._scan_accumulate) runs unchanged under vmap;
* halos at the global boundary must be ZERO — exactly what ppermute's
  "no source" fill provides.

The produced hierarchy matches the host pipeline's up to accumulation-
order roundoff (tests/test_device_setup.py::TestShardedDeviceSetup).
"""

from __future__ import annotations

import time as _time
from functools import partial

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

from tpusolve.matrix.sharded import ShardedMatrix
from tpusolve.matrix.spmv import _decompose_offset
from tpusolve.amg.device_setup import (
    _comps_add, _comps_neg, _flat, _pad_m, _pow2ceil_i, _rap_terms,
    _round_up, _scan_accumulate, _strength_planes, MAX_DEVICE_OFFSETS,
    UNDECIDED, C_PT, F_PT)


from tpusolve.mesh import fetch_host as _fetch


def _shard_map(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs)


# ----------------------------------------------------------------------
# halo exchange

def _part_index(pgrid):
    px, py, pz = pgrid

    def idx(ix, iy, iz):
        return iz * px * py + iy * px + ix

    return idx


def _perms(pgrid):
    """Static ppermute pairs per axis and direction.  ``<ax>+`` sends each
    part's data to its +1 neighbor (filling that neighbor's LOW pad)."""
    px, py, pz = pgrid
    idx = _part_index(pgrid)
    out = {k: [] for k in ("x+", "x-", "y+", "y-", "z+", "z-")}
    for iz in range(pz):
        for iy in range(py):
            for ix in range(px):
                if ix + 1 < px:
                    out["x+"].append((idx(ix, iy, iz), idx(ix + 1, iy, iz)))
                    out["x-"].append((idx(ix + 1, iy, iz), idx(ix, iy, iz)))
                if iy + 1 < py:
                    out["y+"].append((idx(ix, iy, iz), idx(ix, iy + 1, iz)))
                    out["y-"].append((idx(ix, iy + 1, iz), idx(ix, iy, iz)))
                if iz + 1 < pz:
                    out["z+"].append((idx(ix, iy, iz), idx(ix, iy, iz + 1)))
                    out["z-"].append((idx(ix, iy, iz + 1), idx(ix, iy, iz)))
    return out


def _halo3_block(a, h, axis, perms):
    """Inside shard_map: (..., nz, ny, nx) -> (..., nz+2h, ny+2h, nx+2h)
    with neighbor slabs in the pads (zeros at the global boundary).  The
    x -> y -> z pass order forwards already-padded slabs, so edge/corner
    halos fill without diagonal exchanges."""

    def ex(a, axid, kplus, kminus):
        sz = a.shape[axid]
        hi = lax.slice_in_dim(a, sz - h, sz, axis=axid)
        lo = lax.slice_in_dim(a, 0, h, axis=axid)
        lo_pad = (lax.ppermute(hi, axis, perms[kplus]) if perms[kplus]
                  else jnp.zeros_like(hi))
        hi_pad = (lax.ppermute(lo, axis, perms[kminus]) if perms[kminus]
                  else jnp.zeros_like(lo))
        return jnp.concatenate([lo_pad, a, hi_pad], axis=axid)

    a = ex(a, a.ndim - 1, "x+", "x-")
    a = ex(a, a.ndim - 2, "y+", "y-")
    a = ex(a, a.ndim - 3, "z+", "z-")
    return a


def _mk_exchange(mesh, axis, pgrid, h):
    """Standalone jitted halo exchange for a sharded (P, ..., nz, ny, nx)
    array."""
    perms = _perms(pgrid)

    def f(a):
        return _halo3_block(a, h, axis, perms)

    return jax.jit(_shard_map(f, mesh, P(axis), P(axis)))


def _shift_h(a_h, comps, h):
    """out[idx] = a[idx + comps] read from an h-haloed (*dims + 2h) box."""
    dims = tuple(s - 2 * h for s in a_h.shape[-3:])
    sl = tuple(slice(h + c, h + c + d) for c, d in zip(comps, dims))
    return a_h[(...,) + sl]


# ----------------------------------------------------------------------
# eligibility

def eligible(A: ShardedMatrix, cfg, lattice) -> bool:
    import os
    if os.environ.get("TPUSOLVE_HOST_SETUP", "0") == "1":
        return False
    if lattice is None or A.nparts <= 1 or not A.uses_dia:
        return False
    if A.shape[0] != A.shape[1]:
        return False
    if int(np.prod(lattice["pgrid"])) != A.nparts:
        return False
    if len(lattice["offsets"]) > MAX_DEVICE_OFFSETS:
        return False
    dims = tuple(int(d) for d in lattice["dims"])
    try:
        comps = [_decompose_offset(int(o), dims)
                 for o in lattice["offsets"]]
    except Exception:
        return False
    maxc = max((abs(c) for comp in comps for c in comp), default=0)
    # halo slabs (width up to 3*max|c| for the coarse-offset lookups) must
    # fit inside one part's box
    if min(dims) < 3 * max(1, maxc):
        return False
    if A.shape[0] < int(os.environ.get("TPUSOLVE_DEVICE_SETUP_MIN_N",
                                       1 << 16)):
        return False
    from tpusolve.amg.device_setup import config_eligible
    return config_eligible(cfg)


# ----------------------------------------------------------------------
# stage 1: strength + PMIS (one shard_map; per-round halo refresh)

def _stage1_sharded(mesh, axis, pgrid, comps, diag_slot, theta, max_rounds,
                    n2):
    """``n2``: power-of-two bound on the global rank space (the tie-break
    is an exact uint32 key — see device_setup.pmis_rank)."""
    perms = _perms(pgrid)
    D = len(comps)

    def block(Lb, rankb):
        Av = Lb[0]
        rank = rankb[0]
        Sm = _strength_planes(Av, comps, diag_slot, theta)
        Sm_h = _halo3_block(Sm, 1, axis, perms)
        infl = jnp.zeros_like(Av[0])
        for d in range(D):
            infl = infl + _shift_h(Sm_h[d], _comps_neg(comps[d]), 1)
        from tpusolve.amg.device_setup import _pmis_keys
        w = _pmis_keys(infl, rank, n2)
        DEAD = jnp.uint32(0)             # halo/shift zero-fill is inert

        rev = {tuple(c): i for i, c in enumerate(comps)}
        G = []
        for d in range(D):
            g = Sm[d]
            dneg = rev.get(tuple(_comps_neg(comps[d])))
            if dneg is not None:
                g = jnp.maximum(g, _shift_h(Sm_h[dneg], comps[d], 1))
            G.append(g)
        G = jnp.stack(G)

        state0 = jnp.where(infl == 0, F_PT, UNDECIDED).astype(jnp.int32)
        rem0 = lax.psum(jnp.sum(state0 == UNDECIDED), axis)

        def body(carry):
            state, rem, it = carry
            active = state == UNDECIDED
            wa = jnp.where(active, w, DEAD)
            wa_h = _halo3_block(wa, 1, axis, perms)
            nbrmax = jnp.full_like(w, DEAD)
            for d in range(D):
                moved = _shift_h(wa_h, comps[d], 1)
                nbrmax = jnp.maximum(nbrmax,
                                     jnp.where(G[d] > 0, moved, DEAD))
            newC = active & (wa > nbrmax)
            newCf_h = _halo3_block(newC.astype(Av.dtype), 1, axis, perms)
            hitC = jnp.zeros_like(Av[0])
            for d in range(D):
                hitC = hitC + Sm[d] * _shift_h(newCf_h, comps[d], 1)
            state = jnp.where(newC, C_PT, state)
            state = jnp.where(active & ~newC & (hitC > 0), F_PT, state)
            rem = lax.psum(jnp.sum(state == UNDECIDED), axis)
            return state, rem, it + 1

        def cond(carry):
            state, rem, it = carry
            return (it < max_rounds) & (rem > 0)

        state, _, _ = lax.while_loop(cond, body,
                                     (state0, rem0, jnp.int32(0)))
        state = jnp.where(state == UNDECIDED, C_PT, state)
        Cmask = (state == C_PT).astype(Av.dtype)
        return Sm[None], Cmask[None]

    return jax.jit(_shard_map(block, mesh, (P(axis), P(axis)),
                              (P(axis), P(axis))))


# ----------------------------------------------------------------------
# stage 2: interpolation (vmapped local math on pre-haloed operands)

def _interp_direct_sharded(Av, Sm, Cmask_h, comps, diag_slot):
    """Per-part direct interpolation (interp_type 3) with haloed Cmask —
    mirrors device_setup._interp_planes' direct branch."""
    D = len(comps)
    dt = Av.dtype
    diag = Av[diag_slot]
    Cmask = _shift_h(Cmask_h, (0, 0, 0), 1)
    Fmask = 1.0 - Cmask
    strongC = [Sm[d] * _shift_h(Cmask_h, comps[d], 1) for d in range(D)]
    neg = [(Av[d] < 0).astype(dt) for d in range(D)]
    pos = [(Av[d] > 0).astype(dt) for d in range(D)]
    sum_neg = sum(Av[d] * neg[d] for d in range(D) if d != diag_slot)
    sum_pos = sum(Av[d] * pos[d] for d in range(D) if d != diag_slot)
    sC_neg = sum(Av[d] * neg[d] * strongC[d] for d in range(D))
    sC_pos = sum(Av[d] * pos[d] * strongC[d] for d in range(D))
    alpha = jnp.where(sC_neg != 0,
                      sum_neg / jnp.where(sC_neg != 0, sC_neg, 1.0), 0.0)
    beta = jnp.where(sC_pos != 0,
                     sum_pos / jnp.where(sC_pos != 0, sC_pos, 1.0), 0.0)
    dlump = jnp.where(sC_pos == 0, sum_pos, 0.0)
    dii = diag + dlump
    dii = jnp.where(dii != 0, dii, 1.0)
    Pl = []
    for d in range(D):
        if d == diag_slot:
            Pl.append(Cmask.astype(dt))
            continue
        scale = jnp.where(Av[d] < 0, alpha, beta)
        Pl.append(Fmask * strongC[d] * (-scale * Av[d] / dii))
    return jnp.stack(Pl)


def _interp_classical_sharded(Av, Sm, Cmask_h, Ahatp, Cmp, comps,
                              diag_slot, dims, dt):
    """Per-part classical-modified interpolation; the distance-2 terms run
    as the same term-table scans as device_setup._interp_classical_staged,
    with halos (in Ahatp/Cmp pads) instead of zero pads."""
    D = len(comps)
    m = 1
    for_d = {tuple(c): i for i, c in enumerate(comps)}
    z0 = [0] * len(dims)

    def scan_table(factors, out_idx, nout):
        T = len(out_idx)
        Tpad = _pow2ceil_i(T)
        fpad = [(stack, list(idx) + [0] * (Tpad - T),
                 list(starts) + [z0] * (Tpad - T))
                for stack, idx, starts in factors]
        oo = list(out_idx) + [nout] * (Tpad - T)
        out = _scan_accumulate(nout + 1, dims, dt, fpad, oo)
        return out[:nout]

    i_s, i_cm, i_a, s_cm, s_a, s_0, oo = [], [], [], [], [], [], []
    for df in range(D):
        for dc in range(D):
            e = for_d.get(tuple(_comps_add(comps[dc],
                                           _comps_neg(comps[df]))))
            if e is None:
                continue
            i_s.append(dc)
            i_cm.append(0)
            i_a.append(e)
            s_0.append(z0)
            s_cm.append([m + c for c in comps[dc]])
            s_a.append([m + c for c in comps[df]])
            oo.append(df)
    Dden = scan_table([(Sm, i_s, s_0), (Cmp, i_cm, s_cm),
                       (Ahatp, i_a, s_a)], oo, D)

    Cmask = _shift_h(Cmask_h, (0, 0, 0), 1)
    Fm_h = 1.0 - Cmask_h      # halo pads: 1 - 0 = "F" outside the domain…
    # …but strongF multiplies by Sm which is 0 toward out-of-domain, so the
    # wrong halo parity is never read where it matters
    W, dlump, sum_weak = [], 0.0, 0.0
    for df in range(D):
        strongF = Sm[df] * _shift_h(Fm_h, comps[df], 1)
        dead = strongF * (Dden[df] == 0)
        dlump = dlump + Av[df] * dead
        W.append(jnp.where(dead > 0, 0.0,
                           strongF * Av[df]
                           / jnp.where(Dden[df] != 0, Dden[df], 1.0)))
        if df != diag_slot:
            weak = (Av[df] != 0).astype(dt) * (1.0 - Sm[df])
            sum_weak = sum_weak + Av[df] * weak
    diag = Av[diag_slot]
    dii = diag + sum_weak + dlump
    dii = jnp.where(dii != 0, dii, 1.0)
    W = jnp.stack(W)

    i_w, i_a2, s_a2, oo2 = [], [], [], []
    for dc in range(D):
        for df in range(D):
            e = for_d.get(tuple(_comps_add(comps[dc],
                                           _comps_neg(comps[df]))))
            if e is None:
                continue
            i_w.append(df)
            i_a2.append(e)
            s_a2.append([m + c for c in comps[df]])
            oo2.append(dc)
    T = scan_table([(W, i_w, [z0] * len(i_w)), (Ahatp, i_a2, s_a2)],
                   oo2, D)

    Fm = 1.0 - Cmask
    Pl = []
    for dc in range(D):
        if dc == diag_slot:
            Pl.append(Cmask.astype(dt))
            continue
        strongC = Sm[dc] * _shift_h(Cmask_h, comps[dc], 1)
        num = Av[dc] * strongC + strongC * T[dc]
        Pl.append(Fm * (-num / dii))
    return jnp.stack(Pl)


# ----------------------------------------------------------------------
# orchestrator

def device_level0_sharded(A: ShardedMatrix, cfg, lattice, seed: int = 1234,
                          log=None):
    """Run the fine-level setup sharded over the mesh.  Returns the same
    result dict as device_setup.device_level0, or None if coarsening
    stalls."""
    t0 = _time.perf_counter()

    def _phase(label):
        if log is not None:
            t = _time.perf_counter()
            print(f"    setup[dev-sharded]: {label:22s} {t - t0:8.2f}s",
                  flush=True)
        return _time.perf_counter()

    mesh = A.mesh
    axis = A.axis
    pgrid = tuple(int(x) for x in lattice["pgrid"])
    dims = tuple(int(d) for d in lattice["dims"])
    offsets = tuple(int(o) for o in lattice["offsets"])
    comps = [_decompose_offset(off, dims) for off in offsets]
    diag_slot = offsets.index(0)
    D = len(comps)
    P_ = A.nparts
    box = int(np.prod(dims))
    n = A.shape[0]
    L = lattice["stack"]                     # (P, D, nz, ny, nx) sharded
    if L.dtype != A.dtype:
        L = L.astype(A.dtype)    # precision policy: follow the solve dtype
    dt = L.dtype

    # --- strength + PMIS (exact-integer tie-break keys, see
    # device_setup.pmis_rank) ---
    theta = float(cfg.strong_threshold)
    from tpusolve.amg.device_setup import pmis_rank
    rank = pmis_rank(seed, n, n).reshape((P_,) + dims)
    from tpusolve.mesh import put_sharded
    rank = put_sharded(rank, mesh, P(axis))
    max_rounds = 10 * int(np.ceil(np.log2(n + 2))) + 20
    n2 = 1 << max(int(n - 1).bit_length(), 1)
    stage1 = _stage1_sharded(mesh, axis, pgrid, comps, diag_slot, theta,
                             max_rounds, n2)
    Sm, Cmask = stage1(L, rank)
    counts = _fetch(jnp.sum(Cmask.reshape(P_, -1), axis=1)).astype(
        np.int64)
    nc = int(counts.sum())
    t0 = _phase("strength+PMIS")
    if nc == 0 or nc >= n:
        return None

    # --- interpolation ---
    exch1 = _mk_exchange(mesh, axis, pgrid, 1)
    Cmask_h = exch1(Cmask)
    if cfg.interp_type == 3:
        Pv = jax.jit(jax.vmap(
            lambda Av, Sm, Ch: _interp_direct_sharded(
                Av, Sm, Ch, comps, diag_slot)))(L, Sm, Cmask_h)
    else:
        Ahat = jax.jit(jax.vmap(lambda Av: jnp.stack(
            [jnp.where(Av[d] * Av[diag_slot] < 0, Av[d], 0.0)
             for d in range(D)])))(L)
        Ahatp = exch1(Ahat)
        Cmp = Cmask_h[:, None]               # (P, 1, dims+2)
        Pv = jax.jit(jax.vmap(
            lambda Av, Sm, Ch, Ap, Cp: _interp_classical_sharded(
                Av, Sm, Ch, Ap, Cp, comps, diag_slot, dims, dt)))(
                L, Sm, Cmask_h, Ahatp, Cmp)
        del Ahat, Ahatp, Cmp
    Pv.block_until_ready()
    del Sm
    t0 = _phase("interpolation")

    # --- smoother data ---
    @jax.jit
    @jax.vmap
    def smoother_data(Av):
        diagp = Av[diag_slot].reshape(-1)
        diagp = jnp.where(diagp != 0, diagp, 1.0)
        l1 = sum(jnp.abs(Av[d]).reshape(-1) for d in range(D))
        return 1.0 / diagp, 1.0 / jnp.where(l1 != 0, l1, 1.0)

    dinv, dinv_l1 = smoother_data(L)
    dinv = dinv.reshape(-1)
    dinv_l1 = dinv_l1.reshape(-1)

    # --- coarse numbering planes (identity through halos: exact cols for
    # any pgrid) ---
    ncap = max(8, int(counts.max()))
    offs_excl = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(
        np.int32)
    offs_d = put_sharded(offs_excl.reshape(P_, 1), mesh, P(axis))

    @jax.jit
    @jax.vmap
    def cnum_plane_fn(Cm, off):
        c = jnp.cumsum(Cm.reshape(-1).astype(jnp.int32)) - 1 + off[0]
        return c.reshape(dims)

    cnum_pl = cnum_plane_fn(Cmask, offs_d)   # (P, *dims) int32 global ids

    m = _pad_m(comps)
    # coarse-operator offsets dc = da + dp2 - dp1 reach 3*max|c| per axis
    # (beyond the scan pads m = 2*max|c|): the cnum lookup halo must cover
    # them
    hc = 3 * max(abs(c) for comp in comps for c in comp)
    exch_hc = _mk_exchange(mesh, axis, pgrid, hc)
    cnum_h = exch_hc(cnum_pl)                # halo hc: covers dc shifts

    @jax.jit
    @jax.vmap
    def cidx_fn(Cm):
        return jnp.nonzero(Cm.reshape(-1), size=ncap,
                           fill_value=box - 1)[0].astype(jnp.int32)

    cidx = cidx_fn(Cmask)                    # (P, ncap)
    valid = put_sharded(
        (np.arange(ncap)[None, :] < counts[:, None]), mesh, P(axis))

    # --- Galerkin RAP (chunked scans per part; pack straight to ELL) ---
    exch_m = _mk_exchange(mesh, axis, pgrid, m)

    def pad_stack_sharded(S):
        return exch_m(S)

    Avp = pad_stack_sharded(L)
    Pvp = pad_stack_sharded(Pv)

    groups = _rap_terms(comps)
    dcs = list(groups.keys())
    plane_bytes = box * np.dtype(dt).itemsize
    CHUNK = max(8, min(48, int(9e8 // max(plane_bytes, 1)) - 1))

    from tpusolve.amg.device_setup import _rap_scan

    def rap_chunk(Avp_p, Pvp_p, sub):
        return _rap_scan(Avp_p, Pvp_p, comps, sub, groups, dims, dt, m)

    # SINGLE sweep over the chunked contraction (mirrors
    # device_setup.py's single-pass RAP: the earlier two-pass form
    # re-executed every RAP scan for the pack and paid ~10-20 ns/element
    # per-plane cursor scatters).  Each chunk's C rows are masked by
    # ``valid`` and written into a persistent per-part (|dc|, ncap) value
    # stack; one sort-based pack then emits the coarse ELL.
    def gather_chunk(planes, cidx, valid, Dv_p, cnts, s):
        flat = planes.reshape(planes.shape[0], -1)
        small = jnp.where(valid[None, :], flat[:-1, :][:, cidx],
                          jnp.zeros((), dt))
        cnts = cnts + jnp.sum(small != 0, axis=0, dtype=jnp.int32)
        Dv_p = lax.dynamic_update_slice(Dv_p, small,
                                        (s, jnp.asarray(0, s.dtype)))
        return Dv_p, cnts

    gather = jax.jit(jax.vmap(gather_chunk,
                              in_axes=(0, 0, 0, 0, 0, None)),
                     donate_argnums=(3, 4))

    sh = NamedSharding(mesh, P(axis))
    Dv = jax.device_put(jnp.zeros((P_, len(dcs), ncap), dt), sh)
    cnts = jax.device_put(jnp.zeros((P_, ncap), jnp.int32), sh)
    for s in range(0, len(dcs), CHUNK):
        sub = dcs[s:s + CHUNK]
        planes = jax.jit(jax.vmap(
            lambda a, p: rap_chunk(a, p, sub)))(Avp, Pvp)
        Dv, cnts = gather(planes, cidx, valid, Dv, cnts, jnp.int32(s))
        del planes
    del Avp
    Kc = min(len(dcs), max(8, _round_up(int(jnp.max(cnts)), 8)))
    nnz_c = int(_fetch(jnp.sum(cnts.reshape(P_, -1), axis=1))
                .astype(np.int64).sum())   # int64 on host: x64-agnostic
    del cnts
    if log is not None:
        print(f"      rap[sharded]: K={Kc} nnz_c={nnz_c} ncap={ncap}",
              flush=True)

    zero_dc_pos = next((i for i, dc in enumerate(dcs)
                        if all(c == 0 for c in dc)), None)
    if zero_dc_pos is None:  # no zero offset on this coarse lattice:
        dmain = jnp.ones(Dv.shape[::2], Dv.dtype)  # unit-safe diagonal
    else:
        dmain = Dv[:, zero_dc_pos, :]                    # (P, ncap)

    # pack: cols come from the halo'd coarse-numbering plane at
    # coords(cidx) + dc + hc — a flat-index gather (no per-dc plane
    # shifts); live entries are in-halo by construction (|dc| <= hc)
    hdims = tuple(d + 2 * hc for d in dims)
    hstr = tuple(int(np.prod(hdims[k + 1:])) for k in range(len(dims)))
    dstr = tuple(int(np.prod(dims[k + 1:])) for k in range(len(dims)))
    dcs_dev = jnp.asarray(np.asarray(dcs, np.int32))     # (Dc, ndim)

    def pack_rows(Dv_p, cidx_p, cnum_h_p, start, C, K):
        Dc = Dv_p.shape[0]
        blk = lax.dynamic_slice(
            Dv_p, (jnp.asarray(0, start.dtype), start), (Dc, C))
        ci = lax.dynamic_slice(cidx_p, (start,), (C,))
        flat_h = jnp.zeros((Dc, C), jnp.int32)
        for k in range(len(dims)):
            crd = (ci // dstr[k]) % dims[k]
            flat_h = flat_h + (crd[None, :] + hc
                               + dcs_dev[:, k:k + 1]) * hstr[k]
        cols = cnum_h_p.reshape(-1)[flat_h]              # (Dc, C)
        vT = blk.T
        cT = cols.T
        dead = (vT == 0).astype(jnp.int32)
        _, v_s, c_s = lax.sort((dead, vT, cT), dimension=1, num_keys=1,
                               is_stable=True)
        return v_s[:, :K], jnp.where(v_s[:, :K] != 0, c_s[:, :K], 0)

    @partial(jax.jit, static_argnames=("C", "K"))
    def packer(Dv, cidx, cnum_h, start, C, K):
        return jax.vmap(lambda dv, ci, ch: pack_rows(
            dv, ci, ch, start, C, K))(Dv, cidx, cnum_h)

    itemsize = np.dtype(dt).itemsize
    Crow = max(1 << 12, min(ncap, int(
        1.5e9 // max(1, len(dcs) * itemsize * 6 * P_))))
    vs_, cs_ = [], []
    s0 = 0
    while s0 < ncap:
        Cc = min(Crow, ncap - s0)
        v_s, c_s = packer(Dv, cidx, cnum_h, jnp.int32(s0), C=Cc, K=Kc)
        vs_.append(v_s)
        cs_.append(c_s)
        s0 += Cc
    del Dv
    ell_v = vs_[0] if len(vs_) == 1 else jnp.concatenate(vs_, axis=1)
    ell_c = cs_[0] if len(cs_) == 1 else jnp.concatenate(cs_, axis=1)
    t0 = _phase("galerkin RAP")

    # --- device-first P/R/Ac assembly (from_device_ell_parts): the bulk
    # stays on device as per-part padded ELL with global columns; only the
    # seam entries (halo-plan construction) and the coarse CSR (consumed
    # by the deeper HOST levels anyway) are fetched ---
    row_off_f = np.asarray(A.row_offsets, np.int64)
    row_off_c = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    cnum_h1 = exch1(cnum_pl)

    def pack_part(vplanes, cplanes, valid_r, K):
        ncap_r = vplanes.shape[1]
        rows = jnp.arange(ncap_r, dtype=jnp.int32)

        def body(d, carry):
            ov, oc, cur = carry
            vv = jnp.where(valid_r, vplanes[d], jnp.zeros((), dt))
            nz = vv != 0
            slot = jnp.where(nz, cur, K)
            ov = ov.at[rows, slot].set(vv, mode="drop")
            oc = oc.at[rows, slot].set(cplanes[d], mode="drop")
            return ov, oc, cur + nz.astype(jnp.int32)

        ov = jnp.zeros((ncap_r, K), dt)
        oc = jnp.zeros((ncap_r, K), jnp.int32)
        cur = jnp.zeros(ncap_r, jnp.int32)
        ov, oc, _ = lax.fori_loop(0, D, body, (ov, oc, cur))
        return ov, oc

    # P: values are Pvp's interior, cols the halo'd coarse numbering at
    # each offset
    z3 = (0, 0, 0)
    widths_p = jax.jit(jax.vmap(lambda Pp: jnp.max(jnp.sum(
        (_shift_h(Pp, z3, m) != 0).reshape(D, -1).astype(jnp.int32),
        axis=0))))(Pvp)
    Kp = max(1, int(jnp.max(widths_p)))
    nnz_p = int(_fetch(jax.jit(jax.vmap(lambda Pp: jnp.sum(
        (_shift_h(Pp, z3, m) != 0).reshape(-1).astype(jnp.int32))))(
            Pvp)).astype(np.int64).sum())

    @jax.jit
    @jax.vmap
    def pack_P(Pvp_p, cnum_h1_p):
        v = _shift_h(Pvp_p, z3, m).reshape(D, -1)
        c = jnp.stack([_shift_h(cnum_h1_p, comps[d], 1).reshape(-1)
                       for d in range(D)])
        return pack_part(v, c, jnp.ones(v.shape[1], bool), Kp)

    Pv_ell, Pc_ell = pack_P(Pvp, cnum_h1)
    P_sh = ShardedMatrix.from_device_ell_parts(
        mesh, (n, nc), Pv_ell, Pc_ell,
        row_offsets=row_off_f, col_offsets=row_off_c, axis=axis, nnz=nnz_p)
    del Pv_ell, Pc_ell

    # R = P^T: coarse rows at the C points; fine global columns come from
    # the halo'd fine-identity plane shifted by -comps (exact across
    # seams, like the coarse numbering)
    fid_base = put_sharded(row_off_f[:-1].reshape(P_, 1).astype(np.int32),
                           mesh, P(axis))
    fid = jax.jit(jax.vmap(
        lambda off: (off[0] + jnp.arange(box, dtype=jnp.int32)
                     ).reshape(dims)))(fid_base)
    fid_h = exch1(fid)

    # R rows are WIDER than P rows (a C point is interpolated from by many
    # F rows): size K from the actual transposed widths
    widths_r = jax.jit(jax.vmap(lambda Pp, ci: jnp.max(jnp.sum(
        jnp.stack([(_shift_h(Pp[d], _comps_neg(comps[d]), m)
                    .reshape(-1)[ci] != 0).astype(jnp.int32)
                   for d in range(D)]), axis=0))))(Pvp, cidx)
    Kr = max(1, int(jnp.max(widths_r)))

    @jax.jit
    @jax.vmap
    def pack_R(Pvp_p, fid_h_p, cidx_p, valid_p):
        rv = jnp.stack([
            _shift_h(Pvp_p[d], _comps_neg(comps[d]), m).reshape(-1)[cidx_p]
            for d in range(D)])
        rc = jnp.stack([
            _shift_h(fid_h_p, _comps_neg(comps[d]), 1).reshape(-1)[cidx_p]
            for d in range(D)])
        return pack_part(rv, rc, valid_p, Kr)

    Rv_ell, Rc_ell = pack_R(Pvp, fid_h, cidx, valid)
    R_sh = ShardedMatrix.from_device_ell_parts(
        mesh, (nc, n), Rv_ell, Rc_ell,
        row_offsets=row_off_c, col_offsets=row_off_f, axis=axis,
        row_counts=counts, nnz=nnz_p)
    del Rv_ell, Rc_ell, Pvp, Pv

    # Ac: the packed RAP ELL, diagonal from the zero-offset plane
    dmain_pad = jnp.where(valid & (dmain != 0), dmain, jnp.ones((), dt))
    Ac_sh = ShardedMatrix.from_device_ell_parts(
        mesh, (nc, nc), ell_v, ell_c,
        row_offsets=row_off_c, col_offsets=row_off_c, axis=axis,
        row_counts=counts, diag_main=dmain_pad, nnz=nnz_c)
    t0 = _phase("P/R/Ac assembly")

    # --- coarse CSR fetch is DEFERRED (builder fetches only when it
    # actually drops to the host pipeline for the next level) ---
    def _fetch_coarse_csr():
        ell_v_h = _fetch(ell_v)
        ell_c_h = _fetch(ell_c)
        rows_h, cols_h, vals_h = [], [], []
        for q in range(P_):
            mask = ell_v_h[q] != 0
            ri, ki = np.nonzero(mask)
            rows_h.append(row_off_c[q] + ri.astype(np.int64))
            cols_h.append(ell_c_h[q][ri, ki].astype(np.int64))
            vals_h.append(ell_v_h[q][ri, ki].astype(np.float64))
        return sp.csr_matrix(
            (np.concatenate(vals_h), (np.concatenate(rows_h),
                                      np.concatenate(cols_h))),
            shape=(nc, nc))

    # Cmask flat (padded layout = exact: row_pad == box)
    return dict(Cmask=Cmask.reshape(-1), nc=nc, P=P_sh, R=R_sh,
                Ac=Ac_sh, Ah_c_fn=_fetch_coarse_csr, dinv=dinv,
                dinv_l1=dinv_l1, coarse_row_offsets=row_off_c)
