"""Device-side level-0 BoomerAMG setup for DIA-layout operators.

The reference's AMG setup runs *on device*, distributed, inside
``solverSetupPtr_`` (src/HypreSystem.cpp:692, timed at :731).  The
host-side algebraic pipeline (amg/builder.py) reproduces the algorithms
but cannot scale to the 16.8M+-row fine levels of the north-star problems:
a single host core touches the fine operator several times per phase.

This module runs the *fine-level* setup — the 8x-dominant cost — on the
device, for operators stored in DIA layout (every stencil/mesh problem).  The
key observation: on the DIA offset lattice, every setup stage is shifted
streaming arithmetic (the same pattern as the DIA SpMV) — zero gathers
until the final coarse-operator compaction:

* strength-of-connection: elementwise on the offset planes;
* PMIS: an iterative independent-set whose neighbor-max is D shifted maxes
  (hypre's own device setup also supports exactly the PMIS family);
* direct AND classical-modified interpolation: row-local sums plus
  distance-2 terms that are offset-convolutions (D^2 shifted products);
* Galerkin RAP: the triple product contracts entirely in offset algebra —
  Ac[dc] = sum over (dp1, da, dp2), dc = da + dp2 - dp1, of
  shift(P[dp1] * A[da] * shift(P[dp2], da), -dp1) — evaluated in
  dc-chunks to bound memory and HLO size.

Offsets are tracked as per-axis component tuples (the box decomposition of
matrix/spmv.py), so composite shifts stay exact wherever the data's
box-consistency guarantee holds (zero coefficients at box seams).

The coarse operator / transfers are then compacted on device into padded
ELL ShardedMatrix objects (one gather per plane), and a compact CSR of the
coarse operator is fetched so the (8x smaller) remaining levels reuse the
host pipeline unchanged.

Semantics parity: the stages mirror amg/{strength,coarsen,interp,galerkin}
exactly (same formulas, same PMIS tie-break randoms drawn from the same
seeded host generator), so the device and host paths produce identical
hierarchies up to floating-point roundoff — tested in
tests/test_device_setup.py.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp
from functools import partial
from jax import lax

from tpusolve.matrix.sharded import ShardedMatrix
from tpusolve.matrix.spmv import _decompose_offset

# device path is used when the fine level is at least this large (below it
# the host pipeline is already fast and keeps more config coverage)
MIN_DEVICE_N = 1 << 16
# offset-count guard: the RAP term count grows ~ D^3
MAX_DEVICE_OFFSETS = 40

UNDECIDED, C_PT, F_PT = 0, 1, 2   # device-local state encoding


# ----------------------------------------------------------------------
# shifted streaming primitives

def _shift(a, comps):
    """out[idx] = a[idx + comps] with zero fill (a: (*dims,) box array)."""
    dims = a.shape
    if all(c == 0 for c in comps):
        return a
    pad_width = []
    starts = []
    for c, d in zip(comps, dims):
        lo = max(-c, 0)
        hi = max(c, 0)
        pad_width.append((lo, hi))
        starts.append(lo + c)
    xp = jnp.pad(a, pad_width)
    sl = tuple(slice(s, s + d) for s, d in zip(starts, dims))
    return xp[sl]


def _comps_add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _comps_neg(a):
    return tuple(-x for x in a)


def _flat(comps, dims):
    f = 0
    for c, d in zip(comps, dims):
        f = f * d + c
    return f


# ----------------------------------------------------------------------
# eligibility

def config_eligible(cfg, interp_types=(0, 3)) -> bool:
    """Config-only part of the device-setup gate (shared with the sharded
    path and the harness' host-CSR-skip decision).  ``interp_types``:
    which interpolations the CALLING path implements (the single-part
    generic-ELL path adds extended+i, 6)."""
    if cfg.interp_type not in interp_types:
        return False
    if cfg.coarsen_type not in (0, 8, 10):
        # Falgout/RS need the serial pass; hypre's device setup makes the
        # same PMIS-family restriction — the host path keeps full coverage
        return False
    if cfg.agg_num_levels > 0:
        return False
    if cfg.trunc_factor != 0.0 or cfg.p_max_elmts != 0:
        return False
    if cfg.non_galerkin_tol > 0 or cfg.nongalerk_tol:
        return False
    if cfg.smooth_type is not None and cfg.smooth_num_levels > 0:
        return False
    return True


def eligible(A: ShardedMatrix, cfg) -> bool:
    """Whether the fine level can run the device setup path."""
    import os
    if os.environ.get("TPUSOLVE_HOST_SETUP", "0") == "1":
        return False
    if not A.uses_dia or A.nparts != 1 or A.shape[0] != A.shape[1]:
        return False
    if A.has_offd:
        return False
    if A.shape[0] < int(os.environ.get("TPUSOLVE_DEVICE_SETUP_MIN_N",
                                       MIN_DEVICE_N)):
        return False
    if len(A.dia_offsets) > MAX_DEVICE_OFFSETS:
        return False
    return config_eligible(cfg)


# ----------------------------------------------------------------------
# stages (each traced over the plane stack)

def _strength_planes(Av, comps, diag_slot, theta):
    """Strength masks per plane (f32 0/1), mirroring
    strength.classical_strength."""
    diag = Av[diag_slot]
    sflip = jnp.where(diag < 0, -1.0, 1.0).astype(Av.dtype)
    cand = [-Av[d] * sflip for d in range(len(comps))]
    rowmax = None
    for d in range(len(comps)):
        if d == diag_slot:
            continue
        rowmax = cand[d] if rowmax is None else jnp.maximum(rowmax, cand[d])
    thresh = theta * jnp.maximum(rowmax, 0.0)
    S = []
    for d in range(len(comps)):
        if d == diag_slot:
            S.append(jnp.zeros_like(Av[0]))
        else:
            S.append(((cand[d] >= thresh) & (cand[d] > 0)
                      ).astype(Av.dtype))
    return jnp.stack(S)


def pmis_rank(seed: int, n: int, n_pad: int) -> np.ndarray:
    """int32 rank of the host PMIS tie-break randoms (coarsen.pmis draws
    ``default_rng(seed).random(n)`` as its first sample).

    The device PMIS loops compare the measure as an EXACT integer key
    ``influence * 2^ceil(log2 n_pad) + rank + 1`` — the same lexicographic
    (integer influence, f64 rand) order as the host.  A float32
    ``influence + rand`` measure deadlocks at scale: with millions of rows
    the 24-bit mantissa guarantees colliding weights, equal G-adjacent
    weights can never become C or F, and the loop burns all max_rounds
    (at ELL sizes the loop never ends early; on DIA lattices it
    silently mislabels the deadlocked pairs as C).  Padding rows carry
    rank 0 (they are initialized F and inert)."""
    rng = np.random.default_rng(seed)
    r = rng.random(n)
    order = np.argsort(r, kind="stable")
    rank = np.zeros(n_pad, np.int32)
    rank[order] = np.arange(n, dtype=np.int32)
    return rank


def use_host_rank() -> bool:
    """Whether the device PMIS must reproduce the host pipeline's exact
    tie-break order (TPUSOLVE_PMIS_HOST_RANK=1 — set by the host/device
    parity tests).  Default off: the host rank costs a single-threaded
    O(n log n) argsort plus an n*4-byte host->device transfer, while a
    device-generated permutation stays on the device and
    every seeded permutation yields an equally valid PMIS split."""
    import os
    return os.environ.get("TPUSOLVE_PMIS_HOST_RANK", "0") == "1"


@partial(jax.jit, static_argnames=("n_pad", "seed"))
def pmis_rank_device(seed: int, n_pad: int):
    """int32 tie-break rank permutation generated on device (see
    use_host_rank): rank = inverse permutation of argsort(random bits).
    Bit ties are broken by index inside argsort — deterministic."""
    bits = jax.random.bits(jax.random.key(seed), (n_pad,), jnp.uint32)
    order = jnp.argsort(bits)
    return jnp.zeros((n_pad,), jnp.int32).at[order].set(
        jnp.arange(n_pad, dtype=jnp.int32))


def _pmis_keys(infl, rank, n2=None):
    """uint32 PMIS priority keys from the (integer-valued) influence and
    the host-rand ranks; 0 is the inactive sentinel, live keys are >= 1.
    ``n2`` is the power-of-two bound on the GLOBAL rank space (defaults to
    the local array size — pass it explicitly under shard_map)."""
    if n2 is None:
        n2 = 1 << max(int(rank.size - 1).bit_length(), 1)
    cap = (2**32 - 1) // n2 - 2
    infl_i = jnp.minimum(infl.astype(jnp.int32), cap).astype(jnp.uint32)
    return infl_i * jnp.uint32(n2) + rank.astype(jnp.uint32) + jnp.uint32(1)


def _pmis_split(Sm, comps, rank, max_rounds):
    """PMIS C/F split on device, mirroring coarsen.pmis: ``rank`` carries
    the host tie-break rand RANKS so both paths select identical sets
    (see pmis_rank for why the comparison is exact-integer)."""
    D = len(comps)
    infl = None
    for d in range(D):
        t = _shift(Sm[d], _comps_neg(comps[d]))
        infl = t if infl is None else infl + t
    state0 = jnp.where(infl == 0, F_PT, UNDECIDED).astype(jnp.int32)
    w = _pmis_keys(infl, rank)
    DEAD = jnp.uint32(0)                 # zero-fill of _shift is inert

    # symmetric adjacency: G[d] = S[d] or S^T at the same offset
    rev = {tuple(c): i for i, c in enumerate(comps)}
    G = []
    for d in range(D):
        g = Sm[d]
        dneg = rev.get(tuple(_comps_neg(comps[d])))
        if dneg is not None:
            g = jnp.maximum(g, _shift(Sm[dneg], comps[d]))
        G.append(g)
    G = jnp.stack(G)

    def body(carry):
        state, it = carry
        active = state == UNDECIDED
        wa = jnp.where(active, w, DEAD)
        nbrmax = jnp.full_like(w, DEAD)
        for d in range(D):
            moved = _shift(wa, comps[d])
            nbrmax = jnp.maximum(nbrmax, jnp.where(G[d] > 0, moved, DEAD))
        newC = active & (wa > nbrmax)
        newCf = newC.astype(Sm.dtype)
        hitC = jnp.zeros_like(newCf)
        for d in range(D):
            hitC = hitC + Sm[d] * _shift(newCf, comps[d])
        state = jnp.where(newC, C_PT, state)
        state = jnp.where(active & ~newC & (hitC > 0), F_PT, state)
        return state, it + 1

    def cond(carry):
        state, it = carry
        return (it < max_rounds) & jnp.any(state == UNDECIDED)

    state, it = jax.lax.while_loop(cond, body, (state0, jnp.int32(0)))
    state = jnp.where(state == UNDECIDED, C_PT, state)   # leftovers -> C
    return state, it


def _interp_planes(Av, Sm, comps, diag_slot, Cmask, interp_type):
    """P planes on the A offset lattice (+ identity in the diagonal slot),
    mirroring interp.direct_interpolation / classical_interpolation."""
    D = len(comps)
    dt = Av.dtype
    diag = Av[diag_slot]
    Fmask = 1.0 - Cmask
    C_at = [_shift(Cmask, comps[d]) for d in range(D)]
    strongC = [Sm[d] * C_at[d] for d in range(D)]
    nz = [(Av[d] != 0).astype(dt) for d in range(D)]

    if interp_type == 3:   # direct
        neg = [(Av[d] < 0).astype(dt) for d in range(D)]
        pos = [(Av[d] > 0).astype(dt) for d in range(D)]
        sum_neg = sum(Av[d] * neg[d] for d in range(D) if d != diag_slot)
        sum_pos = sum(Av[d] * pos[d] for d in range(D) if d != diag_slot)
        sC_neg = sum(Av[d] * neg[d] * strongC[d] for d in range(D))
        sC_pos = sum(Av[d] * pos[d] * strongC[d] for d in range(D))
        alpha = jnp.where(sC_neg != 0, sum_neg / jnp.where(sC_neg != 0,
                                                           sC_neg, 1.0), 0.0)
        beta = jnp.where(sC_pos != 0, sum_pos / jnp.where(sC_pos != 0,
                                                          sC_pos, 1.0), 0.0)
        dlump = jnp.where(sC_pos == 0, sum_pos, 0.0)
        dii = diag + dlump
        dii = jnp.where(dii != 0, dii, 1.0)
        P = []
        for d in range(D):
            if d == diag_slot:
                P.append(Cmask.astype(dt))
                continue
            scale = jnp.where(Av[d] < 0, alpha, beta)
            P.append(Fmask * strongC[d] * (-scale * Av[d] / dii))
        return jnp.stack(P)

    # classical modified (interp_type 0)
    F_at = [_shift(Fmask, comps[d]) for d in range(D)]
    strongF = [Sm[d] * F_at[d] for d in range(D)]
    weak = [nz[d] * (1.0 - Sm[d]) for d in range(D)]
    # hat A: entries of sign opposite to the row diagonal
    Ahat = [jnp.where(Av[d] * diag < 0, Av[d], 0.0) for d in range(D)]
    for_d = {tuple(c): i for i, c in enumerate(comps)}

    # d_ik = sum_{m in C_i} hat_a_km  (k = i + df, m = i + dc, e = dc - df)
    Dden = []
    for df in range(D):
        acc = jnp.zeros_like(diag)
        for dc in range(D):
            e = for_d.get(tuple(_comps_add(comps[dc],
                                           _comps_neg(comps[df]))))
            if e is None:
                continue
            acc = acc + strongC[dc] * _shift(Ahat[e], comps[df])
        Dden.append(acc)
    dead = [strongF[df] * (Dden[df] == 0) for df in range(D)]
    dlump = sum(Av[df] * dead[df] for df in range(D))
    W = [jnp.where(dead[df] > 0, 0.0,
                   strongF[df] * Av[df]
                   / jnp.where(Dden[df] != 0, Dden[df], 1.0))
         for df in range(D)]

    sum_weak = sum(Av[d] * weak[d] for d in range(D) if d != diag_slot)
    dii = diag + sum_weak + dlump
    dii = jnp.where(dii != 0, dii, 1.0)

    P = []
    for dc in range(D):
        if dc == diag_slot:
            P.append(Cmask.astype(dt))
            continue
        # T[dc] = sum_df W[df] * hat_a_{i+df, i+dc}, masked to strong-C
        T = jnp.zeros_like(diag)
        for df in range(D):
            e = for_d.get(tuple(_comps_add(comps[dc],
                                           _comps_neg(comps[df]))))
            if e is None:
                continue
            T = T + W[df] * _shift(Ahat[e], comps[df])
        num = Av[dc] * strongC[dc] + strongC[dc] * T
        P.append(Fmask * (-num / dii))
    return jnp.stack(P)


def _scan_table(factors, out_idx, nout, dims, dtype):
    """Pow2-bucket the term table (dummy terms write to a discarded extra
    plane) and run the scan contraction; returns the (nout, *dims) stack."""
    T = len(out_idx)
    Tpad = _pow2ceil_i(T)
    zero = [0] * len(dims)
    fpad = [(stack, list(idx) + [0] * (Tpad - T),
             list(starts) + [zero] * (Tpad - T))
            for stack, idx, starts in factors]
    oo = list(out_idx) + [nout] * (Tpad - T)
    out = _scan_accumulate(nout + 1, dims, dtype, fpad, oo)
    return out[:nout]


def _interp_classical_staged(Av, Sm, Cmask, comps, diag_slot):
    """Classical-modified interpolation for big grids, memory-bounded.

    The single-jit formulation (_interp_planes) materializes ~20 full plane
    stacks at once (OOM at 256^3: each stack is 1.8 GB).  Here the two
    distance-2 accumulations (the d_ik denominators and the strong-F
    redistribution term) run as term-table scans touching 3 planes per
    step; everything else is elementwise.  Same formulas, same per-output
    accumulation order as the unrolled code."""
    D = len(comps)
    dims = tuple(Av.shape[1:])
    dt = Av.dtype
    m = 1
    for_d = {tuple(c): i for i, c in enumerate(comps)}

    # only the Ahat and Cmask factors are sliced at shifted starts; Sm and
    # W slices are always interior, so they stay unpadded (a padded twin of
    # each stack-sized factor costs ~2 GB at 256^3)
    @jax.jit
    def prep(Av, Cmask):
        diag = Av[diag_slot]
        Ahat = jnp.stack([jnp.where(Av[d] * diag < 0, Av[d], 0.0)
                          for d in range(D)])
        return _pad_stack(Ahat, m), _pad_stack(Cmask[None], m)

    Ahatp, Cmp = prep(Av, Cmask)
    zs = [m] * len(dims)
    z0 = [0] * len(dims)

    # Dden[df] = sum_dc strongC[dc] * shift(Ahat[e], df),  e = dc - df
    # strongC[dc] = Sm[dc] * shift(Cmask, dc)
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
    Dden = _scan_table([(Sm, i_s, s_0), (Cmp, i_cm, s_cm),
                        (Ahatp, i_a, s_a)], oo, D, dims, dt)

    @jax.jit
    def mk_w(Av, Sm, Cmask, Dden):
        diag = Av[diag_slot]
        Fm = 1.0 - Cmask
        W, dlump, sum_weak = [], 0.0, 0.0
        for df in range(D):
            strongF = Sm[df] * _shift(Fm, comps[df])
            dead = strongF * (Dden[df] == 0)
            dlump = dlump + Av[df] * dead
            W.append(jnp.where(dead > 0, 0.0,
                               strongF * Av[df]
                               / jnp.where(Dden[df] != 0, Dden[df], 1.0)))
            if df != diag_slot:
                weak = (Av[df] != 0).astype(dt) * (1.0 - Sm[df])
                sum_weak = sum_weak + Av[df] * weak
        dii = diag + sum_weak + dlump
        return jnp.stack(W), jnp.where(dii != 0, dii, 1.0)

    W, dii = mk_w(Av, Sm, Cmask, Dden)
    W.block_until_ready()
    del Dden

    # T[dc] = sum_df W[df] * shift(Ahat[e], df),  e = dc - df
    i_w, i_a2, s_w, s_a2, oo2 = [], [], [], [], []
    for dc in range(D):
        for df in range(D):
            e = for_d.get(tuple(_comps_add(comps[dc],
                                           _comps_neg(comps[df]))))
            if e is None:
                continue
            i_w.append(df)
            i_a2.append(e)
            s_w.append(z0)
            s_a2.append([m + c for c in comps[df]])
            oo2.append(dc)
    T = _scan_table([(W, i_w, s_w), (Ahatp, i_a2, s_a2)], oo2, D, dims, dt)
    T.block_until_ready()
    del W, Ahatp, Cmp

    @jax.jit
    def mk_p(Av, Sm, Cmask, T, dii):
        Fm = 1.0 - Cmask
        P = []
        for dc in range(D):
            if dc == diag_slot:
                P.append(Cmask.astype(dt))
                continue
            strongC = Sm[dc] * _shift(Cmask, comps[dc])
            num = Av[dc] * strongC + strongC * T[dc]
            P.append(Fm * (-num / dii))
        return jnp.stack(P)

    return mk_p(Av, Sm, Cmask, T, dii)


def _pad_m(comps) -> int:
    """Per-axis pad covering every composite slice start (|-dp1| and
    |da - dp1| are both <= 2*max|c|)."""
    return max(1, 2 * max(abs(c) for comp in comps for c in comp))


def _pad_stack(S, m):
    """(D, *dims) -> (D, *dims + 2m) zero-padded planes."""
    return jnp.pad(S, [(0, 0)] + [(m, m)] * (S.ndim - 1))


def _scan_accumulate(nout, dims, dtype, factors, out_idx, unroll=1):
    """out[o] = sum over terms t with out_idx[t]==o of the product of the
    factor slices — evaluated as ONE lax.scan over the term table.

    The statically-unrolled formulation of these contractions defeats
    XLA's scheduler: every shifted operand of the big accumulation
    fusions stays live simultaneously (observed 37-40 GB of plane temps
    at 128^3).  A scan compiles one small body and touches five planes
    per step.

    ``factors``: list of (padded_stack (D, *dims+2m), plane_idx (T,),
    starts (T, ndim)) — slice ``stack[idx][start : start + dims]``.
    """
    T = len(out_idx)
    out0 = jnp.zeros((nout,) + dims, dtype)
    idxs = [jnp.asarray(f[1], jnp.int32) for f in factors]
    starts = [jnp.asarray(f[2], jnp.int32) for f in factors]
    oidx = jnp.asarray(out_idx, jnp.int32)
    stacks = [f[0] for f in factors]
    nd = len(dims)

    def body(out, t):
        term = None
        for s, (stack, iarr, sarr) in enumerate(zip(stacks, idxs, starts)):
            st = (iarr[t],) + tuple(sarr[t, k] for k in range(nd))
            f = jax.lax.dynamic_slice(stack, st, (1,) + dims)[0]
            term = f if term is None else term * f
        out = out.at[oidx[t]].add(term)
        return out, None

    out, _ = jax.lax.scan(body, out0, jnp.arange(T), unroll=unroll)
    return out


def _rap_scan(Avp, Pvp, comps, chunk_dcs, groups, dims, dtype, m):
    """One chunk of coarse-operator planes via the scan contraction.

    term[j] = P[dp1][j-dp1] * A[da][j-dp1] * P[dp2][j-dp1+da]
    accumulated into the plane of dc = da + dp2 - dp1."""
    i1, ia, i2, oo, s1, s2 = [], [], [], [], [], []
    for o, dc in enumerate(chunk_dcs):
        for (dp1, da, dp2) in groups[dc]:
            i1.append(dp1)
            ia.append(da)
            i2.append(dp2)
            oo.append(o)
            s1.append([m - c for c in comps[dp1]])
            s2.append([m + ca - cb
                       for ca, cb in zip(comps[da], comps[dp1])])
    # bucket the term count (pad with no-op terms writing to a dummy,
    # discarded output plane) so chunks share compiled scan bodies
    Tpad = _pow2ceil_i(len(oo))
    npad = Tpad - len(oo)
    z = [m] * len(dims)
    i1 += [0] * npad
    ia += [0] * npad
    i2 += [0] * npad
    oo += [len(chunk_dcs)] * npad           # dummy output plane
    s1 += [z] * npad
    s2 += [z] * npad
    # return the dummy plane too: slicing it off here would materialize a
    # second stack-sized copy next to the scan carry (OOM margin at 256^3);
    # the caller gathers the C rows first and drops the last row of the
    # (chunk+1, nc) smalls instead
    return _scan_accumulate(len(chunk_dcs) + 1, dims, dtype,
                            [(Pvp, i1, s1), (Avp, ia, s1), (Pvp, i2, s2)],
                            oo)


def _pow2ceil_i(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _rap_terms(comps):
    """Group the D^3 offset triples by output component offset."""
    groups: dict[tuple, list] = {}
    for dp1 in range(len(comps)):
        for da in range(len(comps)):
            for dp2 in range(len(comps)):
                dc = _comps_add(_comps_add(comps[da], comps[dp2]),
                                _comps_neg(comps[dp1]))
                groups.setdefault(dc, []).append((dp1, da, dp2))
    return groups


# ----------------------------------------------------------------------
# packing: plane stacks -> padded-ELL ShardedMatrix (device-side)

from functools import partial


@partial(jax.jit, static_argnames=("K",))
def _pack_ell_jit(planes, cols_planes, K):
    """(Dp, n) value planes + int32 col planes -> (n, K) ELL pair, packing
    each row's nonzeros first (order across planes preserved).

    Cursor-scatter over the planes: a sort-based pack materializes ~4
    stack-sized temps (argsort + 3 gathers — ~8 GB at a 343-plane coarse
    operator), this touches one row-slot per plane and carries only the
    (n, K) outputs."""
    D, n = planes.shape
    rows = jnp.arange(n, dtype=jnp.int32)

    def body(d, carry):
        out_v, out_c, cur = carry
        v = planes[d]
        nz = v != 0
        slot = jnp.where(nz, cur, K)     # OOB scatter drops the zeros
        out_v = out_v.at[rows, slot].set(v, mode="drop")
        out_c = out_c.at[rows, slot].set(cols_planes[d], mode="drop")
        return out_v, out_c, cur + nz.astype(jnp.int32)

    out_v = jnp.zeros((n, K), planes.dtype)
    out_c = jnp.zeros((n, K), jnp.int32)
    cur = jnp.zeros(n, jnp.int32)
    out_v, out_c, _ = jax.lax.fori_loop(0, D, body, (out_v, out_c, cur))
    return out_v, out_c    # (n, K)


@jax.jit
def _row_width_max(planes):
    return jnp.max(jnp.sum(planes != 0, axis=0))


def _pack_planes_to_ell(planes, cols_planes):
    """Pack with K = max row width rounded up to a multiple of 8 (bucketed
    so the expensive pack compiles are reused across similar levels/runs)."""
    K = min(planes.shape[0],
            max(8, _round_up(int(_row_width_max(planes)), 8)))
    v, c = _pack_ell_jit(planes, cols_planes, K)
    return v, c, K


@jax.jit
def _row_width_max_planes(Pv):
    """max over rows of the nonzero count across planes, without the
    (D, n) bool temp (fori accumulation: one (n,) int32 carry)."""
    D = Pv.shape[0]
    Ps = Pv.reshape(D, -1)

    def body(d, acc):
        return acc + (Ps[d] != 0).astype(jnp.int32)

    w = lax.fori_loop(0, D, body, jnp.zeros(Ps.shape[1], jnp.int32))
    return jnp.max(w)


@partial(jax.jit, static_argnames=("C", "K"))
def _pack_p_chunk_jit(Ps, cnum_pad, flats_off, start, C, K):
    """One C-row chunk of the P pack: ELL (C, K) values/cols.

    The per-plane column streams arrive as shifted dynamic slices of the
    zero-padded coarse numbering (dead slots read garbage cols but sort
    away on the dead key), the (D, C) block is transposed, and a stable
    width-D sort on the dead flag packs live entries in plane order.
    Sort-pack replaces the old per-plane cursor scatters (one element
    scatter per live entry) with short-row sorts."""
    D, nn = Ps.shape
    blk = lax.dynamic_slice(Ps, (0, start), (D, C))          # (D, C)
    cols = jnp.stack([
        lax.dynamic_slice(cnum_pad, (start + flats_off[d],), (C,))
        for d in range(D)])                                   # (D, C)
    vT = blk.T
    cT = cols.T
    dead = (vT == 0).astype(jnp.int32)
    _, v_s, c_s = lax.sort((dead, vT, cT), dimension=1, num_keys=1,
                           is_stable=True)
    nnz = jnp.sum(dead == 0, dtype=jnp.int32)
    return v_s[:, :K], jnp.where(v_s[:, :K] != 0, c_s[:, :K], 0), nnz


def _pack_p_ell(Pv, cnum, flats, K):
    """Fused chunked P pack: ELL (n, K) values/cols straight from the
    interp value planes — the col of plane d at row i is
    cnum[i + flats[d]] (in-bounds for every LIVE entry by construction of
    the interpolation lattice).  Never materializes the (D, n) value/col
    stacks (2 x 1.8 GB at 256^3).  Also returns nnz(P)."""
    D = Pv.shape[0]
    nn = Pv[0].size
    Ps = Pv.reshape(D, -1)
    fmax = max(1, max(abs(int(f)) for f in flats))
    cnum_pad = jnp.pad(cnum, (fmax, fmax))
    flats_off = tuple(int(f) + fmax for f in flats)
    C = min(nn, 1 << 21)
    nch = (nn + C - 1) // C
    pad_to = nch * C
    if pad_to != nn:
        Ps = jnp.pad(Ps, ((0, 0), (0, pad_to - nn)))
        cnum_pad = jnp.pad(cnum_pad, (0, pad_to - nn))
    vs, cs, nnz = [], [], 0
    for c in range(nch):
        v_s, c_s, nz = _pack_p_chunk_jit(Ps, cnum_pad, flats_off,
                                         c * C, C=C, K=K)
        vs.append(v_s)
        cs.append(c_s)
        nnz += int(nz)
    return (jnp.concatenate(vs)[:nn], jnp.concatenate(cs)[:nn],
            jnp.int32(nnz))


@partial(jax.jit, static_argnames=("comps_t", "diag_slot"))
def _sym_err_jit(Av, comps_t, diag_slot):
    """max |A[d] - shift(A[-d])| over the offset planes: 0 iff the DIA
    operator is exactly symmetric (A[d][j] = a(j, j+d) = a(j+d, j) =
    A[-d][j+d])."""
    rev = {c: i for i, c in enumerate(comps_t)}
    err = jnp.asarray(0.0, Av.dtype)
    for d, c in enumerate(comps_t):
        if d == diag_slot:
            continue
        dn = rev[tuple(-x for x in c)]
        diff = Av[d] - _shift(Av[dn], c)
        err = jnp.maximum(err, jnp.max(jnp.abs(diff)))
    return err


@partial(jax.jit, static_argnames=("dims",))
def _gather_mirror(planes, shifts, cidx, counts, dims):
    """C rows of the MIRROR planes: for each computed positive-offset
    plane p (offset dc = shifts[p]), Ac[-dc] at fine position x equals
    Ac[dc][x - dc] (Galerkin symmetry), masked where x - dc leaves the
    box.  ``shifts`` is a device (c, nd) int32 array so chunks share one
    compiled executable per shape."""
    nd = len(dims)
    flat = planes.reshape(planes.shape[0], -1)
    # coords of the C rows (nd, nc), row-major unravel
    rm = []
    t = cidx
    for d in reversed(dims):
        rm.append(t % d)
        t = t // d
    coords = jnp.stack(list(reversed(rm)))
    tgt = coords[None, :, :] - shifts[:, :, None]          # (c, nd, nc)
    lim = jnp.asarray(dims, jnp.int32)[None, :, None]
    valid = jnp.all((tgt >= 0) & (tgt < lim), axis=1)      # (c, nc)
    f = tgt[:, 0]
    for k in range(1, nd):
        f = f * dims[k] + tgt[:, k]
    f = jnp.clip(f, 0, flat.shape[1] - 1)
    vals = jnp.take_along_axis(flat[:shifts.shape[0]], f, axis=1)
    small = jnp.where(valid, vals, 0.0)
    return small, counts + jnp.sum(small != 0, axis=0, dtype=jnp.int32)


@jax.jit
def _gather_chunk(planes, cidx, counts):
    """Gather one RAP chunk's C rows: (chunk+1, *dims) planes ->
    (chunk, nc) values (dummy no-op plane dropped) + updated row counts."""
    flat = planes.reshape(planes.shape[0], -1)
    small = flat[:-1, :][:, cidx]
    return small, counts + jnp.sum(small != 0, axis=0, dtype=jnp.int32)


@partial(jax.jit, donate_argnums=(0,))
def _dv_write(Dv, small, s):
    """In-place (donated) write of one chunk's C rows into the persistent
    (D, nc) RAP value stack."""
    return lax.dynamic_update_slice(Dv, small, (s, jnp.asarray(0, s.dtype)))


@partial(jax.jit, static_argnames=("C", "K", "n"))
def _pack_rap_chunk_jit(Dv, cidx, cnum, shifts, start, C, K, n):
    """One C-row chunk of the coarse-ELL pack from the (D, nc) C-row RAP
    value stack: col of plane d at coarse row I is cnum[cidx[I] + shift_d]
    (in-bounds for live entries by construction), and a stable sort on the
    dead flag packs live entries in dc-plane order — the same slot order
    as the cursor scatter this replaces, at streaming cost."""
    D = Dv.shape[0]
    blk = lax.dynamic_slice(Dv, (0, start), (D, C))          # (D, C)
    ci = lax.dynamic_slice(cidx, (start,), (C,))             # (C,)
    cols = cnum[jnp.clip(ci[None, :] + shifts[:, None], 0, n - 1)]
    vT = blk.T
    cT = cols.T
    dead = (vT == 0).astype(jnp.int32)
    _, v_s, c_s = lax.sort((dead, vT, cT), dimension=1, num_keys=1,
                           is_stable=True)
    return v_s[:, :K], jnp.where(v_s[:, :K] != 0, c_s[:, :K], 0)


def _pack_rap_ell(Dv, cidx, cnum, shifts_np, K, n):
    """(D, nc) RAP C-row stack -> (nc, K) ELL pair, chunked over rows so
    the sort transients stay ~1.5 GB (the full-width sort would hold ~6
    (nc, D) copies — 343 planes at 256^3)."""
    D, nc = Dv.shape
    itemsize = Dv.dtype.itemsize
    C = max(1 << 15, min(nc, int(1.5e9 // (max(D, 1) * itemsize * 6))))
    shifts = jnp.asarray(shifts_np, jnp.int32)
    vs, cs = [], []
    s = 0
    while s < nc:
        Cc = min(C, nc - s)
        v_s, c_s = _pack_rap_chunk_jit(Dv, cidx, cnum, shifts, s,
                                       C=Cc, K=K, n=n)
        vs.append(v_s)
        cs.append(c_s)
        s += Cc
    if len(vs) == 1:
        return vs[0], cs[0]
    return jnp.concatenate(vs), jnp.concatenate(cs)


@partial(jax.jit, static_argnames=("comps", "dims"))
def _r_stack_jit(Pv, cidx, comps, dims):
    """R = P^T planes gathered at the C rows: R[I, j] = P[j, I] lives at
    coarse row I = cnum[i], fine col j = i - flat(d) for plane d."""
    nn = Pv[0].size
    rv, rc = [], []
    for d in range(len(comps)):
        fl = _flat(comps[d], dims)
        shifted = _shift(Pv[d], _comps_neg(comps[d])).reshape(-1)
        rv.append(shifted[cidx])
        rc.append(jnp.clip(cidx - fl, 0, nn - 1).astype(jnp.int32))
    return jnp.stack(rv), jnp.stack(rc)


def _ell_sharded(mesh, shape, vals, cols, row_offsets, col_offsets,
                 diag_main, nnz, axis="rows"):
    """Wrap device-resident (1, row_pad, K) ELL arrays as a ShardedMatrix
    (single part, no offd)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    sharding = NamedSharding(mesh, P(axis))
    put = lambda a: jax.device_put(a, sharding)
    if vals.ndim == 2:
        vals = vals.reshape((1,) + vals.shape)
        cols = cols.reshape((1,) + cols.shape)
    row_pad = vals.shape[1]
    col_pad = int(col_offsets[1] - col_offsets[0])
    z = np.zeros((1, row_pad, 1), vals.dtype)
    return ShardedMatrix(
        diag_vals=put(vals),
        diag_cols=put(cols),
        dia_vals=None, bell_vals=None, bell_ids=None,
        bdia_vals=None, bdia_starts=None,
        offd_vals=put(z), offd_cols=put(z.astype(np.int32)),
        send_idx=put(np.zeros((1, 1, 1), np.int32)),
        ghost_slot=put(np.zeros((1, 1), np.int32)),
        diag=put(diag_main.reshape(1, row_pad)),
        shape=(int(shape[0]), int(shape[1])),
        row_offsets=tuple(int(o) for o in row_offsets),
        col_offsets=tuple(int(o) for o in col_offsets),
        row_pad=row_pad, col_pad=col_pad,
        dia_offsets=None, dia_shape=None, bell_nwin=None,
        bdia_block=None, bdia_xpad=None, bdia_xlen=None,
        has_offd=False, mesh=mesh, axis=axis, nnz=int(nnz))


def _round_up(x, m):
    return (int(x) + m - 1) // m * m


# ----------------------------------------------------------------------
# orchestrator

def device_level0(A: ShardedMatrix, cfg, seed: int = 1234,
                  log=None):
    """Run the fine-level setup on device.

    Returns ``None`` if coarsening stalls (caller falls back / stops), else
    a dict with the split, transfers, coarse operator (device ELL sharded +
    compact host CSR) and level-0 smoother data.
    """
    import time as _time
    t0 = _time.perf_counter()

    def _phase(label):
        if log is not None:
            # drain the dispatch queue so the wall time lands on the phase
            # that did the work (async dispatch otherwise charges a whole
            # phase's compute to whichever later phase syncs first)
            jax.block_until_ready([x for x in jax.live_arrays()
                                   if not x.is_deleted()])
            t = _time.perf_counter()
            live = sum(x.nbytes for x in jax.live_arrays()) / 1e9
            log(f"    setup[dev]: {label:24s} {t - t0:8.2f}s"
                f"  [{live:5.2f} GB live]")
        return _time.perf_counter()

    mesh = A.mesh
    dims = tuple(A.dia_shape) if A.dia_shape is not None else (A.row_pad,)
    offsets = A.dia_offsets
    comps = [_decompose_offset(off, dims) for off in offsets]
    diag_slot = offsets.index(0)
    n = A.shape[0]
    dt = A.dtype

    Av = A.dia_vals.reshape((len(offsets),) + dims)

    # --- strength + PMIS (exact-integer tie-break keys, see pmis_rank) ---
    theta = float(cfg.strong_threshold)

    @jax.jit
    def stage1(Av, rank):
        Sm = _strength_planes(Av, comps, diag_slot, theta)
        max_rounds = 10 * int(np.ceil(np.log2(n + 2))) + 20
        state, rounds = _pmis_split(Sm, comps, rank, max_rounds)
        Cmask = (state == C_PT).astype(Av.dtype).reshape(dims)
        return Sm, Cmask, rounds

    if use_host_rank():
        rank = jnp.asarray(pmis_rank(seed, n, n)).reshape(dims)
    else:
        rank = pmis_rank_device(seed, n).reshape(dims)
    Sm, Cmask, rounds = stage1(Av, rank)
    nc = int(jnp.sum(Cmask))
    if log is not None:
        log(f"      pmis rounds: {int(rounds)}")
    t0 = _phase("strength+PMIS")
    if nc == 0 or nc >= n:
        return None

    # --- interpolation (P on the same offset lattice) ---
    import os as _os
    stack_bytes = (len(comps) * int(np.prod(dims))
                   * np.dtype(dt).itemsize)
    staged_min = int(_os.environ.get("TPUSOLVE_INTERP_STAGED_MIN_BYTES",
                                     1 << 29))
    if cfg.interp_type == 0 and stack_bytes >= staged_min:
        # big grids: the fused interp keeps ~20 plane stacks live at once;
        # the staged scans bound memory at ~5 stacks
        Pv = _interp_classical_staged(Av, Sm, Cmask, comps, diag_slot)
    else:
        interp_jit = jax.jit(
            lambda Av, Sm, Cmask: _interp_planes(Av, Sm, comps, diag_slot,
                                                 Cmask, cfg.interp_type))
        Pv = interp_jit(Av, Sm, Cmask)
    Pv.block_until_ready()
    del Sm                   # frees (D, *dims) HBM ahead of the RAP buffers

    # level-0 smoother data now, while Av is still needed anyway (frees
    # the reshaped copy before the RAP working set)
    @jax.jit
    def smoother_data(Av):
        diagp = Av[diag_slot].reshape(-1)
        diagp = jnp.where(diagp != 0, diagp, 1.0)
        l1 = sum(jnp.abs(Av[d]).reshape(-1) for d in range(len(comps)))
        return 1.0 / diagp, 1.0 / jnp.where(l1 != 0, l1, 1.0)

    dinv, dinv_l1 = smoother_data(Av)
    t0 = _phase("interpolation")

    cnum = (jnp.cumsum(Cmask.reshape(-1)) - 1).astype(jnp.int32)
    cidx = jnp.nonzero(Cmask.reshape(-1), size=nc)[0].astype(jnp.int32)
    col_off_c = np.array([0, nc], np.int64)
    row_off_c = col_off_c

    # --- P/R as device ELL (rectangular), packed BEFORE the RAP so the
    # fine P planes (D * n floats — 1.8 GB at 256^3) are freed during the
    # RAP sweep instead of held across it ---
    comps_t = tuple(tuple(c) for c in comps)
    flats = [_flat(c, dims) for c in comps]
    Kp = min(len(comps),
             max(8, _round_up(int(_row_width_max_planes(Pv)), 8)))
    P_v, P_c, nnz_p32 = _pack_p_ell(Pv, cnum, flats, Kp)
    nnz_p = int(nnz_p32)
    P_sh = _ell_sharded(mesh, (n, nc), P_v, P_c,
                        np.array([0, n], np.int64), col_off_c,
                        np.ones(n, dt), nnz_p, axis=A.axis)
    del P_v, P_c

    Rstack, RCstack = _r_stack_jit(Pv, cidx, comps_t, dims)
    R_v, R_c, Kr = _pack_planes_to_ell(Rstack, RCstack)
    del Rstack, RCstack
    R_sh = _ell_sharded(mesh, (nc, n), R_v, R_c,
                        row_off_c, np.array([0, n], np.int64),
                        np.ones(nc, dt), nnz_p, axis=A.axis)
    del R_v, R_c
    t0 = _phase("P/R compaction")

    # --- Galerkin RAP in dc chunks, gathered to the C rows immediately
    # (the full fine-indexed plane stack would be |dc| * n floats) ---
    groups = _rap_terms(comps)
    dcs = list(groups.keys())
    # chunk the dc planes so the scan accumulator stays <= ~0.9 GB HBM
    # (the while-scan may double-buffer the carry)
    plane_bytes = int(np.prod(dims)) * np.dtype(dt).itemsize
    CHUNK = max(8, min(48, int(9e8 // plane_bytes) - 1))

    # symmetric-operator halving: Ac = P^T A P is symmetric when A is
    # (R is P^T exactly), so plane Ac[-dc] is plane Ac[dc] sampled at
    # x - dc — scan only the dc >= 0 half of the term table (49% of the
    # triple-product traffic at 27 offsets) and gather each mirror
    # plane's C rows from the computed positive plane (_gather_mirror).
    # Gated off in host-rank (exact-parity) mode: the mirror keeps both
    # twins of entries whose direct sum cancels to exact 0.0 in one
    # summation order (the values agree to roundoff but the explicit-zero
    # bookkeeping — hence nnz — differs from the host's).
    comps_t0 = tuple(tuple(c) for c in comps)
    zero_c = (0,) * len(dims)
    pos_dcs = sorted(dc for dc in dcs if dc > zero_c)
    sym = False
    if (_os.environ.get("TPUSOLVE_RAP_SYM", "1") == "1"
            and not use_host_rank() and pos_dcs
            and zero_c in groups
            and all(tuple(-x for x in dc) in groups for dc in dcs)
            and all(tuple(-x for x in c) in comps_t0 for c in comps_t0)):
        sym = float(_sym_err_jit(Av, comps_t0, diag_slot)) == 0.0
    if sym:
        dcs = pos_dcs + [zero_c] + [tuple(-x for x in dc)
                                    for dc in pos_dcs]
        n_half = len(pos_dcs) + 1
    else:
        n_half = len(dcs)
    if log is not None and sym:
        log(f"      rap symmetric: scanning {n_half}/{len(dcs)} planes")

    # SINGLE sweep over the chunked contraction: each chunk's C rows are
    # gathered into a persistent (|dc|, nc) value stack (~5% the size of
    # the fine-indexed planes), then one sort-based pack emits the coarse
    # ELL.  This replaces the earlier two-pass formulation (counts sweep +
    # a full re-execution of every RAP scan feeding per-plane cursor
    # scatters): the re-scan doubled the RAP compute and the 343-plane
    # scatter wrote one element per live entry.
    m = _pad_m(comps)
    Avp = _pad_stack(Av, m)
    del Av                   # the padded copy is the only RAP input
    Pvp = _pad_stack(Pv, m)
    del Pv                   # P/R packs above were the last fine-P use

    Dv = jnp.zeros((len(dcs), nc), dt)
    counts = jnp.zeros((nc,), jnp.int32)
    dims_t = tuple(int(d) for d in dims)
    for s in range(0, n_half, CHUNK):
        # cap at n_half: in sym mode the tail chunk must not spill into
        # the mirrored negative-dc planes (they are gathered by
        # _gather_mirror; a direct scan would double-increment `counts`,
        # inflating nnz_c/Kc and re-scanning those planes redundantly)
        sub = dcs[s:min(s + CHUNK, n_half)]
        planes = _rap_scan(Avp, Pvp, comps, sub, groups, dims, dt, m)
        small, counts = _gather_chunk(planes, cidx, counts)
        Dv = _dv_write(Dv, small, jnp.int32(s))
        del small
        if sym:
            # mirror rows exist for the positive-dc planes of this chunk
            c_eff = min(len(sub), len(pos_dcs) - s)
            if c_eff > 0:
                shifts_d = jnp.asarray(
                    [list(dc) for dc in sub[:c_eff]], jnp.int32)
                msmall, counts = _gather_mirror(planes, shifts_d, cidx,
                                                counts, dims=dims_t)
                Dv = _dv_write(Dv, msmall, jnp.int32(n_half + s))
                del msmall
        del planes
    del Avp, Pvp
    # one (nc,) fetch for both stats: a device int64 sum silently
    # truncates to int32 without x64 (overflow past 2^31 nnz at
    # north-star scale); the host sum is exact
    counts_h = np.asarray(counts)
    nnz_c = int(counts_h.sum(dtype=np.int64))
    Kc = min(len(dcs), max(8, _round_up(int(counts_h.max(initial=0)), 8)))
    del counts, counts_h
    if log is not None:
        live_gb = sum(x.nbytes for x in jax.live_arrays()) / 1e9
        live_dcs = int(jnp.sum(jnp.any(Dv != 0, axis=1)))
        log(f"      rap counts: K={Kc} nnz_c={nnz_c} "
            f"live_dcs={live_dcs} [{live_gb:5.2f} GB live]")

    zero_dc_pos = next((i for i, dc in enumerate(dcs)
                        if all(c == 0 for c in dc)), None)
    if zero_dc_pos is None:  # coarse lattice lost the zero offset: no
        dmain = jnp.ones((nc,), dt)  # self-connections — unit-safe diag
    else:
        dmain = Dv[zero_dc_pos]
    shifts_np = np.asarray([_flat(dc, dims) for dc in dcs], np.int32)
    ell_v, ell_c = _pack_rap_ell(Dv, cidx, cnum, shifts_np, Kc, n)
    del Dv
    t0 = _phase("galerkin RAP")

    dmain = jnp.where(dmain == 0, 1.0, dmain)  # safety on empty rows
    Ac_sh = _ell_sharded(mesh, (nc, nc), ell_v, ell_c,
                         row_off_c, col_off_c, dmain, nnz_c, axis=A.axis)
    t0 = _phase("coarse A compaction")

    # --- coarse CSR fetch is DEFERRED: if the next level recurses on
    # device (builder.py generic-ELL recursion) the device->host transfer
    # (hundreds of MB) is never paid ---
    def _fetch_coarse_csr():
        ell_v_h = np.asarray(ell_v)
        ell_c_h = np.asarray(ell_c)
        mask = ell_v_h != 0
        counts_h = mask.sum(axis=1)
        indptr = np.zeros(nc + 1, np.int64)
        np.cumsum(counts_h, out=indptr[1:])
        data = ell_v_h[mask].astype(np.float64)
        indices = ell_c_h[mask].astype(np.int64)
        Ah_c = sp.csr_matrix((data, indices, indptr), shape=(nc, nc))
        # ELL slot order is dc-plane order, not column order: sort so the
        # native setup kernels (which require sorted indices) accept the
        # coarse level — unsorted, the whole host continuation falls back
        # to numpy (measured 100 s vs ~4 s for level-1 interp at 256^3)
        Ah_c.sort_indices()
        return Ah_c

    return dict(Cmask=Cmask.reshape(-1), nc=nc, P=P_sh, R=R_sh,
                Ac=Ac_sh, Ah_c_fn=_fetch_coarse_csr, dinv=dinv,
                dinv_l1=dinv_l1, coarse_row_offsets=row_off_c)


def power_lambda(A: ShardedMatrix, dinv, iters: int = 20,
                 seed: int = 0) -> float:
    """lambda_max(D^-1 A) by power iteration on device (the analog of
    smoothers.chebyshev_bounds for hosts without the CSR)."""
    from tpusolve.matrix.spmv import spmv
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(A.padded_nrows).astype(np.float32)
    v0 /= np.linalg.norm(v0)

    @jax.jit
    def run(v):
        def body(_, carry):
            v, lam = carry
            w = dinv * spmv(A, v)
            nw = jnp.linalg.norm(w)
            lam = jnp.vdot(v, w, precision=lax.Precision.HIGHEST)
            return jnp.where(nw == 0, v, w / jnp.where(nw == 0, 1.0, nw)), lam
        return jax.lax.fori_loop(0, iters, body, (v, jnp.asarray(
            1.0, v.dtype)))[1]

    lam = float(run(jnp.asarray(v0)))
    return max(abs(lam), 1e-12)
