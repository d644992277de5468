"""Device-side fine-level AMG setup for generic (unstructured) ELL operators.

The DIA device setup (amg/device_setup.py) covers stencil/lattice operators;
*file-loaded* systems — the reference's MatrixMarket / HYPRE-IJ paths
(src/HypreSystem.cpp:1613-1969, :1021-1318) feeding BoomerAMGSetup on device
(src/HypreSystem.cpp:692) — have no offset lattice.  This module runs the
same fine-level pipeline (strength -> PMIS -> direct interpolation ->
Galerkin RAP) on the device for an arbitrary padded-ELL operator:

* strength / interpolation weights: row-local slot arithmetic on the
  (n, K) ELL planes — elementwise plus one ``Cmask`` gather;
* PMIS: iterative independent set; neighbor maxima over S run as one
  row gather (S rows) plus one scatter-max (S^T rows) per round;
* Galerkin RAP: two sparse products as *expand -> sort -> segment-sum*
  contractions, chunked over rows so the (rows, K*Kp) expansion stays
  in a bounded device-memory footprint.  This is the analog of hypre's
  hash-based device SpGEMM (vendor SpGEMM toggle, src/main.cpp:127-156):
  XLA has no hash tables, but a per-row sort over the slot axis is
  data-parallel and the duplicate collapse becomes a masked segmented
  scatter-add.

Semantics mirror the host pipeline exactly (amg/strength.py,
amg/coarsen.py:pmis, amg/interp.py:direct_interpolation, amg/galerkin.py)
with the same seeded tie-break randoms, so host and device hierarchies
agree to roundoff — tested in tests/test_device_setup_ell.py.

Eligibility: single-part square operators, PMIS-family coarsening,
``interp_type`` 3 (direct — distance-1, row-local), 0 (classical
modified — distance-2 via chunked neighbor-row gathers matched against
the row's strong-C set), or 6 (extended+i — the distance-2 extended
pattern, single-part only), and the shared ``config_eligible`` gates.
"""

from __future__ import annotations

import time as _time
from functools import partial

import numpy as np
import scipy.sparse as sp
import jax
import jax.numpy as jnp
from jax import lax

from tpusolve.matrix.sharded import ShardedMatrix
from tpusolve.amg.device_setup import (config_eligible, _ell_sharded,
                                       _round_up)

# device path is worthwhile above this size (below it the host native
# kernels are already fast and keep full config coverage).  Measured
# crossover (r5): the 64^3 = 2^18 gate-3 pressure system sets up in
# 7.0 s through the native host kernels vs 28.8 s through the device
# pipeline (chunk-compile amortization needs bigger rows), so the gate
# sits ABOVE 2^18.
MIN_DEVICE_N = 1 << 19
# ELL width guard: (n, K) planes with K beyond this indicate a dense-ish
# row profile the expansion products would blow up on.  128 admits the
# coarse operators of 3-D stencil hierarchies (K=80 one level below a
# 27-point fine grid) — the expand/sort products stay memory-bounded by
# row-chunking, so width only shrinks the chunk, not the budget.
MAX_ELL_K = 128


def eligible(A: ShardedMatrix, cfg, A_host=None) -> bool:
    """Whether the fine level can run the generic-ELL device setup.

    Single part: this module.  Multiple parts: the SPMD sharded pipeline
    (amg/device_setup_ell_mp.py) — the distributed analog of the
    reference's device BoomerAMGSetup on arbitrary file-loaded ParCSR
    operators (src/HypreSystem.cpp:692, readers :1021-1318, 1613-1969)."""
    import os
    if os.environ.get("TPUSOLVE_HOST_SETUP", "0") == "1":
        return False
    if os.environ.get("TPUSOLVE_ELL_SETUP", "1") == "0":
        return False
    if not A.is_square:
        return False
    if A.nparts == 1 and A.has_offd:
        return False
    n = A.shape[0]
    if n >= 2**31:
        return False
    if n < int(os.environ.get("TPUSOLVE_DEVICE_SETUP_MIN_N", MIN_DEVICE_N)):
        return False
    # need an ELL source: the real ELL diag layout, or the host CSR to
    # stage one from (file-loaded systems keep A_host through assembly)
    has_ell = not (A.uses_dia or A.uses_bell or A.uses_bdia)
    if has_ell:
        k = A.diag_vals.shape[2] + (A.offd_vals.shape[2] if A.nparts > 1
                                    else 0)
        if k > MAX_ELL_K:
            return False
    else:
        if A_host is None:
            return False
        if int(np.diff(A_host.tocsr().indptr).max()) > MAX_ELL_K:
            return False
    if not config_eligible(cfg, interp_types=(0, 3, 6)):
        return False
    if A.nparts > 1:
        # the sharded pipeline implements direct (3, row-local given
        # ghosted C data), classical-modified (0, distance-2 via one
        # extra forward halo of ghost neighbor rows) and extended+i
        # (6, distance-2 extended pattern + a second-ring transpose
        # plan) interpolation
        return cfg.interp_type in (0, 3, 6)
    # direct (3) is row-local; classical (0) runs the chunked distance-2
    # formulation (_interp_classical_ell); extended+i (6) the
    # extended-pattern variant (_interp_exti_ell — the gate-3 pressure
    # config, ref src/HypreSystem.cpp:205-216)
    return cfg.interp_type in (0, 3, 6)


# ----------------------------------------------------------------------
# input staging

def _stage_ell(A: ShardedMatrix, A_host):
    """(vals, cols) (n_pad, K) device ELL of the diag block (global cols ==
    local cols: single part).  Reuses A.diag_vals when it is the real
    layout; otherwise packs the host CSR (vectorized O(nnz))."""
    if not (A.uses_dia or A.uses_bell or A.uses_bdia):
        return A.diag_vals[0], A.diag_cols[0]
    M = A_host.tocsr()
    n = M.shape[0]
    counts = np.diff(M.indptr)
    K = max(8, _round_up(int(counts.max()), 8))
    n_pad = A.row_pad
    vals = np.zeros((n_pad, K), A.dtype)
    cols = np.zeros((n_pad, K), np.int32)
    rows = np.repeat(np.arange(n), counts)
    slot = np.arange(M.nnz) - np.repeat(M.indptr[:-1], counts)
    vals[rows, slot] = M.data.astype(A.dtype)
    cols[rows, slot] = M.indices.astype(np.int32)
    return jnp.asarray(vals), jnp.asarray(cols)


# ----------------------------------------------------------------------
# stage 1: strength + PMIS

@partial(jax.jit, static_argnames=("n", "theta"))
def _strength_jit(vals, cols, n, theta):
    """Strength mask on the ELL slots, mirroring
    strength.classical_strength.  Returns (S (n_pad, K) bool, diag,
    max strong count per row)."""
    n_pad, K = vals.shape
    rows = jnp.arange(n_pad, dtype=jnp.int32)[:, None]
    offd = cols != rows
    diag = jnp.sum(jnp.where(~offd, vals, 0.0), axis=1)
    sflip = jnp.where(diag < 0, -1.0, 1.0).astype(vals.dtype)
    # padding slots carry cand = 0 and never pass `cand > 0`; a padded
    # rowmax of 0 (vs the host's -inf) changes no outcome for the same
    # reason (thresh only matters above 0)
    cand = jnp.where(offd, -vals * sflip[:, None], -jnp.inf)
    rowmax = jnp.max(cand, axis=1)
    S = (cand >= theta * rowmax[:, None]) & (cand > 0)   # (n_pad, K)
    valid_row = rows[:, 0] < n
    S = S & valid_row[:, None]
    return S, diag, jnp.max(jnp.sum(S, axis=1))


@partial(jax.jit, static_argnames=("n", "max_rounds", "Ks", "m0"))
def _pmis_phase_a_jit(S, cols, rank, n, max_rounds, Ks, m0):
    """PMIS phase A, mirroring coarsen.pmis: full-array rounds until the
    undecided set fits ``m0``.  Returns (scols, Smk, w, state, rem, it).

    ``rank`` is the int32 rank of the PMIS tie-break randoms
    (coarsen.pmis ``rng.random(n)`` in host-rank mode; a device
    permutation otherwise): the PMIS measure is compared as an EXACT
    uint32 key ``influence * 2^ceil(log2 n_pad) + rank + 1`` — the same
    lexicographic (integer influence, f64 rand) order the host uses.
    A float32 ``influence + rand`` measure deadlocks at scale: the 24-bit
    mantissa guarantees colliding weights among millions of rows, equal
    G-adjacent weights can never become C or F, and the loop runs all
    max_rounds."""
    n_pad, K = S.shape
    rows1 = jnp.arange(n_pad, dtype=jnp.int32)
    valid_row = rows1 < n

    # compact strong cols to (n_pad, Ks); dead slots target the last
    # padding row (inert: padding rows are F and their key is DEAD)
    def pack(k, carry):
        sc, cur = carry
        mk = S[:, k]
        slot = jnp.where(mk, cur, Ks)
        sc = sc.at[rows1, slot].set(cols[:, k], mode="drop")
        return sc, cur + mk.astype(jnp.int32)

    scols = jnp.full((n_pad, Ks), n_pad - 1, jnp.int32)
    scols, scount = lax.fori_loop(0, K, pack,
                                  (scols, jnp.zeros(n_pad, jnp.int32)))
    Smk = jnp.arange(Ks, dtype=jnp.int32)[None, :] < scount[:, None]
    scols = jnp.where(Smk, scols, n_pad - 1)

    # influence[j] = |{i : S[i, j]}| (column counts of S)
    influence = jnp.zeros((n_pad,), jnp.int32).at[scols].add(
        jnp.where(Smk, 1, 0).astype(jnp.int32))
    n_pad2 = 1 << max(int(n_pad - 1).bit_length(), 1)
    cap = (2**32 - 1) // n_pad2 - 2
    w = (jnp.minimum(influence, cap).astype(jnp.uint32)
         * jnp.uint32(n_pad2) + rank.astype(jnp.uint32) + jnp.uint32(1))
    DEAD = jnp.uint32(0)                         # below every live key

    UND, C, F = jnp.int32(-1), jnp.int32(1), jnp.int32(0)
    state0 = jnp.where(influence == 0, F, UND)
    state0 = jnp.where(valid_row, state0, F)     # padding rows: F, inert
    rem0 = jnp.sum(state0 == UND)

    def body(carry):
        state, rem, it = carry
        active = state == UND
        wa = jnp.where(active, w, DEAD)
        # G = S ∪ S^T neighbor max of wa:
        #   S rows: gather wa at this row's strong cols
        m_row = jnp.max(jnp.where(Smk, wa[scols], DEAD), axis=1)
        #   S^T rows: scatter-max wa[i] into each strong col of row i
        m_colT = jnp.full((n_pad,), DEAD, jnp.uint32).at[scols].max(
            jnp.where(Smk, wa[:, None], DEAD))
        nbrmax = jnp.maximum(m_row, m_colT)
        newC = active & (wa > nbrmax)
        state = jnp.where(newC, C, state)
        # i -> F if some strong col j of i is new C
        hit = jnp.any(Smk & newC[scols], axis=1)
        state = jnp.where(active & ~newC & hit, F, state)
        rem = jnp.sum(state == UND)
        return state, rem, it + 1

    def cond(carry):
        _, rem, it = carry
        return (it < max_rounds) & (rem > m0)

    state, rem, it = lax.while_loop(cond, body,
                                    (state0, rem0, jnp.int32(0)))
    return scols, Smk, w, state, rem, it


@partial(jax.jit, static_argnames=("n", "max_rounds", "m0"))
def _pmis_phase_b_jit(scols, Smk, w, state, rem, it, n, max_rounds, m0):
    """PMIS phase B: remaining rounds on the packed (static size ``m0``)
    active rows — undecided rows only leave the set, so one pack
    suffices.  Rounds are gather-bound and PMIS decides most rows in
    phase A's first 2-3 rounds, so these tail rounds cost n/m0 x less
    than full-array rounds.  Kept a separate program from phase A: the
    fused two-phase program took far longer to compile than to run."""
    n_pad = state.shape[0]
    UND, C, F = jnp.int32(-1), jnp.int32(1), jnp.int32(0)
    DEAD = jnp.uint32(0)
    act = jnp.nonzero(state == UND, size=m0,
                      fill_value=n_pad - 1)[0].astype(jnp.int32)
    sc_a = scols[act]                            # (m0, Ks)
    sm_a = Smk[act]
    w_a = w[act]

    def body(carry):
        state, st_a, rem, it = carry
        active = st_a == UND
        wa_a = jnp.where(active, w_a, DEAD)
        # wa over the full index space (gather targets may be any row)
        wa = jnp.where(state == UND, w, DEAD)
        m_row = jnp.max(jnp.where(sm_a, wa[sc_a], DEAD), axis=1)
        m_colT = jnp.full((n_pad,), DEAD, jnp.uint32).at[sc_a].max(
            jnp.where(sm_a, wa_a[:, None], DEAD))
        nbrmax = jnp.maximum(m_row, m_colT[act])
        newC = active & (wa_a > nbrmax)
        newC_full = jnp.zeros((n_pad,), jnp.bool_).at[act].max(newC)
        hit = jnp.any(sm_a & newC_full[sc_a], axis=1)
        st_a = jnp.where(newC, C, st_a)
        st_a = jnp.where(active & ~newC & hit, F, st_a)
        # duplicate pad entries all write the same (unchanged) F value
        state = state.at[act].set(st_a)
        return state, st_a, jnp.sum(st_a == UND), it + 1

    def cond(carry):
        _, _, rem, it = carry
        return (it < max_rounds) & (rem > 0)

    state, _, _, _ = lax.while_loop(cond, body,
                                    (state, state[act], rem, it))
    state = jnp.where(state == UND, C, state)       # leftovers -> C
    valid_row = jnp.arange(n_pad, dtype=jnp.int32) < n
    return jnp.where(valid_row, state, jnp.int32(0))


def _pow2ceil(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def _stage1(vals, cols, rank, n, theta, max_rounds):
    """strength -> (static Ks sync) -> PMIS (two-phase; see
    _pmis_phase_a_jit/_pmis_phase_b_jit)."""
    S, diag, ks32 = _strength_jit(vals, cols, n=n, theta=theta)
    Ks = max(1, int(ks32))
    n_pad = S.shape[0]
    m0 = min(n_pad, max(4096, _pow2ceil(n_pad // 16)))
    scols, Smk, w, state, rem, it = _pmis_phase_a_jit(
        S, cols, rank, n=n, max_rounds=max_rounds, Ks=Ks, m0=m0)
    state = _pmis_phase_b_jit(scols, Smk, w, state, rem, it, n=n,
                              max_rounds=max_rounds, m0=m0)
    return S, state, diag


# ----------------------------------------------------------------------
# stage 2: direct interpolation (interp_type 3), row-local

@partial(jax.jit, static_argnames=("Kp",))
def _interp_direct_jit(vals, cols, S, Cmask, cmap, diag, Kp):
    """P as (n_pad, Kp) ELL (coarse cols), mirroring
    interp.direct_interpolation.  C rows: identity at cmap[row]."""
    n_pad, K = vals.shape
    rows = jnp.arange(n_pad, dtype=jnp.int32)
    offd = cols != rows[:, None]
    is_C = Cmask > 0
    strongC = S & (Cmask[jnp.where(S, cols, 0)] > 0)

    neg = vals < 0
    pos = vals > 0
    sum_neg = jnp.sum(jnp.where(offd & neg, vals, 0.0), axis=1)
    sum_pos = jnp.sum(jnp.where(offd & pos, vals, 0.0), axis=1)
    sC_neg = jnp.sum(jnp.where(strongC & neg, vals, 0.0), axis=1)
    sC_pos = jnp.sum(jnp.where(strongC & pos, vals, 0.0), axis=1)
    alpha = jnp.where(sC_neg != 0,
                      sum_neg / jnp.where(sC_neg != 0, sC_neg, 1.0), 0.0)
    beta = jnp.where(sC_pos != 0,
                     sum_pos / jnp.where(sC_pos != 0, sC_pos, 1.0), 0.0)
    dlump = jnp.where(sC_pos == 0, sum_pos, 0.0)
    dii = diag + dlump
    dii = jnp.where(dii != 0, dii, 1.0)

    keep = strongC & ~is_C[:, None]
    scale = jnp.where(vals < 0, alpha[:, None], beta[:, None])
    w = jnp.where(keep, -scale * vals / dii[:, None], 0.0)
    pcol = jnp.where(keep, cmap[jnp.where(keep, cols, 0)], 0)

    # cursor-pack the keep slots, then the C identity in the first slot
    def body(k, carry):
        ov, oc, cur = carry
        kk = keep[:, k]
        slot = jnp.where(kk, cur, Kp)
        ov = ov.at[rows, slot].set(w[:, k], mode="drop")
        oc = oc.at[rows, slot].set(pcol[:, k], mode="drop")
        return ov, oc, cur + kk.astype(jnp.int32)

    ov = jnp.zeros((n_pad, Kp), vals.dtype)
    oc = jnp.zeros((n_pad, Kp), jnp.int32)
    cur = jnp.zeros((n_pad,), jnp.int32)
    ov, oc, cur = lax.fori_loop(0, K, body, (ov, oc, cur))
    ov = ov.at[:, 0].set(jnp.where(is_C, 1.0, ov[:, 0]))
    oc = oc.at[:, 0].set(jnp.where(is_C, cmap, oc[:, 0]))
    nnz_p = jnp.sum(cur) + jnp.sum(is_C)
    return ov, oc, nnz_p


# ----------------------------------------------------------------------
# stage 2b: classical-modified interpolation (interp_type 0), distance-2
#
# Mirrors interp.classical_interpolation exactly (same masks, same lump/
# hat-entry semantics).  For F-point i with strong C-set C_i, strong F-set
# F_i and weak set W_i:
#
#     P_ij = -( a_ij + sum_{k in F_i} a_ik * hat_a_kj / d_ik ) / tilde_a_ii
#     d_ik = sum_{m in C_i} hat_a_km        (hat: sign opposite to a_kk)
#     tilde_a_ii = a_ii + sum_{k in W_i} a_ik  (+ a_ik where d_ik = 0)
#
# The distance-2 term gathers each strong-F neighbor's ELL row and matches
# its columns against the row's compacted strong-C set — row-chunked so the
# (chunk, K, Kc) match tensor stays in a bounded HBM footprint.


@partial(jax.jit, static_argnames=("Ksel", "fillcol"))
def _pack_sel_jit(vals, cols, mask, Ksel, fillcol):
    """Left-pack masked slots of an (n, K) ELL into (n, Ksel); dead
    slots carry val 0 / col ``fillcol``.  Returns (vals, cols, counts).

    One row-sort on the slot index (kept slots keep their k, dropped
    slots sort last) — replaces a K-step cursor-scatter loop (n*K
    scattered elements)."""
    n_pad, K = vals.shape
    kidx = jnp.arange(K, dtype=jnp.int32)[None, :]
    key = jnp.where(mask, kidx, jnp.int32(K))
    key_s, v_s, c_s = lax.sort(
        (jnp.broadcast_to(key, (n_pad, K)), vals, cols),
        dimension=1, num_keys=1)
    live = key_s < K
    ov = jnp.where(live, v_s, 0.0).astype(vals.dtype)
    oc = jnp.where(live, c_s, fillcol)
    if Ksel > K:        # mirror _pack_p_from_w_jit: widen, never clamp
        ov = jnp.pad(ov, ((0, 0), (0, Ksel - K)))
        oc = jnp.pad(oc, ((0, 0), (0, Ksel - K)),
                     constant_values=fillcol)
    else:
        ov, oc = ov[:, :Ksel], oc[:, :Ksel]
    cur = jnp.sum(mask, axis=1, dtype=jnp.int32)
    return ov, oc, cur


@jax.jit
def _sigma_permute_jit(fv, fc, scv, scc, ccnt, diag, weaksum, fcnt):
    """One fused jit for the sigma-order permutation (rows sorted by
    descending strong-F count).  Fused because each EAGER jnp op at a new
    shape is its own compile."""
    order = jnp.argsort(-fcnt)
    return (fv[order], fc[order], scv[order], scc[order], ccnt[order],
            diag[order], weaksum[order], fcnt[order], order)


@jax.jit
def _sigma_unpermute_jit(w, key_s, order):
    """Inverse of _sigma_permute_jit on the chunk outputs (same fused-jit
    rationale)."""
    n_pad = order.shape[0]
    inv = jnp.zeros_like(order).at[order].set(
        jnp.arange(n_pad, dtype=order.dtype))
    return w[inv], key_s[inv]


@jax.jit
def _classical_masks_jit(vals, cols, S, Cmask):
    """strongC/strongF slot masks, the weak off-diagonal row sums, and the
    max strong-C / strong-F widths (to size the compacted packs)."""
    n_pad, K = vals.shape
    rows = jnp.arange(n_pad, dtype=jnp.int32)[:, None]
    offd = cols != rows
    isC = Cmask > 0
    isC_col = isC[cols]                     # (n_pad, K) bool gather
    strongC = S & isC_col
    strongF = S & ~isC_col
    weaksum = jnp.sum(jnp.where(offd & ~S, vals, 0.0), axis=1)
    kc = jnp.max(jnp.sum(strongC, axis=1))
    kf = jnp.max(jnp.sum(strongF, axis=1))
    return strongC, strongF, weaksum, kc, kf


@partial(jax.jit, static_argnames=("KF",), donate_argnums=())
def _classical_chunk_jit(fv, fc, scv, scc, ccnt, diag_row, weaksum_c,
                         vals, cols, diag, KF):
    """One row chunk of the classical weights: returns (w, key_s) over the
    compacted strong-C slots SORTED by column (zero / INT32_MAX on dead
    slots).

    The strong-C columns are sorted once per chunk so each neighbor entry
    finds its slot by a fused compare-count (rank = #{smaller cols}) and a
    take_along_axis probe — all (C, K)-shaped — instead of materializing a
    (C, K, Kc) float match tensor per strong-F slot (measured 280 s at a
    1.4M-row coarse level; this formulation's rank-3 work is a bool
    compare-reduce that XLA streams without materializing)."""
    C_, Kc = scv.shape
    rowsC = jnp.arange(C_, dtype=jnp.int32)
    scm = jnp.arange(Kc, dtype=jnp.int32)[None, :] < ccnt[:, None]
    INF = jnp.int32(_I32_MAX)
    key = jnp.where(scm, scc, INF)
    key_s, scv_s = lax.sort((key, scv), dimension=1, num_keys=1)

    def body(t, carry):
        T, dlump = carry
        k = fc[:, t]                        # strong-F neighbor rows
        bv = vals[k]                        # (C, K) row gathers
        bc = cols[k]
        # hat entries of row k: sign opposite to k's own diagonal
        hv = jnp.where(bv * diag[k][:, None] < 0, bv, 0.0)
        # slot of bc within the sorted strong-C cols (Kc if absent)
        s = jnp.sum((key_s[:, None, :] < bc[:, :, None]).astype(jnp.int32),
                    axis=2)                                 # (C, K)
        cand = jnp.take_along_axis(key_s, jnp.minimum(s, Kc - 1), axis=1)
        member = (cand == bc) & (s < Kc)
        hvm = jnp.where(member, hv, 0.0)
        d = jnp.sum(hvm, axis=1)
        fvt = fv[:, t]                      # a_ik (0 on dead slots)
        W = jnp.where(d != 0, fvt / jnp.where(d != 0, d, 1.0), 0.0)
        dlump = dlump + jnp.where(d == 0, fvt, 0.0)
        slot = jnp.where(member, s, Kc)
        # scatter-free slot accumulation: contract against a fused one-hot
        # of the slot ranks in place of a (C, K) element scatter-add; the
        # precision is pinned so the weights are not rounded to TF32
        onehot = (slot[:, :, None]
                  == jnp.arange(Kc, dtype=jnp.int32)[None, None, :])
        T = T + jnp.einsum("ck,cks->cs", W[:, None] * hvm,
                           onehot.astype(vals.dtype),
                           precision=lax.Precision.HIGHEST)
        return T, dlump

    T0 = jnp.zeros((C_, Kc), vals.dtype)
    T, dlump = lax.fori_loop(0, KF, body,
                             (T0, jnp.zeros((C_,), vals.dtype)))
    dii = diag_row + weaksum_c + dlump
    dii = jnp.where(dii != 0, dii, 1.0)
    live = key_s < INF
    w = jnp.where(live, -(scv_s + T) / dii[:, None], 0.0)
    return w, key_s


@partial(jax.jit, static_argnames=("Kp",))
def _pack_p_from_w_jit(w, pcol, Cmask, cmap, Kp):
    """(w, pcol) (n_pad, Kc) weight planes -> P as (n_pad, Kp) ELL; F rows
    keep nonzero weights (host P runs eliminate_zeros), C rows identity.
    Left-pack by one row-sort on the slot index (see _pack_sel_jit for the
    scatter-vs-sort economics)."""
    n_pad, Kc = w.shape
    is_C = Cmask > 0
    keep = (w != 0) & ~is_C[:, None]
    kidx = jnp.arange(Kc, dtype=jnp.int32)[None, :]
    key = jnp.where(keep, kidx, jnp.int32(Kc))
    key_s, w_s, c_s = lax.sort(
        (jnp.broadcast_to(key, (n_pad, Kc)), w, pcol),
        dimension=1, num_keys=1)
    live = key_s < Kc
    ov = jnp.where(live, w_s, 0.0).astype(w.dtype)
    oc = jnp.where(live, c_s, 0)
    if Kp > Kc:
        ov = jnp.pad(ov, ((0, 0), (0, Kp - Kc)))
        oc = jnp.pad(oc, ((0, 0), (0, Kp - Kc)))
    else:
        ov, oc = ov[:, :Kp], oc[:, :Kp]
    ov = ov.at[:, 0].set(jnp.where(is_C, 1.0, ov[:, 0]))
    oc = oc.at[:, 0].set(jnp.where(is_C, cmap, oc[:, 0]))
    nnz_p = jnp.sum(keep) + jnp.sum(is_C)
    return ov, oc, nnz_p


def _interp_classical_ell(vals, cols, S, Cmask, cmap, diag, log=None):
    """Classical-modified interpolation, chunked.  Returns
    (Pv, Pc, nnz_p) in the same ELL layout as _interp_direct_jit.

    Rows run in sigma-order (descending strong-F count): the chunk body
    is gather-bound in KF (two (C, K) row gathers per strong-F slot), and
    most rows carry far fewer strong-F neighbors than the global max —
    sorting lets each chunk's loop stop at its OWN max width, cutting the
    gathered volume from n*KF_max to ~n*KF_mean."""
    n_pad, K = (int(s) for s in vals.shape)
    strongC, strongF, weaksum, kc32, kf32 = _classical_masks_jit(
        vals, cols, S, Cmask)
    Kc = max(1, int(kc32))
    KF = max(1, int(kf32))
    scv, scc, ccnt = _pack_sel_jit(vals, cols, strongC, Ksel=Kc, fillcol=0)
    fv, fc, fcnt = _pack_sel_jit(vals, cols, strongF, Ksel=KF, fillcol=0)
    del strongC, strongF

    (fv, fc, scv, scc, ccnt, diag_o, weak_o, fcnt_s,
     order) = _sigma_permute_jit(fv, fc, scv, scc, ccnt, diag, weaksum,
                                 fcnt)

    # the chunk's materialized temps are (C, K)-shaped (gathers, slot
    # ranks); the (C, K, Kc) compare-reduce streams without materializing
    itemsize = np.dtype(vals.dtype).itemsize
    budget = 1 << 29                                     # ~512 MB
    chunk = max(256, min(n_pad, budget // max(K * 8 * itemsize, 1)))
    chunk = _round_up(chunk, 256)
    nch = (n_pad + chunk - 1) // chunk

    def _pad_rows(a):
        want = nch * chunk
        return a if a.shape[0] == want else jnp.pad(
            a, ((0, want - a.shape[0]),) + ((0, 0),) * (a.ndim - 1))

    fv_p, fc_p = _pad_rows(fv), _pad_rows(fc)
    scv_p, scc_p, ccnt_p = _pad_rows(scv), _pad_rows(scc), _pad_rows(ccnt)
    diag_p, weak_p = _pad_rows(diag_o), _pad_rows(weak_o)
    # chunk widths: first (= max) strong-F count of each chunk, one fetch;
    # rounded up to a multiple of 4 to bound the compile-cache footprint
    kf_heads = np.asarray(jax.device_get(fcnt_s[::chunk]))
    if log is not None:
        log(f"      classical interp: KF={KF} Kc={Kc} chunks={nch} "
            f"kf/chunk={[int(h) for h in kf_heads[:8]]}")
    ws, keys = [], []
    for c in range(nch):
        sl = slice(c * chunk, (c + 1) * chunk)
        KF_c = min(KF, max(1, _round_up(int(kf_heads[c]), 4)))
        wc, kc_s = _classical_chunk_jit(
            fv_p[sl][:, :KF_c], fc_p[sl][:, :KF_c], scv_p[sl], scc_p[sl],
            ccnt_p[sl], diag_p[sl], weak_p[sl], vals, cols, diag, KF=KF_c)
        ws.append(wc)
        keys.append(kc_s)
    w, key_s = _sigma_unpermute_jit(jnp.concatenate(ws)[:n_pad],
                                    jnp.concatenate(keys)[:n_pad], order)
    del ws, keys, fv_p, fc_p, scv_p, scc_p, ccnt_p

    # w/key_s slots are sorted-by-column; dead slots carry INT32_MAX
    pcol = cmap[jnp.where(key_s < _I32_MAX, key_s, 0)]
    pw = int(jnp.max(jnp.sum(w != 0, axis=1)))
    Kp = max(8, _round_up(max(pw, 1), 8))
    return _pack_p_from_w_jit(w, pcol, Cmask, cmap, Kp=Kp)


# ----------------------------------------------------------------------
# stage 2c: extended+i interpolation (interp_type 6), distance-2 with an
# EXTENDED pattern.  Mirrors interp.extended_i_interpolation (De Sterck,
# Falgout, Nolting, Yang 2008) exactly:
#
#     C_i^e  = C_i ∪ {C_k : k ∈ F_i^s}          (extended target set)
#     w_ij   = -( a_ij + Σ_{k∈F_i^s} a_ik hat_a_kj / d_ik ) / tilde_a_ii
#     d_ik   = Σ_{m∈C_i^e} hat_a_km + hat_a_ki              ("+i" term)
#     tilde  = a_ii + Σ_{W_i} a_in + Σ_k a_ik hat_a_ki / d_ik  (backflow)
#              (+ a_ik where d_ik = 0)
#
# Device formulation: the extended column set is built per row chunk as a
# sort of [own offd cols (value a_ij, pattern = strong-C)] ++ [each
# strong-F neighbor's packed strong-C cols (value 0, pattern = 1)], with
# Hillis-Steele doubling passes collapsing runs (sum for values, OR for
# the pattern flag) — pattern runs left-pack to the static width Kce.
# The strong-F probe loop then rank-matches each neighbor's full row
# against the extended sorted set (same compare-count machinery as the
# classical path), accumulating T scatter-free via a one-hot contraction
# plus the hat_a_ki backflow onto the diagonal.  The gate-3 pressure
# config (interp_type 6, tools/gatefix.py; ref src/HypreSystem.cpp:
# 205-216) runs this path on device.


def _hillis_sum(vals, cols):
    """Within-run inclusive sums over a column-SORTED row (runs =
    contiguous equal columns); log2(M) static shift+where+add steps."""
    M = vals.shape[1]
    acc = vals
    s = 1
    while s < M:
        sv = jnp.pad(acc, ((0, 0), (s, 0)))[:, :M]
        sc = jnp.pad(cols, ((0, 0), (s, 0)), constant_values=-1)[:, :M]
        acc = acc + jnp.where(sc == cols, sv, 0.0)
        s *= 2
    return acc


def _hillis_or(flags, cols):
    """Within-run inclusive OR (int32 max) over a column-SORTED row."""
    M = flags.shape[1]
    acc = flags
    s = 1
    while s < M:
        sv = jnp.pad(acc, ((0, 0), (s, 0)))[:, :M]
        sc = jnp.pad(cols, ((0, 0), (s, 0)), constant_values=-1)[:, :M]
        acc = jnp.maximum(acc, jnp.where(sc == cols, sv, 0))
        s *= 2
    return acc


def _exti_cat(vals_c, cols_c, offd_c, strongC_c, fv_c, fc_c, scv, scc,
              ccnt, n_pad):
    """Concatenated (cols, vals, pat) candidate pairs for the extended
    set of one row chunk, sorted by column.  Neighbor strong-C cols are
    fetched through the packed (n, Kc) planes; dead slots carry INF."""
    C_, K = cols_c.shape
    KF = fc_c.shape[1]
    Kc = scc.shape[1]
    INF = jnp.int32(_I32_MAX)
    own_cols = jnp.where(offd_c & (vals_c != 0), cols_c, INF)
    own_vals = jnp.where(own_cols < INF, vals_c, 0.0)
    own_pat = strongC_c.astype(jnp.int32)
    k = fc_c                                          # (C, KF)
    nb_cols = scc[k]                                  # (C, KF, Kc)
    nb_live = (jnp.arange(Kc, dtype=jnp.int32)[None, None, :]
               < ccnt[k][:, :, None])
    nb_live = nb_live & (fv_c != 0)[:, :, None]
    nb_cols = jnp.where(nb_live, nb_cols, INF).reshape(C_, KF * Kc)
    cat_c = jnp.concatenate([own_cols, nb_cols], axis=1)
    cat_v = jnp.concatenate(
        [own_vals, jnp.zeros((C_, KF * Kc), vals_c.dtype)], axis=1)
    cat_p = jnp.concatenate(
        [own_pat, nb_live.astype(jnp.int32).reshape(C_, KF * Kc)], axis=1)
    c_s, v_s, p_s = lax.sort((cat_c, cat_v, cat_p), dimension=1,
                             num_keys=1)
    return c_s, v_s, p_s


@jax.jit
def _exti_width_jit(vals_c, cols_c, offd_c, strongC_c, fv_c, fc_c, scv,
                    scc, ccnt):
    """Max distinct extended-pattern columns over the chunk's rows."""
    c_s, _, p_s = _exti_cat(vals_c, cols_c, offd_c, strongC_c, fv_c,
                            fc_c, scv, scc, ccnt, 0)
    INF = jnp.int32(_I32_MAX)
    pat_run = _hillis_or(p_s, c_s)
    nxt = jnp.concatenate(
        [c_s[:, 1:], jnp.full((c_s.shape[0], 1), -1, c_s.dtype)], 1)
    end = (c_s != nxt) & (c_s < INF) & (pat_run > 0)
    return jnp.max(jnp.sum(end, axis=1))


@partial(jax.jit, static_argnames=("Kce", "KF", "row0"))
def _exti_chunk_jit(vals_c, cols_c, offd_c, strongC_c, fv_c, fc_c,
                    diag_c, weak_c, scv, scc, ccnt, vals, cols, diag,
                    Kce, KF, row0):
    """One row chunk of the extended+i weights: returns (w, keyc) over
    the extended sorted columns (INF on dead slots)."""
    C_, K = vals_c.shape
    INF = jnp.int32(_I32_MAX)
    c_s, v_s, p_s = _exti_cat(vals_c, cols_c, offd_c, strongC_c, fv_c,
                              fc_c, scv, scc, ccnt, 0)
    val_run = _hillis_sum(v_s, c_s)
    pat_run = _hillis_or(p_s, c_s)
    nxt = jnp.concatenate(
        [c_s[:, 1:], jnp.full((C_, 1), -1, c_s.dtype)], 1)
    end = (c_s != nxt) & (c_s < INF) & (pat_run > 0)
    key = jnp.where(end, c_s, INF)
    key_s, aon_s = lax.sort((key, val_run), dimension=1, num_keys=1)
    keyc = key_s[:, :Kce]
    aon = jnp.where(keyc < INF, aon_s[:, :Kce], 0.0)

    rows_i = row0 + jnp.arange(C_, dtype=jnp.int32)

    def body(t, carry):
        T, dlump, backflow = carry
        k = fc_c[:, t]
        bv = vals[k]                          # (C, K) full neighbor rows
        bc = cols[k]
        hv = jnp.where(bv * diag[k][:, None] < 0, bv, 0.0)
        s = jnp.sum((keyc[:, None, :] < bc[:, :, None]).astype(jnp.int32),
                    axis=2)                                   # (C, K)
        cand = jnp.take_along_axis(keyc, jnp.minimum(s, Kce - 1), axis=1)
        member = (cand == bc) & (s < Kce)
        hvm = jnp.where(member, hv, 0.0)
        hat_i = jnp.sum(jnp.where(bc == rows_i[:, None], hv, 0.0), axis=1)
        d = jnp.sum(hvm, axis=1) + hat_i
        fvt = fv_c[:, t]
        W = jnp.where(d != 0, fvt / jnp.where(d != 0, d, 1.0), 0.0)
        dlump = dlump + jnp.where(d == 0, fvt, 0.0)
        backflow = backflow + W * hat_i
        slot = jnp.where(member, s, Kce)
        onehot = (slot[:, :, None]
                  == jnp.arange(Kce, dtype=jnp.int32)[None, None, :])
        T = T + jnp.einsum("ck,cks->cs", W[:, None] * hvm,
                           onehot.astype(vals.dtype),
                           precision=lax.Precision.HIGHEST)
        return T, dlump, backflow

    z = jnp.zeros((C_,), vals.dtype)
    T, dlump, backflow = lax.fori_loop(
        0, KF, body, (jnp.zeros((C_, Kce), vals.dtype), z, z))
    dii = diag_c + weak_c + dlump + backflow
    dii = jnp.where(dii != 0, dii, 1.0)
    live = keyc < INF
    w = jnp.where(live, -(aon + T) / dii[:, None], 0.0)
    return w, keyc


def _interp_exti_ell(vals, cols, S, Cmask, cmap, diag, log=None):
    """Extended+i interpolation, chunked.  Returns (Pv, Pc, nnz_p) in the
    same ELL layout as the other interpolation stages."""
    n_pad, K = (int(s) for s in vals.shape)
    strongC, strongF, weaksum, kc32, kf32 = _classical_masks_jit(
        vals, cols, S, Cmask)
    Kc = max(1, int(kc32))
    KF = max(1, int(kf32))
    scv, scc, ccnt = _pack_sel_jit(vals, cols, strongC, Ksel=Kc, fillcol=0)
    fv, fc, _ = _pack_sel_jit(vals, cols, strongF, Ksel=KF, fillcol=0)

    rows = jnp.arange(n_pad, dtype=jnp.int32)[:, None]
    offd = cols != rows

    Wcat = K + KF * Kc
    itemsize = np.dtype(vals.dtype).itemsize
    budget = 1 << 28
    chunk = max(256, min(n_pad, budget // max(Wcat * 12 * itemsize, 1)))
    chunk = _round_up(chunk, 256)
    nch = (n_pad + chunk - 1) // chunk

    def _pad_rows(a):
        want = nch * chunk
        return a if a.shape[0] == want else jnp.pad(
            a, ((0, want - a.shape[0]),) + ((0, 0),) * (a.ndim - 1))

    vals_p, cols_p = _pad_rows(vals), _pad_rows(cols)
    offd_p, sc_p = _pad_rows(offd), _pad_rows(strongC)
    fv_p, fc_p = _pad_rows(fv), _pad_rows(fc)
    diag_p, weak_p = _pad_rows(diag), _pad_rows(weaksum)
    del strongC, strongF

    # width pre-pass (async per chunk, one fetch)
    widths = []
    for c in range(nch):
        sl = slice(c * chunk, (c + 1) * chunk)
        widths.append(_exti_width_jit(vals_p[sl], cols_p[sl], offd_p[sl],
                                      sc_p[sl], fv_p[sl], fc_p[sl], scv,
                                      scc, ccnt))
    Kce = max(1, max(int(x) for x in jax.device_get(widths)))
    Kce = _round_up(Kce, 4)
    if log is not None:
        log(f"      ext+i interp: KF={KF} Kc={Kc} Kce={Kce} chunks={nch}")

    ws, keys = [], []
    for c in range(nch):
        sl = slice(c * chunk, (c + 1) * chunk)
        wc, kc_s = _exti_chunk_jit(
            vals_p[sl], cols_p[sl], offd_p[sl], sc_p[sl], fv_p[sl],
            fc_p[sl], diag_p[sl], weak_p[sl], scv, scc, ccnt, vals, cols,
            diag, Kce=Kce, KF=KF, row0=c * chunk)
        ws.append(wc)
        keys.append(kc_s)
    w = jnp.concatenate(ws)[:n_pad]
    key_s = jnp.concatenate(keys)[:n_pad]
    del ws, keys, vals_p, cols_p, offd_p, sc_p, fv_p, fc_p

    pcol = cmap[jnp.where(key_s < _I32_MAX, key_s, 0)]
    pw = int(jnp.max(jnp.sum(w != 0, axis=1)))
    Kp = max(8, _round_up(max(pw, 1), 8))
    return _pack_p_from_w_jit(w, pcol, Cmask, cmap, Kp=Kp)


# ----------------------------------------------------------------------
# sort-based sparse products (expand -> sort -> segment scatter-add)

# shared pack width for _chunked_product chunks (see comment there)
PACK_W = 128


def _expand_sorted(avals_c, acols_c, Bv, Bc, sentinel):
    """(C, K) left chunk x B (ELL) -> expanded+sorted (C, K*Kb)
    (vals, cols); dead terms carry the sentinel column (sorted last)."""
    amask = avals_c != 0
    bv = Bv[acols_c]                              # (C, K, Kb)
    bc = Bc[acols_c]
    term = avals_c[:, :, None] * bv
    ok = amask[:, :, None] & (bv != 0)
    cols = jnp.where(ok, bc, sentinel)
    term = jnp.where(ok, term, 0.0)
    Cn = avals_c.shape[0]
    cols = cols.reshape(Cn, -1)
    term = term.reshape(Cn, -1)
    cols_s, term_s = lax.sort((cols, term), dimension=1, num_keys=1)
    return term_s, cols_s


_expand_sorted_jit = jax.jit(_expand_sorted, static_argnames=("sentinel",))


@partial(jax.jit, static_argnames=("sentinel",))
def _run_counts(colsM, sentinel):
    """Per-row count of distinct non-sentinel columns in a SORTED (C, M)
    block."""
    prev = jnp.concatenate(
        [jnp.full((colsM.shape[0], 1), -1, colsM.dtype), colsM[:, :-1]], 1)
    start = (colsM != prev) & (colsM < sentinel)
    return jnp.sum(start, axis=1, dtype=jnp.int32)


@partial(jax.jit, static_argnames=("sentinel",))
def _run_stats(colsM, sentinel):
    """(max distinct-run width, total runs) of a SORTED (C, M) block —
    one tiny fetch per chunk fixes the pack width without a second
    expand/sort pass."""
    cnt = _run_counts(colsM, sentinel=sentinel)
    return jnp.max(cnt), jnp.sum(cnt)


@partial(jax.jit, static_argnames=("Kout",))
def _pack_runs(valsM, colsM, sent_arr, Kout):
    """SORTED (C, M) -> dedup-packed (C, Kout) ELL.

    Scatter-free (a (C, M) segment scatter-add took most of the spgemm
    phase where it was measured before), so the segment sums come from a Hillis-Steele doubling pass over the
    sorted row — acc[j] += acc[j-s] while col[j-s] == col[j], s doubling —
    and the boundary elements are left-compacted by a second lax.sort on
    the masked column key.  Runs are contiguous equal-column spans, so
    the column-equality guard is exactly the segment boundary, and each
    run sums ONLY its own terms (exact: no cross-run differencing — a
    row-wide cumsum differenced at run boundaries leaks absolute error
    proportional to the preceding prefix into small late runs, measured
    ~2.0 abs at 1e6 contrast in a 512-wide row).

    HLO-size note: this unrolls to ~log2(M) shift+where+add steps — a
    flat ~40-op graph.  Both lax.associative_scan and the cumsum+cummax
    formulation compiled pathologically slowly at production chunk
    shapes ((65536, 1024)); this version compiles in seconds."""
    Cn, M = colsM.shape
    nxt = jnp.concatenate(
        [colsM[:, 1:], jnp.full((Cn, 1), -1, colsM.dtype)], 1)
    valid = colsM < sent_arr
    end = (colsM != nxt) & valid

    runsum = valsM
    s = 1
    while s < M:
        sv = jnp.pad(runsum, ((0, 0), (s, 0)))[:, :M]
        sc = jnp.pad(colsM, ((0, 0), (s, 0)), constant_values=-1)[:, :M]
        runsum = runsum + jnp.where(sc == colsM, sv, 0.0)
        s *= 2
    key = jnp.where(end, colsM, sent_arr)     # run ends keep their column
    key_s, val_s = lax.sort((key, runsum), dimension=1, num_keys=1)
    oc = key_s[:, :Kout]
    ov = val_s[:, :Kout]
    ok = oc < sent_arr
    return jnp.where(ok, ov, 0.0).astype(valsM.dtype), jnp.where(ok, oc, 0)


def _chunked_product(Av, Acols, Bv, Bc, sentinel, log=None, tag=""):
    """ELL x ELL -> dedup-packed ELL, chunked over rows of the left factor.

    Single pass: each chunk expand/sorts once, a tiny (max, sum) fetch
    fixes that chunk's pack width, and chunks are padded to the global
    width at the end.  (A widths-then-pack two-pass formulation sorts the
    expansion twice — the sort IS the cost — for the sole benefit of one
    shared pack shape; per-chunk widths cluster on a handful of rounded
    values, so the pack recompiles stay cheap.)"""
    n_pad, K = Av.shape
    Kb = Bv.shape[1]
    itemsize = np.dtype(Av.dtype).itemsize
    budget = 1 << 28                               # ~256 MB per expansion
    chunk = max(256, min(n_pad, budget // max(K * Kb * itemsize, 1)))
    chunk = _round_up(chunk, 256)
    nch = (n_pad + chunk - 1) // chunk
    pad_to = nch * chunk
    if pad_to != n_pad:
        Av = jnp.pad(Av, ((0, pad_to - n_pad), (0, 0)))
        Acols = jnp.pad(Acols, ((0, pad_to - n_pad), (0, 0)))

    # every chunk packs at the FIXED width PACK_W (the scatter volume is
    # the expansion size, independent of the output width, and one shared
    # width keeps a single compiled pack per chunk shape).  All chunks DISPATCH asynchronously
    # (no host sync inside the loop: a per-chunk stats fetch serializes
    # the expand/sort pipeline — measured ~2x on the 13-chunk L1 A@P);
    # the width/nnz stats are fetched together afterwards, and the rare
    # chunk wider than PACK_W is re-packed at its own rounded width.
    sent_arr = jnp.int32(sentinel)
    ovs, ocs, stats = [], [], []
    for c in range(nch):
        sl = slice(c * chunk, (c + 1) * chunk)
        tv, tc = _expand_sorted_jit(Av[sl], Acols[sl], Bv, Bc,
                                    sentinel=sentinel)
        stats.append(_run_stats(tc, sentinel=sentinel))
        ov, oc = _pack_runs(tv, tc, sent_arr, Kout=PACK_W)
        ovs.append(ov)
        ocs.append(oc)
    stats = jax.device_get(stats)
    nnz = int(sum(int(s[1]) for s in stats))
    kmax = max(1, max(int(s[0]) for s in stats))
    for c in range(nch):                      # overflow fallback (rare)
        if int(stats[c][0]) > PACK_W:
            sl = slice(c * chunk, (c + 1) * chunk)
            tv, tc = _expand_sorted_jit(Av[sl], Acols[sl], Bv, Bc,
                                        sentinel=sentinel)
            Kc_ = _round_up(int(stats[c][0]), 32)
            ovs[c], ocs[c] = _pack_runs(tv, tc, sent_arr, Kout=Kc_)
    Kout = max(8, _round_up(kmax, 8))
    wide = max(o.shape[1] for o in ovs)
    ovs = [o if o.shape[1] == wide else
           jnp.pad(o, ((0, 0), (0, wide - o.shape[1]))) for o in ovs]
    ocs = [o if o.shape[1] == wide else
           jnp.pad(o, ((0, 0), (0, wide - o.shape[1]))) for o in ocs]
    if log is not None:
        log(f"      spgemm[{tag}]: K={Kout} nnz={nnz} chunks={nch}")
    return (jnp.concatenate(ovs)[:n_pad, :Kout],
            jnp.concatenate(ocs)[:n_pad, :Kout], Kout, nnz)


# ----------------------------------------------------------------------
# R = P^T via one global stable sort over P's COO expansion

_I32_MAX = 2**31 - 1


@jax.jit
def _p_coo_sorted(Pv, Pc):
    """P's COO expansion stable-sorted by coarse column (dead slots carry
    INT32_MAX keys, sorted last)."""
    n_pad = Pv.shape[0]
    rows = jnp.broadcast_to(
        jnp.arange(n_pad, dtype=jnp.int32)[:, None], Pv.shape).reshape(-1)
    vals = Pv.reshape(-1)
    cols = Pc.reshape(-1)
    live = vals != 0
    key = jnp.where(live, cols, jnp.int32(_I32_MAX))
    return lax.sort((key, rows, vals), dimension=0, num_keys=1,
                    is_stable=True)


@partial(jax.jit, static_argnames=("nc", "Kr"))
def _pack_transpose(key_s, rows_s, vals_s, nc, Kr):
    """Sorted COO (by coarse col) -> (nc, Kr) ELL of R = P^T."""
    m = key_s.shape[0]
    idx = jnp.arange(m, dtype=jnp.int32)
    start = key_s != jnp.concatenate(
        [jnp.full((1,), -1, key_s.dtype), key_s[:-1]])
    # lax.cummax, NOT associative_scan(maximum): the generic scan compiles
    # pathologically slowly at 2M elements; the native cumulative-max HLO
    # compiles in seconds
    first = lax.cummax(jnp.where(start, idx, -1))
    rank = idx - first
    valid = key_s < jnp.int32(_I32_MAX)
    rr = jnp.where(valid, key_s, nc)
    kk = jnp.where(valid, rank, Kr)
    ov = jnp.zeros((nc, Kr), vals_s.dtype).at[rr, kk].set(
        vals_s, mode="drop")
    oc = jnp.zeros((nc, Kr), jnp.int32).at[rr, kk].set(
        rows_s, mode="drop")
    return ov, oc


# ----------------------------------------------------------------------
# orchestrator

def device_level0_ell(A: ShardedMatrix, cfg, *, A_host=None,
                      seed: int = 1234, log=None):
    """Run the fine-level setup on device for a generic ELL operator.

    Returns the same result dict as device_setup.device_level0, or None
    if coarsening stalls (caller falls back to the host pipeline)."""
    if A.nparts > 1:
        from tpusolve.amg.device_setup_ell_mp import device_level0_ell_mp
        return device_level0_ell_mp(A, cfg, A_host=A_host, seed=seed,
                                    log=log)
    t0 = _time.perf_counter()

    def _phase(label):
        if log is not None:
            # drain the dispatch queue so phase times attribute correctly
            # (same as device_setup._phase; without it async work bleeds
            # into whichever later phase first syncs)
            jax.block_until_ready([x for x in jax.live_arrays()
                                   if not x.is_deleted()])
            t = _time.perf_counter()
            log(f"    setup[dev-ell]: {label:24s} {t - t0:8.2f}s")
        return _time.perf_counter()

    mesh = A.mesh
    n = A.shape[0]
    dt = A.dtype

    vals, cols = _stage_ell(A, A_host)
    n_pad, K = (int(s) for s in vals.shape)
    if K > MAX_ELL_K:
        return None
    t0 = _phase("ELL staging")

    # --- strength + PMIS (host-identical tie-break order, exact int
    # ranks — see _stage1_jit docstring) ---
    theta = float(cfg.strong_threshold)
    from tpusolve.amg.device_setup import (pmis_rank, pmis_rank_device,
                                           use_host_rank)
    if use_host_rank():
        rank = jnp.asarray(pmis_rank(seed, n, n_pad))
    else:
        rank = pmis_rank_device(seed, n_pad)
    max_rounds = 10 * int(np.ceil(np.log2(n + 2))) + 20
    S, state, diag = _stage1(vals, cols, rank, n=n,
                             theta=theta, max_rounds=max_rounds)
    Cmask = (state == 1).astype(dt)
    nc = int(jnp.sum(Cmask))
    t0 = _phase("strength+PMIS")
    if nc == 0 or nc >= n:
        return None

    # --- interpolation (direct: row-local; classical: distance-2) ---
    cmap = jnp.cumsum(state == 1).astype(jnp.int32) - 1
    if cfg.interp_type == 0:
        Pv, Pc, nnz_p32 = _interp_classical_ell(vals, cols, S, Cmask,
                                                cmap, diag, log=log)
    elif cfg.interp_type == 6:
        Pv, Pc, nnz_p32 = _interp_exti_ell(vals, cols, S, Cmask,
                                           cmap, diag, log=log)
    else:
        pw = int(jnp.max(jnp.sum(
            S & (Cmask[jnp.where(S, cols, 0)] > 0) & (Cmask[:, None] == 0),
            axis=1)))
        Kp = max(8, _round_up(max(pw, 1), 8))
        Pv, Pc, nnz_p32 = _interp_direct_jit(vals, cols, S, Cmask, cmap,
                                             diag, Kp=Kp)
    nnz_p = int(nnz_p32)
    del S

    # smoother data (while the fine ELL is still live)
    @jax.jit
    def smoother_data(vals, diag):
        d = jnp.where(diag != 0, diag, 1.0)
        l1 = jnp.sum(jnp.abs(vals), axis=1)
        return 1.0 / d, 1.0 / jnp.where(l1 != 0, l1, 1.0)

    dinv, dinv_l1 = smoother_data(vals, diag)
    t0 = _phase("interpolation")

    # --- W = A @ P (chunked expand/sort/pack) ---
    Wv, Wc, Kw, nnz_w = _chunked_product(vals, cols, Pv, Pc, sentinel=nc,
                                         log=log, tag="A@P")
    t0 = _phase("A@P")

    # --- R = P^T (global stable sort of P's COO) ---
    key_s, rows_s, vals_s = _p_coo_sorted(Pv, Pc)
    rcnt = jnp.zeros((nc + 1,), jnp.int32).at[
        jnp.where(key_s < _I32_MAX, key_s, nc)].add(1)
    Kr = max(8, _round_up(int(jnp.max(rcnt[:nc])), 8))
    Rv, Rc = _pack_transpose(key_s, rows_s, vals_s, nc=nc, Kr=Kr)
    del key_s, rows_s, vals_s
    t0 = _phase("R = P^T")

    # --- Ac = R @ W ---
    Acv, Acc, Kc, nnz_c = _chunked_product(Rv, Rc, Wv, Wc, sentinel=nc,
                                           log=log, tag="R@(AP)")
    del Wv, Wc
    t0 = _phase("R@(AP)")

    # --- wrap as ShardedMatrix (single part; coarse vectors length nc,
    # exactly like the DIA device path) ---
    rows_c = jnp.arange(nc, dtype=jnp.int32)[:, None]
    dmain = jnp.sum(jnp.where((Acc == rows_c) & (Acv != 0), Acv, 0.0),
                    axis=1)
    dmain = jnp.where(dmain == 0, 1.0, dmain)
    col_off_c = np.array([0, nc], np.int64)
    row_off_f = np.array([0, n], np.int64)
    Ac_sh = _ell_sharded(mesh, (nc, nc), Acv, Acc, col_off_c, col_off_c,
                         dmain, nnz_c, axis=A.axis)
    P_sh = _ell_sharded(mesh, (n, nc), Pv, Pc, row_off_f, col_off_c,
                        jnp.ones(n_pad, dt), nnz_p, axis=A.axis)
    R_sh = _ell_sharded(mesh, (nc, n), Rv, Rc, col_off_c, row_off_f,
                        jnp.ones(nc, dt), nnz_p, axis=A.axis)
    del Pv, Pc, Rv, Rc
    t0 = _phase("P/R/Ac wrap")

    # --- coarse CSR fetch is DEFERRED: full device recursion (builder.py)
    # never pays the device->host transfer; the closure runs only if the
    # caller actually drops to the host pipeline ---
    def _fetch_coarse_csr():
        # compact the ELL to exact-nnz COO on device first: the padded
        # planes are ~10x the live data.  nnz_c is a static cap (counts runs, some of
        # which may have cancelled to exactly 0 — hence the [:total] cut).
        cap = max(int(nnz_c), 1)

        @partial(jax.jit, static_argnames=("cap",))
        def _compact(Av_, Ac_, cap):
            mask2 = Av_ != 0
            counts = jnp.sum(mask2, axis=1).astype(jnp.int32)
            mask = mask2.reshape(-1)
            pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
            tgt = jnp.where(mask, pos, cap)
            out_v = jnp.zeros((cap,), Av_.dtype).at[tgt].set(
                Av_.reshape(-1), mode="drop")
            out_c = jnp.zeros((cap,), jnp.int32).at[tgt].set(
                Ac_.reshape(-1), mode="drop")
            return out_v, out_c, counts, jnp.sum(mask)

        out_v, out_c, counts, tot = jax.device_get(
            _compact(Acv, Acc, cap=cap))
        total = int(tot)
        indptr = np.zeros(nc + 1, np.int64)
        np.cumsum(counts[:nc], out=indptr[1:])
        Ah_c = sp.csr_matrix((out_v[:total].astype(np.float64),
                              out_c[:total].astype(np.int64), indptr),
                             shape=(nc, nc))
        # runs are emitted in ascending column order, but the raw
        # constructor leaves has_sorted_indices unset — assert it so the
        # native setup kernels accept the coarse level without a numpy
        # fallback
        Ah_c.sort_indices()
        return Ah_c

    return dict(Cmask=Cmask, nc=nc, P=P_sh, R=R_sh, Ac=Ac_sh,
                Ah_c_fn=_fetch_coarse_csr, dinv=dinv, dinv_l1=dinv_l1,
                coarse_row_offsets=np.array([0, nc], np.int64))
