"""C/F splitting (coarsening).

Coarsening policy for the ``coarsen_type`` codes the reference
exposes (src/HypreSystem.cpp:125-126; default 8 = PMIS, yaml example 6 =
Falgout).  PMIS (parallel modified independent set, De Sterck-Yang-Heys) is
the data-parallel algorithm — every step is a neighborhood max, which is the
shape that later ports to a jittable device implementation — so all GS-era
codes map onto it:

    0/3/6 (RS/RS3/Falgout) -> PMIS   (sequential sweeps don't vectorize)
    8 (PMIS), 10 (HMIS)    -> PMIS
    7 (CLJP)               -> CLJP-style PMIS with full tie-breaking

The mapping is reported by the builder so iteration-count comparisons against
BoomerAMG are made at matched (PMIS) settings.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

F_PT, C_PT, UNDECIDED = 0, 1, -1


def pmis(S: sp.csr_matrix, seed: int = 1234) -> np.ndarray:
    """PMIS C/F splitting.

    S is the strength pattern (S[i,j]=1 iff j strongly influences i).
    Returns an int array: 1 = C-point, 0 = F-point.
    """
    n = S.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    S = S.tocsr()

    # measure: number of points i strongly influences (|S^T row|) + rand
    rng = np.random.default_rng(seed)
    influence = np.bincount(S.indices, minlength=n).astype(np.float64)
    w = influence + rng.random(n)

    # native kernel (sk_pmis): same synchronous rounds on the same w, with
    # active-set shrinking (the numpy rounds below rescan the full graph)
    from tpusolve.native import spk
    state_n = spk.pmis(S, w)
    if state_n is not None:
        return state_n

    St = S.T.tocsr()

    state = np.full(n, UNDECIDED, np.int64)
    # points that influence nothing and depend on nothing: isolated -> F
    # PMIS: initial F-points are those with measure < 1 (no influence)
    state[influence == 0] = F_PT

    # symmetrized adjacency for the independent-set test
    G = ((S + St) > 0).tocsr()

    active = state == UNDECIDED
    max_rounds = 10 * int(np.ceil(np.log2(n + 2))) + 20
    for _ in range(max_rounds):
        if not active.any():
            break
        # candidate C: w[i] > w[j] for all active graph neighbors j
        w_active = np.where(active, w, -1.0)
        # neighbor max via sparse matvec on the adjacency max-plus: use
        # G @ indicator trick per value is wrong; do it with segment max
        nbr_max = _neighbor_max(G, w_active)
        is_max = active & (w_active > nbr_max)
        state[is_max] = C_PT
        # any active point strongly influenced BY a new C-point becomes F:
        # i is F if S[i, j] = 1 for some new C j
        newC = np.zeros(n)
        newC[is_max] = 1.0
        influenced = (S @ newC) > 0
        becomes_F = active & ~is_max & influenced
        state[becomes_F] = F_PT
        active = state == UNDECIDED
    # leftovers (ties exhausted rounds): make them C for safety
    state[state == UNDECIDED] = C_PT
    return state


def _neighbor_max(G: sp.csr_matrix, w: np.ndarray) -> np.ndarray:
    """max over graph neighbors of w (excluding self), -1 for no neighbors."""
    n = G.shape[0]
    out = np.full(n, -1.0)
    indptr, indices = G.indptr, G.indices
    counts = np.diff(indptr)
    nonempty = counts > 0
    if nonempty.any():
        vals = w[indices]
        out[nonempty] = np.maximum.reduceat(vals, indptr[:-1][nonempty])
    return out


def aggressive_pmis(S: sp.csr_matrix, seed: int = 1234) -> np.ndarray:
    """Two-pass aggressive coarsening (``agg_num_levels`` levels use this;
    ref: src/HypreSystem.cpp:207-213).  BoomerAMG's A2 scheme: a standard
    PMIS pass, then a second PMIS over the *distance-2 strength graph
    restricted to first-pass C-points* — only the survivors stay C.  Final
    C-points are distance <= 2 from every F-point, so interpolation must be
    distance-2 capable (multipass / extended)."""
    n = S.shape[0]
    split1 = pmis(S, seed=seed)
    C1 = np.flatnonzero(split1 == C_PT)
    if C1.size <= 1:
        return split1
    # distance-2 strength restricted to C1, WITHOUT materializing the full
    # (Sb @ Sb) graph: (Sb@Sb)[C1][:, C1] == Sb[C1] @ Sb[:, C1], so
    # restricting both factors first shrinks the product's work and output
    # by ~(|C1|/n)^2 (the full product dominated setup on big fine levels)
    Sb = S.tocsr().astype(bool)
    Sb_rows = Sb[C1]                       # (|C1|, n)
    Sb_cols = Sb.tocsc()[:, C1].tocsr()    # (n, |C1|)
    from tpusolve.native import spk
    prod = spk.spgemm(Sb_rows.astype(np.float64),
                      Sb_cols.astype(np.float64))
    if prod is None:
        prod = Sb_rows @ Sb_cols
    S2 = (prod.astype(bool) + Sb_rows[:, C1]).tocsr()
    S2.setdiag(False)
    S2.eliminate_zeros()
    sub = pmis(S2.astype(np.float64), seed=seed + 1)
    # a first-pass C-point isolated in the restricted graph (no other
    # C1 within distance 2) must stay C: demoting it would strand its
    # F-children with no coarse anchor at any distance
    isolated = np.diff(S2.indptr) == 0
    sub[isolated] = C_PT
    split = np.full(n, F_PT, np.int64)
    split[C1[sub == C_PT]] = C_PT
    return split


def rs(S: sp.csr_matrix) -> np.ndarray | None:
    """Classical Ruge-Stueben splitting via the native C++ kernel
    (sk_rs_coarsen) — exact serial first+second-pass semantics of the
    reference's default coarsen_type 6 (Falgout; single-process Falgout
    reduces to RS).  None when the native library is unavailable."""
    from tpusolve.native import spk
    return spk.rs_coarsen(S)


# hypre coarsen_type codes: 0=CLJP, 1=RS(classical), 3=RS(strong boundary),
# 6=Falgout, 7=CLJP-c, 8=PMIS, 10=HMIS, 21/22=CGC.  CLJP-family codes map to
# the PMIS independent-set path (same parallel MIS structure); the serial-RS
# kernel backs the RS-family codes (Falgout reduces to RS single-process).
COARSEN_MAP = {
    0: "pmis", 1: "rs", 3: "rs", 6: "rs", 7: "pmis", 8: "pmis", 10: "pmis",
    21: "pmis", 22: "pmis",
}


def coarsen(S: sp.csr_matrix, coarsen_type: int = 8, seed: int = 1234):
    """Dispatch on the reference's coarsen_type codes -> (splitting, note).

    note records any substitution performed (sequential algorithms mapped to
    PMIS) for reporting parity with BoomerAMG settings.
    """
    algo = COARSEN_MAP.get(coarsen_type)
    if algo is None:
        raise ValueError(f"unsupported coarsen_type {coarsen_type}")
    note = None
    if algo == "rs":
        split = rs(S)
        if split is not None:
            if coarsen_type == 6:
                note = ("coarsen_type 6 (Falgout) run as serial RS "
                        "(Falgout reduces to RS without subdomains)")
            elif coarsen_type == 3:
                note = ("coarsen_type 3 (RS + strong boundary) run as "
                        "serial RS (no subdomain boundaries single-process)")
            return split, note
        note = (f"coarsen_type {coarsen_type} mapped to PMIS "
                "(native RS kernel unavailable)")
        return pmis(S, seed=seed), note
    if coarsen_type not in (8,):
        note = (f"coarsen_type {coarsen_type} mapped to PMIS "
                "(CLJP-family independent-set coarsening, "
                "data-parallel policy)")
    return pmis(S, seed=seed), note
