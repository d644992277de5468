import io
import numpy as np
import pytest
import scipy.sparse as sp

from tpusolve.native import available, get_lib
from tpusolve.formats import mmio, ij
from tpusolve.mesh import row_decomposition


pytestmark = pytest.mark.skipif(not available(),
                                reason="native toolchain unavailable")


def test_lib_builds():
    assert get_lib() is not None


def test_mm_native_matches_python(rng, tmp_path):
    n, m, nnz = 50, 40, 200
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, m, nnz)
    key = rows * m + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    vals = rng.standard_normal(len(rows)) * 10.0 ** rng.integers(-8, 8, len(rows))
    path = tmp_path / "A.mm"
    mmio.write_matrix(path, rows, cols, vals, (n, m),
                      comment="header comment\nsecond line")
    r1, c1, v1, shape = mmio.read_matrix(path)
    # force the python fallback via a file object
    with open(path) as fh:
        r2, c2, v2, _ = mmio.read_matrix(fh)
    o1 = np.lexsort((c1, r1))
    o2 = np.lexsort((c2, r2))
    np.testing.assert_array_equal(r1[o1], r2[o2])
    np.testing.assert_array_equal(c1[o1], c2[o2])
    np.testing.assert_allclose(v1[o1], v2[o2], rtol=1e-15)


def test_mm_native_complex(rng, tmp_path):
    n = 12
    rows = np.arange(n)
    cols = (rows * 3) % n
    vals = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    path = tmp_path / "C.mm"
    mmio.write_matrix(path, rows, cols, vals, (n, n))
    r1, c1, v1, _ = mmio.read_matrix(path)
    with open(path) as fh:
        r2, c2, v2, _ = mmio.read_matrix(fh)
    o1, o2 = np.lexsort((c1, r1)), np.lexsort((c2, r2))
    np.testing.assert_allclose(v1[o1], v2[o2], rtol=1e-15)


def test_ij_native_matches_python(rng, tmp_path):
    n = 40
    rows = rng.integers(0, n, 150)
    cols = rng.integers(0, n, 150)
    key = rows * n + cols
    _, idx = np.unique(key, return_index=True)
    rows, cols = rows[idx], cols[idx]
    vals = rng.standard_normal(len(rows))
    offsets = row_decomposition(n, 3)
    prefix = str(tmp_path / "m")
    ij.write_matrix(prefix, rows, cols, vals, offsets)
    r, c, v = ij.read_matrix(prefix, 3)
    import scipy.sparse as sp
    a = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).toarray()
    b = sp.coo_matrix((v, (r, c)), shape=(n, n)).toarray()
    np.testing.assert_allclose(a, b, rtol=1e-15)


def test_ij_vector_native(rng, tmp_path):
    n = 33
    vec = rng.standard_normal(n)
    offsets = row_decomposition(n, 4)
    prefix = str(tmp_path / "v")
    ij.write_vector(prefix, vec, offsets)
    out = ij.read_dense_vector(prefix, 4, n)
    np.testing.assert_allclose(out, vec, rtol=1e-15)


def test_native_speed_smoke(rng, tmp_path):
    # large-ish file parses correctly end-to-end
    n = 200_000
    rows = np.arange(n)
    cols = (rows * 7 + 3) % n
    vals = rng.standard_normal(n)
    path = tmp_path / "big.mm"
    mmio.write_matrix(path, rows, cols, vals, (n, n))
    import time
    t0 = time.perf_counter()
    r, c, v, _ = mmio.read_matrix(path)
    dt = time.perf_counter() - t0
    assert len(v) == n
    np.testing.assert_allclose(v[:5], vals[:5], rtol=1e-15)
    assert dt < 5.0


class TestSetupKernels:
    """Native setup kernels (spkernels.cpp) vs their numpy formulations —
    exact parity on mixed-sign fixtures (the AMG setup path contract)."""

    def _fixture(self, rng, n=3000, per_row=10, flip=0.15):
        import scipy.sparse as sp
        nnz = per_row * n
        r = rng.integers(0, n, nnz)
        c = rng.integers(0, n, nnz)
        v = -np.abs(rng.standard_normal(nnz))
        A = sp.coo_matrix((v, (r, c)), shape=(n, n)).tocsr()
        A = A + A.T
        A.data = np.where(rng.random(A.nnz) < flip, -A.data, A.data)
        A.setdiag(np.abs(A).sum(axis=1).A1 + 0.5)
        A = A.tocsr()
        A.sort_indices()
        return A

    def _split(self, A, theta=0.25, seed=11):
        from tpusolve.amg import strength as St, coarsen as Co
        from tpusolve.amg import interp as I
        S = St.classical_strength(A, theta)
        split = Co.pmis(S, seed=seed)
        return S, split, split == Co.C_PT, I._coarse_numbering(split)

    def test_classical_interp_matches_numpy(self, rng):
        from tpusolve.native import spk
        from tpusolve.amg import interp as I
        if not spk.available():
            pytest.skip("native lib unavailable")
        A = self._fixture(rng)
        S, split, is_C, cmap = self._split(A)
        Pn = spk.classical_interp(A, S.tocsr(), is_C, cmap)
        assert Pn is not None
        S2 = S.tocsr().copy()
        S2.has_sorted_indices = False   # forces the numpy fallback
        Pf = I.classical_interpolation(A, S2, split)
        d = abs(Pn - Pf)
        assert Pn.nnz == Pf.nnz
        assert (d.max() if d.nnz else 0.0) < 1e-13

    def test_exti_interp_matches_numpy(self, rng):
        from tpusolve.native import spk
        from tpusolve.amg import interp as I
        if not spk.available():
            pytest.skip("native lib unavailable")
        A = self._fixture(rng)
        S, split, is_C, cmap = self._split(A)
        Pn = spk.exti_interp(A, S.tocsr(), is_C, cmap)
        assert Pn is not None
        S2 = S.tocsr().copy()
        S2.has_sorted_indices = False
        Pf = I.extended_i_interpolation(A, S2, split)
        d = abs(Pn - Pf)
        assert Pn.nnz == Pf.nnz
        assert (d.max() if d.nnz else 0.0) < 1e-13

    def test_threaded_matches_serial(self, rng, monkeypatch):
        """Every row-parallel kernel produces bit-identical output with
        TPUSOLVE_NATIVE_THREADS=1 vs =4 (dynamic-chunk scheduling must not
        change results; per-thread stamped scratch must not leak across
        rows)."""
        from tpusolve.native import spk
        if not spk.available():
            pytest.skip("native lib unavailable")
        A = self._fixture(rng, n=6000, per_row=8)
        S, split, is_C, cmap = self._split(A)
        Sc = S.tocsr()
        B = (A @ A).tocsr()
        B.sort_indices()
        dia_t = rng.standard_normal((5000, 9)).astype(np.float32)
        dia_t[rng.random(dia_t.shape) < 0.4] = 0.0
        dia_t[:4] = 0.0   # keep r+off in range at the boundaries
        dia_t[-4:] = 0.0
        offs = np.arange(-4, 5, dtype=np.int64)

        def run_all():
            out = {}
            out["strength"] = spk.strength(A, 0.3)
            out["mask"] = spk.pattern_mask(A, Sc)
            out["spgemm"] = spk.spgemm(A, A)
            out["abt"] = spk.masked_abt(A, B, Sc)
            out["ab"] = spk.masked_ab(A, B, Sc)
            out["sat"] = spk.sampled_transpose(B, Sc)
            out["ci"] = spk.classical_interp(A, Sc, is_C, cmap)
            out["ei"] = spk.exti_interp(A, Sc, is_C, cmap)
            out["dia"] = spk.dia_to_csr(dia_t, offs)
            return out

        monkeypatch.setenv("TPUSOLVE_NATIVE_THREADS", "1")
        ser = run_all()
        monkeypatch.setenv("TPUSOLVE_NATIVE_THREADS", "4")
        par = run_all()
        for k in ser:
            a, b = ser[k], par[k]
            assert a is not None and b is not None, k
            if sp.issparse(a):
                np.testing.assert_array_equal(a.indptr, b.indptr, err_msg=k)
                np.testing.assert_array_equal(a.indices, b.indices,
                                              err_msg=k)
                np.testing.assert_array_equal(a.data, b.data, err_msg=k)
            else:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=k)

    def test_pmis_matches_numpy(self, rng):
        from tpusolve.native import spk
        from tpusolve.amg import strength as St, coarsen as Co
        if not spk.available():
            pytest.skip("native lib unavailable")
        A = self._fixture(rng)
        n = A.shape[0]
        S = St.classical_strength(A, 0.25)
        rng2 = np.random.default_rng(1234)
        infl = np.bincount(S.indices, minlength=n).astype(np.float64)
        w = infl + rng2.random(n)
        sn = spk.pmis(S.tocsr(), w)
        # numpy reference: the synchronous-round formulation
        Sc = S.tocsr()
        Stt = Sc.T.tocsr()
        state = np.full(n, Co.UNDECIDED, np.int64)
        state[infl == 0] = Co.F_PT
        G = ((Sc + Stt) > 0).tocsr()
        active = state == Co.UNDECIDED
        for _ in range(500):
            if not active.any():
                break
            wa = np.where(active, w, -1.0)
            nm = Co._neighbor_max(G, wa)
            ismax = active & (wa > nm)
            state[ismax] = Co.C_PT
            newC = np.zeros(n)
            newC[ismax] = 1.0
            becomes_F = active & ~ismax & ((Sc @ newC) > 0)
            state[becomes_F] = Co.F_PT
            active = state == Co.UNDECIDED
        state[state == Co.UNDECIDED] = Co.C_PT
        assert np.array_equal(sn, state)


class TestBuildKey:
    """Native binaries are keyed by source, command and host CPU, so one
    built elsewhere is never loaded."""

    def test_key_depends_on_cpu_command_and_source(self, tmp_path):
        from tpusolve.native import build
        src = tmp_path / "k.cpp"
        src.write_text("int f() { return 1; }\n")
        cmd = ["g++", "-O3", str(src), "-o", "{out}"]
        k = build.build_key(str(src), cmd)
        assert k == build.build_key(str(src), cmd, cpu=build.host_cpu())
        assert k != build.build_key(str(src), cmd, cpu="other cpu")
        assert k != build.build_key(str(src), cmd + ["-march=native"])
        src.write_text("int f() { return 2; }\n")
        assert k != build.build_key(str(src), cmd)

    def test_foreign_binary_is_not_loaded(self, tmp_path, monkeypatch):
        from tpusolve.native import build
        src = tmp_path / "k.cpp"
        src.write_text('extern "C" int f() { return 7; }\n')
        monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
        cmd = ["g++", "-shared", "-fPIC", str(src), "-o", "{out}"]
        # a binary at the key of another CPU (garbage: loading it fails)
        foreign = (tmp_path / "_build"
                   / f"k-{build.build_key(str(src), cmd, cpu='other')}")
        foreign.mkdir(parents=True)
        (foreign / "libk.so").write_bytes(b"not a library")
        path = build._keyed_build("k", str(src), [cmd], "libk.so")
        assert path is not None and str(foreign) not in path
        import ctypes
        assert ctypes.CDLL(path).f() == 7
