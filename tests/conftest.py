import numpy as np
import pytest
import jax


@pytest.fixture(scope="session")
def mesh8():
    from tpusolve.mesh import make_mesh
    assert len(jax.devices()) >= 8, "tests need 8 virtual CPU devices"
    return make_mesh(8)


@pytest.fixture(scope="session")
def mesh1():
    from tpusolve.mesh import make_mesh
    return make_mesh(1)


@pytest.fixture
def gpu_mesh():
    """A one-GPU mesh; skips where the tests run without a GPU."""
    from tpusolve.mesh import make_mesh
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m chip tests/")
    return make_mesh(1)


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


def random_coo(rng, n, m=None, nnz_per_row=5, ensure_diag=True, dtype=np.float64):
    """Random sparse COO with duplicates possible, diag-dominant if square."""
    m = n if m is None else m
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    cols = rng.integers(0, m, size=n * nnz_per_row, dtype=np.int64)
    vals = rng.standard_normal(n * nnz_per_row).astype(dtype)
    if ensure_diag and n == m:
        rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
        cols = np.concatenate([cols, np.arange(n, dtype=np.int64)])
        vals = np.concatenate([vals, np.full(n, 2.0 * nnz_per_row, dtype)])
    return rows, cols, vals
