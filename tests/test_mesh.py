import numpy as np
import pytest

from tpusolve.mesh import (
    row_decomposition, owner_of, local_range, compute_3d_process_distribution)


def test_even_decomposition():
    off = row_decomposition(100, 4)
    assert off.tolist() == [0, 25, 50, 75, 100]


def test_remainder_spread_to_first_ranks():
    # reference rule: HypreSystem.cpp:529-535
    off = row_decomposition(10, 4)
    counts = np.diff(off).tolist()
    assert counts == [3, 3, 2, 2]
    assert off[-1] == 10


def test_single_part():
    off = row_decomposition(7, 1)
    assert off.tolist() == [0, 7]


def test_more_parts_than_rows():
    off = row_decomposition(3, 5)
    assert np.diff(off).tolist() == [1, 1, 1, 0, 0]


def test_owner_of():
    off = row_decomposition(10, 4)  # [0,3,6,8,10]
    owners = owner_of(np.arange(10), off)
    assert owners.tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 3, 3]


def test_local_range():
    off = row_decomposition(10, 4)
    assert local_range(off, 0) == (0, 2)
    assert local_range(off, 3) == (8, 9)


@pytest.mark.parametrize("n,expected_prod", [(1, 1), (8, 8), (12, 12),
                                             (17, 17), (64, 64), (1000, 1000)])
def test_3d_process_distribution(n, expected_prod):
    px, py, pz = compute_3d_process_distribution(n)
    assert px * py * pz == expected_prod
    assert px >= py >= pz >= 1


def test_3d_distribution_near_cubic():
    assert compute_3d_process_distribution(8) == (2, 2, 2)
    assert compute_3d_process_distribution(64) == (4, 4, 4)


class TestInitDistributed:
    """Multi-process init keys off JAX_COORDINATOR_ADDRESS alone: no
    coordinator means one process; a coordinator means initialize, and a
    failed initialization raises instead of continuing single-process."""

    def test_no_coordinator_is_noop(self, monkeypatch):
        from tpusolve.mesh import init_distributed
        monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
        assert init_distributed() is False

    def test_live_backend_skips_multiprocess(self, monkeypatch):
        # coordinator given but the backend is already up (library use,
        # tests): too late to join, so decline rather than raise
        import jax
        jax.devices()  # force backend up
        from tpusolve.mesh import init_distributed
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:9999")
        assert init_distributed() is False

    def test_coordinator_env_is_passed(self, monkeypatch):
        import jax
        from jax._src import xla_bridge
        from tpusolve.mesh import init_distributed
        calls = []
        monkeypatch.setattr(xla_bridge, "backends_are_initialized",
                            lambda: False)
        monkeypatch.setattr(jax.distributed, "initialize",
                            lambda **kw: calls.append(kw))
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:7777")
        monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
        monkeypatch.setenv("JAX_PROCESS_ID", "2")
        assert init_distributed() is True
        assert calls == [dict(coordinator_address="localhost:7777",
                              num_processes=4, process_id=2)]

    def test_failed_init_raises(self, monkeypatch):
        import jax
        from jax._src import xla_bridge
        from tpusolve.mesh import init_distributed

        def refuse(**kw):
            raise RuntimeError("coordinator unreachable")

        monkeypatch.setattr(xla_bridge, "backends_are_initialized",
                            lambda: False)
        monkeypatch.setattr(jax.distributed, "initialize", refuse)
        monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "localhost:7777")
        with pytest.raises(RuntimeError, match="unreachable"):
            init_distributed()
