"""Pytest configuration: the backend the tests run on.

By default the tests run on an 8-device virtual CPU mesh
(``--xla_force_host_platform_device_count``, the JAX analog of running the
reference under ``mpiexec -np 8`` on one node).  ``JAX_PLATFORMS`` picks
another backend: tests marked ``chip`` need a GPU and skip without one,

    JAX_PLATFORMS=cuda python -m pytest -m chip tests/

XLA_FLAGS is read when the first backend starts, so setting it here works
as long as no backend has been created yet.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

# host/device hierarchy-parity tests require the device PMIS to reproduce
# the host pipeline's exact tie-break order (production default is a
# device-generated permutation — see device_setup.use_host_rank)
os.environ.setdefault("TPUSOLVE_PMIS_HOST_RANK", "1")
