"""Local SpMV layouts for unstructured diag blocks: BDIA (blocked-DIA) and
BELL (block-ELL), both plain XLA.

matrix/sharded.py chooses among them, DIA and padded ELL at assembly.
"""

from tpusolve.kernels import bdia, bell  # noqa: F401
