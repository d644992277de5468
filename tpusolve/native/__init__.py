"""Native (C++) IO layer, loaded via ctypes.

The shared library is compiled on first use with the system g++ into a
build directory keyed by source, command and host CPU (analog of the reference's CMake-built parser objects);
all callers fall back to pure-NumPy parsing when no toolchain is available.
"""

from tpusolve.native.build import get_lib, available

__all__ = ["get_lib", "available"]
