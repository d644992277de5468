"""Build-on-first-use for the native host libraries.

Each library is compiled into ``_build/<name>-<key>/``, where the key hashes
the source, the compiler command and this host's CPU (model and feature
flags, which ``-march=native`` targets).  A binary built from other source,
by another command or on another CPU therefore never matches and is never
loaded.  Without a toolchain the callers fall back to NumPy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import tempfile
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")

_lock = threading.Lock()
_libs: dict = {}


def host_cpu() -> str:
    """Machine, CPU model and feature flags of this host."""
    try:
        with open("/proc/cpuinfo") as fh:
            lines = fh.read().splitlines()
    except OSError:
        lines = []
    keep = sorted({ln for ln in lines
                   if ln.startswith(("model name", "flags", "Features",
                                     "CPU part"))})
    return "\n".join([platform.machine()] + keep)


def build_key(src: str, cmd: list[str], cpu: str | None = None,
              tag: str = "") -> str:
    """Key of the binary ``cmd`` builds from ``src`` on CPU ``cpu``;
    ``tag`` names anything else the binary depends on."""
    h = hashlib.sha256()
    with open(src, "rb") as fh:
        h.update(fh.read())
    for part in ("\0".join(cmd), host_cpu() if cpu is None else cpu, tag):
        h.update(b"\0" + part.encode())
    return h.hexdigest()[:20]


def _keyed_build(name: str, src: str, cmds: list[list[str]],
                 filename: str, tag: str = "") -> str | None:
    """Path of a binary for ``src``, built by the first of ``cmds`` that
    succeeds (each command ends with the output path, given as ``{out}``).
    An existing binary is reused only under its own key."""
    for cmd in cmds:
        out_dir = os.path.join(BUILD_DIR,
                               f"{name}-{build_key(src, cmd, tag=tag)}")
        out = os.path.join(out_dir, filename)
        if os.path.exists(out):
            return out
        os.makedirs(out_dir, exist_ok=True)
        # atomic build: compile to a temp name, rename into place
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        try:
            subprocess.run([tmp if a == "{out}" else a for a in cmd],
                           check=True, capture_output=True, timeout=240)
            os.replace(tmp, out)
            return out
        except (OSError, subprocess.SubprocessError):
            try:
                os.unlink(tmp)
            except OSError:
                pass
    return None


def load_native(name: str, configure) -> "ctypes.CDLL | None":
    """ctypes handle to lib<name>.so built from <name>.cpp on first use;
    None if the toolchain or source is unavailable (callers fall back to
    NumPy).  ``configure(lib)`` sets restype/argtypes."""
    src = os.path.join(_DIR, f"{name}.cpp")
    with _lock:
        if name in _libs:
            return _libs[name]
        _libs[name] = None
        if not os.path.exists(src):
            return None
        base = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread", src,
                "-o", "{out}"]
        # prefer native codegen (vector ISA) but fall back for odd toolchains
        path = _keyed_build(
            name, src, [["g++", "-march=native", "-funroll-loops"] + base,
                        ["g++"] + base], f"lib{name}.so")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            configure(lib)
        except (OSError, AttributeError):
            return None
        _libs[name] = lib
        return lib


def _configure_fastio(lib):
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.fastio_parse_triplets.restype = ctypes.c_int64
    lib.fastio_parse_triplets.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        i64p, i64p, f64p, f64p]
    lib.fastio_parse_pairs.restype = ctypes.c_int64
    lib.fastio_parse_pairs.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i64p, f64p]
    lib.fastio_parse_floats.restype = ctypes.c_int64
    lib.fastio_parse_floats.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
        f64p, f64p]


def get_lib():
    """The fastio parser library (legacy accessor)."""
    return load_native("fastio", _configure_fastio)


_npool_mod = [None, False]


def get_npool():
    """The pooling numpy-allocator extension module (npool.c), compiled on
    first use against the current Python/numpy headers; None when the
    toolchain is unavailable."""
    if _npool_mod[1]:
        return _npool_mod[0]
    _npool_mod[1] = True
    src = os.path.join(_DIR, "npool.c")
    try:
        import sysconfig
        import importlib.util
        import numpy as np
        cmd = ["gcc", "-O2", "-shared", "-fPIC",
               "-I" + sysconfig.get_paths()["include"],
               "-I" + np.get_include(), src, "-o", "{out}"]
        # the module is built against this interpreter's and numpy's headers
        path = _keyed_build("npool", src, [cmd], "npool.so",
                            tag=f"{sys.version} numpy {np.__version__}")
        if path is None:
            return None
        # module name must match PyInit_npool
        spec = importlib.util.spec_from_file_location("npool", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _npool_mod[0] = mod
    except (OSError, ImportError):
        _npool_mod[0] = None
    return _npool_mod[0]


def available() -> bool:
    return get_lib() is not None
