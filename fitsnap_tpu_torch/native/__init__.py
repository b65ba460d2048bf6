"""The native (C++) host neighbor builder.

Counterpart of `fitsnap_tpu/native`: `neighbors.cpp` enumerates periodic
images and neighbor slots in the order of `ops/neighbors.py`'s numpy
builder, without its O(A^2 * S) dense temporaries.  It is built with

    g++ -O3 -march=native -shared -fPIC -o fsnative.so neighbors.cpp

at first use into `build/fitsnap_tpu_torch/native/<digest>/` at the root of
the checkout, where the digest hashes the source, the flags, `g++
--version` and the CPU model, so a library built on one machine is never
loaded on another (`-march=native`).  The build goes to a temporary name
and is then renamed, so processes that build at once do not clash.  There
is no fallback: a failed build raises with g++'s messages.
"""

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "neighbors.cpp"
BUILD_ROOT = (Path(__file__).resolve().parents[2] / "build"
              / "fitsnap_tpu_torch" / "native")
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None


def _cpu_model():
    """The CPU model lines of /proc/cpuinfo ('' where there is none)."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return ""
    return "\n".join(sorted({line for line in text.splitlines()
                             if line.startswith(("model name", "flags"))}))


def build_dir() -> Path:
    """Directory of the library for this source, flags, compiler and CPU."""
    version = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, check=True).stdout
    h = hashlib.sha256(SOURCE.read_bytes())
    for part in (" ".join(FLAGS), version, _cpu_model()):
        h.update(part.encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _build():
    out = build_dir()
    so = out / "fsnative.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = out / f"fsnative.so.{os.getpid()}.tmp"
        proc = subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n"
                               f"{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.fs_neighbors.restype = ctypes.c_int
    lib.fs_neighbors.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8)]
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _build()
        return _lib


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _inputs(pos, cell, natoms):
    pos = np.ascontiguousarray(np.asarray(pos, np.float64)[:natoms])
    cell = np.ascontiguousarray(np.asarray(cell, np.float64))
    return pos, cell


def count_neighbors_native(pos, cell, natoms, cutoff) -> int:
    """Max neighbor count over the atoms of one config."""
    pos, cell = _inputs(pos, cell, natoms)
    return get_lib().fs_neighbors(_dptr(pos), _dptr(cell), natoms, cutoff,
                                  0, 0, None, None, None)


def host_neighbors_native(pos, cell, natoms, cutoff, a_pad=None, k_pad=None):
    """Padded neighbor list of one config, as `ops.neighbors
    .host_neighbors_plain`: (disp (A, K, 3), jidx (A, K) int32, mask (A, K)
    bool, kmax).  Raises ValueError when `k_pad` is below the largest
    neighbor count."""
    lib = get_lib()
    pos, cell = _inputs(pos, cell, natoms)
    kmax = None
    if a_pad is None or k_pad is None:
        kmax = lib.fs_neighbors(_dptr(pos), _dptr(cell), natoms, cutoff,
                                0, 0, None, None, None)
    A = a_pad if a_pad is not None else natoms
    K = k_pad if k_pad is not None else kmax
    disp = np.zeros((A, K, 3), np.float64)
    jidx = np.zeros((A, K), np.int32)
    mask = np.zeros((A, K), np.uint8)
    r = lib.fs_neighbors(
        _dptr(pos), _dptr(cell), natoms, cutoff, A, K, _dptr(disp),
        jidx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if r < 0:
        raise ValueError(f"k_pad={K} too small; need {-r}")
    return disp, jidx, mask.astype(bool), (kmax if kmax is not None else r)
