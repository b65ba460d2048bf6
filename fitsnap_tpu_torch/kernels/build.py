"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under `csrc/` is one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas=-v -o <lib>.so csrc/<name>.cu

Libraries go to `build/fitsnap_tpu_torch/<digest>/` at the root of the
checkout, where the digest hashes the sources and the flags; they are built
at first use, all sources at once in parallel, and reused while the sources
stay the same.  ptxas' register and shared-memory report of each build is
kept beside its library as `<name>.log`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "fitsnap_tpu_torch"
SOURCES = ("pair_u_duals", "zlist", "dbdd", "quad_chain", "pair_scatter",
           "zbl_pair", "device_neighbors", "normal_contrib",
           "ace_pair_basis", "ace_b_dbdd", "nn_force", "nn_grid", "nn_dedu",
           "pair_desc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "fitsnap_tpu_torch are built with the CUDA toolkit")
    return path


def build_dir() -> Path:
    """Directory of the libraries for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source that has no library yet, in parallel."""
    out = build_dir()
    todo = [n for n in SOURCES if not (out / f"{n}.so").exists()]
    if not todo:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = out / f"{name}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, out / f"{name}.so")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building the kernels if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"{name}.so"))
            lib.fs_error_string.argtypes = [ctypes.c_int]
            lib.fs_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib
