"""How the port's CUDA kernels are bound and launched.

Each wrapper module registers its kernels' C entry points (`register`:
the library `kernels/build.py` compiles, the ctypes argument types), then
calls `launch` with the tensors' device and the arguments; every entry
point takes the CUDA stream last and returns a CUDA error code.  `on_cpu`
decides between a wrapper's kernel and its plain version, `check` guards
the inputs' dtype, shape and layout before a launch.
"""

import ctypes

import torch

from fitsnap_tpu_torch.kernels.build import load

P = ctypes.c_void_p
I = ctypes.c_int
LL = ctypes.c_longlong
D = ctypes.c_double

SMEM_LIMIT = 232448   # bytes of shared memory one H100 block can use
SMEM_PAIR = 233472 // 2 - 1024   # bytes a block can use, two blocks an SM
AG_STAGE_BYTES = 8 * 128 * 8     # csrc/atom_gemm.cuh's epilogue stage

_ENTRY = {}           # entry point -> (library, argtypes)


def ag_ldl(inner):
    """Row stride (doubles) of an L operand of csrc/atom_gemm.cuh."""
    return -(-inner // 16) * 16 + 4


def row_plan(rows, row_bytes, fixed_bytes, name):
    """(rows per block, blocks) of a per-atom product of
    csrc/atom_gemm.cuh: blocks of 32 rows, else 16 (IW <= 2), whose L rows
    and `fixed_bytes` fit two blocks an SM, else one; the kernels split the
    rows evenly over the blocks, so the rows per block are rounded to 16
    from that share."""
    for limit in (SMEM_PAIR, SMEM_LIMIT):
        for mt in (32, 16):
            if mt * row_bytes + fixed_bytes <= limit:
                tiles = -(-rows // mt)
                per = -(-rows // tiles)
                return -(-per // 16) * 16, tiles
    raise ValueError(f"{name}: 16 rows of {row_bytes} bytes exceed a "
                     f"block's shared memory")


def register(name, library, argtypes):
    """Declare entry point `name` of library `library` (a source of
    `kernels/build.SOURCES`) with its ctypes argument types, the stream's
    last."""
    _ENTRY[name] = (library, list(argtypes))


def _fn(name):
    library, argtypes = _ENTRY[name]
    lib = load(library)
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib, fn


def on_cpu(*tensors):
    """True when the inputs lie on the CPU; raises unless they lie on one
    CUDA device."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"kernel inputs on several devices: {devices}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def check(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def launch(name, device, *args):
    """Call entry point `name` on `device`'s current stream; raises on a
    CUDA error."""
    lib, fn = _fn(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}: "
                           f"{lib.fs_error_string(rc).decode()}")


def ptr(t):
    return t.data_ptr()
