"""How the port's CUDA kernels are bound and launched.

Each wrapper module registers its kernels' C entry points (`register`:
the library `kernels/build.py` compiles, the ctypes argument types), then
calls `launch` with the tensors' device and the arguments; every entry
point takes the CUDA stream last and returns a CUDA error code.  `on_cpu`
decides between a wrapper's kernel and its plain version, `check` guards
the inputs' dtype, shape and layout before a launch.

Working types: every kernel runs at float64.  The kernels of the streamed
linear SNAP fit (K1 in its window shape, K2, K3 in whole rows, K4, K5's
`zbl_eav`, K7, K8) and those of the NN solver's cached and OTF modes of
linear SNAP networks (K9, K10, K10T, K11, K11T and the force gather, up
to twojmax 12) also have a float32 instantiation, an entry point named
with `_f32`; their wrappers take the inputs' one float type
(`float_type`).  Every other mode refuses float32 with the `ROADMAP.md`
queue item that ports it (`check`'s `queue`, the `QUEUE_*` titles; the NN
solver's precompute, pairwise and PAS modes, K12, K12T and K15-K15T:
`QUEUE_NN`), and none of them falls back to float64 or to its plain
version.
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

FLOAT_TYPES = (torch.float64, torch.float32)
# the ROADMAP.md section 1 queue items that port float32 to the modes past
# the streamed linear SNAP fit
QUEUE_NN = "The NN solver at float32"
QUEUE_ACE = "ACE at float32"
QUEUE_CHEM = ("Chemflag, quadraticflag and the coul/cut and spin references "
              "at float32")
QUEUE_LARGE = "Twojmax 13-16 at float32"
QUEUE_SPATIAL = "build_spatial_rows_fn at float32"


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


def f32_refusal(name, queue):
    """The TypeError of a float32 input to a mode without a float32
    kernel: it names the ROADMAP.md queue item `queue` that ports it."""
    return TypeError(f"{name}: float32 is not ported for this mode yet "
                     f"(ROADMAP.md section 1, queue item \"{queue}\"); "
                     f"pass float64")


def float_type(name, *tensors):
    """The one float type of a wrapper's float inputs: float64, or float32
    for the kernels with a float32 instantiation; raises TypeError on any
    other type and on a mix."""
    types = {t.dtype for t in tensors}
    if len(types) != 1 or next(iter(types)) not in FLOAT_TYPES:
        raise TypeError(f"{name}: the float inputs must be all float64 or "
                        f"all float32, got {sorted(map(str, types))}")
    return types.pop()


def entry(name, dtype):
    """The entry point of `name`'s instantiation at `dtype`."""
    return name + "_f32" if dtype == torch.float32 else name


def count(wrapper, dtype):
    """Add one launch at `dtype` to `wrapper`'s counts (`launches`, and
    `launches_f32` for a float32 launch)."""
    wrapper.launches += 1
    if dtype == torch.float32:
        wrapper.launches_f32 += 1


def check(t, name, dtype, shape, queue=None):
    """Refuse a tensor that is not of `dtype` and `shape` or not
    contiguous; a float32 tensor where float64 is expected names the queue
    item `queue` that ports it, where given."""
    if t.dtype != dtype:
        if queue is not None and t.dtype == torch.float32 \
                and dtype == torch.float64:
            raise f32_refusal(name, queue)
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
