"""Device, precision, dtype and process group of the port.

- Device: `cuda` unless the caller asks for the CPU (`device="cpu"` in the
  library, `--device cpu` on the command line).  Asking for `cuda` where no
  CUDA device is present raises; nothing falls back to the CPU.
- Precision: TF32 is off for matmuls and cuDNN, so float32 products on the
  card keep full float32 precision.
- Dtype: every path runs at float64 by default, on the card as on the CPU
  (the H100 has native FP64).  `--dtype float32` (`working_type`) trains
  the NN solver's cached and OTF modes of linear SNAP networks at float32,
  the JAX package's type on its accelerator; the streamed fit takes float32
  through its packers (`pack_batch_pos(..., np.float32)`).
- Process group: one process per card, as `torchrun --nproc_per_node N -m
  fitsnap_tpu_torch in.in` starts them, or the caller's own
  `torch.distributed.init_process_group` in library mode.  Whenever the
  default group is initialized, whatever its backend, the streamed fit,
  the spatial rows, `TpuSVD` and the NN solver split their device work
  over it (each rank its contiguous `share`) and sum with `all_sum`, a
  no-op without a group.  `make_group` is the counterpart of the JAX
  package's `make_mesh`.  Rank 0 alone writes: every file a fit writes is
  opened through `open_output` or `save` here, the screen and log text of
  `io/screen.py` are quiet on the other ranks, and FitSnap skips its
  output stage there.  Scraping runs on rank 0 first (`rank_zero_first`),
  so the other ranks read the caches it wrote whole.
"""

import contextlib
import os
from typing import NamedTuple

import numpy as np

import torch
import torch.distributed as dist

DTYPE = torch.float64
WORKING_TYPES = {None: torch.float64, "float64": torch.float64,
                 "float32": torch.float32}


def working_type(args):
    """The torch type of the command line's `--dtype`: float64 without the
    flag or with `float64`, float32 with `float32`; raises on any other."""
    if args.dtype not in WORKING_TYPES:
        raise ValueError(f"--dtype {args.dtype}: takes float32 or float64")
    return WORKING_TYPES[args.dtype]


def resolve_device(device=None) -> torch.device:
    """The torch device to compute on: `cuda` by default, never a fallback."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (library) or "
            "--device cpu (command line) to run on the CPU")
    return dev


def setup_precision():
    """Turn TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Group(NamedTuple):
    """This process's place in the default process group."""
    rank: int
    size: int
    device: torch.device


def distributed() -> bool:
    """Whether the default process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def world():
    """(rank, size) of the default process group; (0, 1) without one."""
    if distributed():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def writer() -> bool:
    """Whether this process writes files and screen text: rank 0 of the
    process group, or the one process without one."""
    return world()[0] == 0


def open_output(path, mode="w"):
    """`open(path, mode)` on the writer; on the other ranks the null
    device, so that they run the same code and write nothing."""
    return open(path if writer() else os.devnull, mode)


def save(path, array):
    """`np.save(path, array)` on the writer only."""
    if writer():
        np.save(path, array)


@contextlib.contextmanager
def rank_zero_first():
    """The body runs on rank 0, then, after a barrier, on the other ranks:
    what rank 0 writes there (a scraper's cache) is whole before they look
    for it."""
    rank, size = world()
    if size > 1 and rank > 0:
        dist.barrier()
    try:
        yield
    finally:
        if size > 1 and rank == 0:
            dist.barrier()


def share(n, what="items"):
    """This rank's contiguous share, a slice of the W-th part of n items at
    rank r, as the JAX package's sharding of an axis over its mesh; raises
    unless the group's W processes split n evenly."""
    rank, size = world()
    if n % size:
        raise ValueError(f"{n} {what} do not split over {size} processes: "
                         f"make them a multiple of {size}")
    k = n // size
    return slice(rank * k, (rank + 1) * k)


def from_rank_zero(value, device):
    """Rank 0's float `value` on every rank (a seed drawn once)."""
    rank, _ = world()
    out, = all_sum(torch.tensor(float(value) if rank == 0 else 0.0,
                                dtype=torch.float64, device=device))
    return float(out)


def make_group(device=None, init=False) -> Group:
    """(rank, size, device) of this process.

    `device` as `resolve_device`; under a group of more than one process,
    `cuda` without an index means `cuda:LOCAL_RANK`.  Nothing is
    initialized unless `init` is set and torchrun's environment asks for
    more than one process (WORLD_SIZE > 1) while no group exists: the
    default group is then initialized from that environment, NCCL on the
    card (whose device becomes the current one) and gloo on the CPU.
    """
    dev = resolve_device(device)
    many = int(os.environ.get("WORLD_SIZE", "1")) > 1
    if dev.type == "cuda" and dev.index is None and (many or distributed()):
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if init and many and not distributed():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    rank, size = world()
    return Group(rank, size, dev)


def all_sum(*tensors):
    """The tensors summed over the default group (new tensors, one
    all_reduce of their float64 concatenation, integer counts exact below
    2^53); without a group, the tensors themselves."""
    if not distributed():
        return tensors
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    dist.all_reduce(flat)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape).to(t.dtype))
        at += t.numel()
    return tuple(out)

