"""Device, precision and dtype of the port.

- Device: `cuda` unless the caller asks for the CPU (`device="cpu"` in the
  library, `--device cpu` on the command line).  Asking for `cuda` where no
  CUDA device is present raises; nothing falls back to the CPU.
- Precision: TF32 is off for matmuls and cuDNN, so float32 products on the
  card keep full float32 precision.
- Dtype: the linear SNAP path runs at float64 on the card as on the CPU (the
  H100 has native FP64), so there is no counterpart of the TPU path's hi/lo
  float32 pairs.
"""

import torch

DTYPE = torch.float64


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
