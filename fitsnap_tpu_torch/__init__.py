"""fitsnap_tpu_torch: the PyTorch/CUDA port of fitsnap_tpu.

The same FitSNAP inputs and outputs as `fitsnap_tpu`, computed with PyTorch
on an NVIDIA H100 (CUDA C++ kernels written for Hopper on the hot path) or,
when asked for, on the CPU.  It imports neither JAX nor `fitsnap_tpu`.
"""

__version__ = "0.1.0"
__all__ = ["FitSnap"]


def __getattr__(name):
    # lazy, so `fitsnap_tpu_torch.ops.*` imports without the pipeline
    if name == "FitSnap":
        from fitsnap_tpu_torch.fitsnap import FitSnap
        return FitSnap
    raise AttributeError(name)
