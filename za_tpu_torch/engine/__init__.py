"""Device engine: BN254 field and curve arithmetic on torch tensors,
the batch-affine tree MSM with its CUDA kernels, the NTT and the R1CS
matvec, behind ``GpuEngine``."""

from .engine import GpuEngine

__all__ = ["GpuEngine"]
