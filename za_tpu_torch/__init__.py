"""za_tpu_torch: the Groth16 prover's device engine on PyTorch and CUDA.

A port of ``za_tpu`` (JAX/Pallas on a TPU) to one NVIDIA H100: the host
Groth16 code (``curve``, ``groth16``) is the package's own copy, and the
device engine (``engine``) runs PyTorch tensor code plus hand-written
CUDA kernels (``csrc``) built with nvcc at first use.
"""

__version__ = "0.1.0"
