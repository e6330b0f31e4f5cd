"""remora_tpu_torch: the remora_tpu modified-base caller in PyTorch and CUDA.

A port of the JAX package ``remora_tpu`` to PyTorch on NVIDIA Hopper
GPUs. The JAX package is the reference this package is tested against;
this package imports none of it (and no JAX): it keeps its own copies of
the host modules it needs. Every Pallas kernel of a ported path is a
hand-written CUDA kernel here, under ``csrc/``, built with ``nvcc`` at
first use (``kernels/_build.py``).

Entry points run on the GPU unless the caller names ``device="cpu"``.
"""

__version__ = "0.1.0"


class RemoraError(Exception):
    """Custom error for remora_tpu_torch (mirrors remora_tpu.RemoraError)."""
