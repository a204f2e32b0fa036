"""arcnerf_torch: the PyTorch + CUDA port of arcnerf_tpu for NVIDIA Hopper.

It mirrors ``arcnerf_tpu``'s layout and names. Plain tensor code is
PyTorch; the kernels are CUDA C++ under ``csrc/``, built at first use into
``csrc/build/`` and bound with ctypes (``ops/cuda_lib.py``). Each kernel's
wrapper takes its plain PyTorch version for a CPU tensor and launches the
kernel for a CUDA tensor.
"""

__version__ = "0.1.0"
