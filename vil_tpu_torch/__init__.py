"""vil_tpu_torch — the PyTorch/CUDA port of ``vil_tpu`` for NVIDIA Hopper.

A second package beside the JAX reference. Plain tensor code is PyTorch; each
Pallas TPU kernel on the ported path is a CUDA C++ kernel written for
``sm_90a`` (``csrc/``), built with nvcc at first use and bound with ctypes
(``ops/kernels/build.py``). Every kernel has a plain PyTorch version beside
it, which is what runs on the CPU. This package never imports JAX.
"""

__version__ = "0.1.0"
