"""PyTorch / CUDA port of the benchmark suite, for NVIDIA Hopper (H100).

A second package beside ``gpuaudiobench_tpu`` (the JAX reference, which
it is tested against). Module names mirror the reference's. Plain
tensor code is PyTorch; each Pallas kernel of the reference becomes a
hand-written CUDA C++ kernel under ``csrc/``, built with nvcc at first
use (``utils/build.py``) and wrapped beside a plain PyTorch twin of the
same contract. The package never imports jax.

Ported so far: the ModalFilterBank main path (``python -m
gpuaudiobench_tpu_torch.bench``).
"""

__version__ = "0.1.0"
