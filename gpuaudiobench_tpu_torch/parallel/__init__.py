"""The multi-device layer: a (dp, tp, sp) mesh of ranks over
``torch.distributed`` (``mesh.py``), the collectives of the JAX
package's SPMD programs on it (``collectives.py``), the launcher that
runs one program on every rank (``launch.py``), and the sharded programs
(``multichip.py`` and the ``*_sharded.py`` blocks).

PyTorch counterpart of ``gpuaudiobench_tpu/parallel``. On CUDA devices
the process group is NCCL, rank r on ``cuda:r``; on the CPU it is gloo.
"""
