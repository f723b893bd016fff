"""Cost of one block of the granular gather (``gpuab::rndmem_gather_launch``):
a copy of ``gpuaudiobench_tpu_torch/models/rndmem.py:rndmem_cost``. Every
output sample read once from the pool and written once, and the int32
playheads read; no arithmetic.
"""

NAMES = ("rndmem_gather_kernel",)


def cost(conf) -> dict:
    n = conf["tracks"] * conf["buffer_size"]
    return {"flops": 0, "bytes": 2 * n * 4 + 4 * conf["tracks"]}
