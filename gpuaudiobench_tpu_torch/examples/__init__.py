"""The audio examples of the port: each engine's per-block step making
sound, with its own proof. Each runs as ``python -m
gpuaudiobench_tpu_torch.examples.<name>``, on the card unless it is
given ``--device cpu``."""
