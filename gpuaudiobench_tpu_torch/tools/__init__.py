"""Tools of the port: the soak, the capacity search and its ledger, and
the buffer-64 attribution. Each runs as ``python -m
gpuaudiobench_tpu_torch.tools.<name>``, on the card unless it is given
``--device cpu``."""
