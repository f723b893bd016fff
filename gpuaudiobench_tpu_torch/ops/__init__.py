"""Device compute ops: hand-written CUDA kernels beside plain PyTorch twins."""
