"""Device placement and the CUDA kernels' build."""
