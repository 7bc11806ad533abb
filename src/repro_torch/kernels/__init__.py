"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. ``_build`` compiles the ``csrc/*.cu`` sources with nvcc."""
