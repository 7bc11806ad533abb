"""PyTorch/CUDA port of the GADGET SVM package ``repro``, for NVIDIA Hopper.

The layout mirrors ``repro`` module for module: ``core`` (objective, gossip
topologies, Push-Sum, the GADGET trainer), ``kernels`` (hand-written CUDA
kernels for sm_90a, each beside its plain PyTorch version), ``data`` (the
synthetic paper datasets) and ``convert`` (weights carried across from the
JAX package as numpy arrays).

The package imports ``torch`` and ``numpy`` only. Entry points run on the
CUDA device unless the caller passes ``device="cpu"``; on CPU tensors every
kernel wrapper uses its plain PyTorch version. The CUDA kernels are compiled
with ``nvcc`` on first use (see ``repro_torch.kernels._build``).
"""
