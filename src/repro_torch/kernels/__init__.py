"""Hand-written CUDA kernels for Hopper, their plain PyTorch versions and wrappers."""
