"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version."""
