"""Hand-written CUDA kernels for Hopper, each beside its plain torch twin."""
