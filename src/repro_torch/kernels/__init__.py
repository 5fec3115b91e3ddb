"""Hand-written CUDA kernels (csrc/), their launchers, plain versions and wrappers."""
