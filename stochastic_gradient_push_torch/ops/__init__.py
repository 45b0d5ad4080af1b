"""Hand-written CUDA kernels (built from ``csrc/``) and their plain twins."""
