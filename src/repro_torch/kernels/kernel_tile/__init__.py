"""Pairwise base-kernel stage ``pairwise_kernel`` (B11): K(X, Y) in
float32, as a CUDA kernel and its plain version."""
