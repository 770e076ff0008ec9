"""Algorithm-3 contraction ``oos_contract`` (B7) as a CUDA kernel and its plain version."""
