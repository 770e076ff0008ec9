"""Algorithm-3 contraction ``oos_contract`` (B7) as a CUDA kernel, one
stage or both terms in one launch, and its plain versions."""
