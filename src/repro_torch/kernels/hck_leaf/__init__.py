"""HCK leaf stages: ``leaf_project`` (B6) as a CUDA kernel and its plain version."""
