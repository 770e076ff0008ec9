"""HCK leaf stages: ``leaf_matvec`` (B5), ``leaf_solve`` (B4),
``leaf_factor`` (B3) and ``leaf_project`` (B6) as CUDA kernels and their
plain versions."""
