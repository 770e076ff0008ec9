"""HCK build stages: ``build_gram`` (B1) and ``build_cross`` (B2) as CUDA
kernels and their plain versions."""
