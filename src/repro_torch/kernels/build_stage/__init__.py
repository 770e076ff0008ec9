"""HCK build stages: ``build_gram`` (B1) and ``build_cross`` (B2) and
their grouped forms over every tree level, and the sweep engine's
``build_gram_dist`` (B8) and ``build_cross_dist`` (B9) and theirs, as CUDA
kernels and their plain versions."""
