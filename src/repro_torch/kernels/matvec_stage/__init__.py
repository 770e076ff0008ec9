"""Fused exact-kernel matvec stage ``kernel_matvec`` (B10): z = K(Xc, Y) V
without storing K, as a CUDA kernel and its plain version."""
from repro_torch.kernels.matvec_stage.ops import kernel_matvec
from repro_torch.kernels.matvec_stage.ref import kernel_matvec_ref

__all__ = ["kernel_matvec", "kernel_matvec_ref"]
