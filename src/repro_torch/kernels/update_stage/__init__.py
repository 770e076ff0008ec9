"""Bordered leaf-update stage ``leaf_update`` (B13): the leaf Schur
Cholesky pair extended by appended rows, as a CUDA kernel and its plain
version."""
from repro_torch.kernels.update_stage.ops import leaf_update
from repro_torch.kernels.update_stage.ref import leaf_update_ref

__all__ = ["leaf_update", "leaf_update_ref"]
