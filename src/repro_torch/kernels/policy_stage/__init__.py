"""Landmark-policy distance stage ``policy_dist`` (B12): batched squared-L2
or L1 distances between node blocks and per-node centers, as a CUDA kernel
and its plain version."""
from repro_torch.kernels.policy_stage.ops import policy_dist
from repro_torch.kernels.policy_stage.ref import policy_dist_ref

__all__ = ["policy_dist", "policy_dist_ref"]
