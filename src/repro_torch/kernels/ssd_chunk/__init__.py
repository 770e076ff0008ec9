"""SSD intra-chunk stage ``ssd_intra_chunk`` (B15): the Mamba2 chunk's
causal decay-masked quadratic form, as a CUDA kernel and its plain
version."""
from repro_torch.kernels.ssd_chunk.ops import ssd_intra_chunk
from repro_torch.kernels.ssd_chunk.ref import ssd_intra_chunk_ref

__all__ = ["ssd_intra_chunk", "ssd_intra_chunk_ref"]
