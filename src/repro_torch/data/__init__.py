"""Chunked host-resident ingestion for the HCK build engine and the
synthetic Table-1 data (counterpart of ``repro.data``)."""
from repro_torch.data.pipeline import (ArraySource, ChunkSource, PaddedSource,
                                       pad_source, regression_dataset,
                                       stream_partition)

__all__ = ["ArraySource", "ChunkSource", "PaddedSource", "pad_source",
           "regression_dataset", "stream_partition"]
