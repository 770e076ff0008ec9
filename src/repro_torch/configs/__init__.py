"""Config registry of the port: importing this package registers the
architectures of its ported LM paths (zamba2-7b)."""
from repro_torch.configs import zamba2_7b  # noqa: F401
from repro_torch.configs.base import (SHAPES, ArchConfig, ShapeConfig,
                                      get_arch, get_shape)

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "get_arch", "get_shape"]
