"""Model configurations: ``ModelConfig`` for the ten assigned
architectures (a copy of ``repro/configs``, data only)."""
from .base import SHAPES, ModelConfig, ShapeConfig, supports_shape
from .registry import ARCH_IDS, get_config, smoke_config

__all__ = ["ARCH_IDS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "smoke_config", "supports_shape"]
