"""Architecture registry of the port: the dense generator configs."""
from .base import ARCH_REGISTRY, ModelConfig, get_arch, register


def _load_all() -> None:
    from . import paper, qwen2_0_5b  # noqa: F401  (registers on import)


__all__ = ["ARCH_REGISTRY", "ModelConfig", "get_arch", "register"]
