from .base import ModelConfig
from .registry import ARCH_NAMES, REGISTRY, get_config
