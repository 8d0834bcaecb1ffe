from .default import get_config
from .tree import Config, ConfigTree

__all__ = ["Config", "ConfigTree", "get_config"]
