"""Architecture configs of the LM zoo (the port's own registry)."""
from .base import ArchConfig, get_config, list_archs, register

__all__ = ["ArchConfig", "get_config", "list_archs", "register"]
