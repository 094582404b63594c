"""The LM zoo's architectures (counterpart of `repro/configs`)."""
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import ARCHS, get_arch, list_archs

__all__ = ["ArchConfig", "ARCHS", "get_arch", "list_archs"]
