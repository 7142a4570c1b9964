"""Architecture configs (the port's own copies of ``repro.configs``).

``get_config(name)`` resolves ``--arch`` ids to config objects;
``smoke_variant`` gives the reduced CPU-test config of the same family.
"""
from repro_torch.configs.base import (ModelConfig, get_config, list_archs,
                                      register, smoke_variant)
from repro_torch.configs import zoo  # noqa: F401  (registers everything)

__all__ = ["ModelConfig", "get_config", "list_archs", "register",
           "smoke_variant"]
