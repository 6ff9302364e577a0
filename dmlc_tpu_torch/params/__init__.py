"""Parameter structs (typed fields with bounds, enums, aliases and
optional values; JSON save and load), ``Config`` files, the factory
Registry and typed environment reads."""

from dmlc_tpu_torch.params.config import Config
from dmlc_tpu_torch.params.parameter import (
    UNSET,
    FieldInfo,
    Parameter,
    ParamError,
    field,
)
from dmlc_tpu_torch.params.env import get_env, set_env
from dmlc_tpu_torch.params.registry import Registry, RegistryEntry

__all__ = ["Config", "FieldInfo", "Parameter", "ParamError", "UNSET",
           "field", "Registry", "RegistryEntry", "get_env", "set_env"]
