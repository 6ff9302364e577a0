"""Parameter structs (the subset the learners and parsers use) and the
factory Registry."""

from dmlc_tpu_torch.params.parameter import (
    FieldInfo,
    Parameter,
    ParamError,
    field,
)
from dmlc_tpu_torch.params.registry import Registry, RegistryEntry

__all__ = ["FieldInfo", "Parameter", "ParamError", "field", "Registry",
           "RegistryEntry"]
