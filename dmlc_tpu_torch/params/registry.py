"""Global factory registries (``dmlc::Registry``, include/dmlc/registry.h),
copied from ``dmlc_tpu/params/registry.py``: named singleton registries of
factory entries with find/lookup/list and aliases. Duplicate names and
unknown lookups raise this package's ``ParamError``.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

from dmlc_tpu_torch.params.parameter import ParamError

T = TypeVar("T")


class RegistryEntry(Generic[T]):
    """One registered factory (reference FunctionRegEntryBase)."""

    def __init__(self, name: str, body: Callable[..., T]):
        self.name = name
        self.body = body
        self.description = ""
        self.arguments: List[Dict[str, str]] = []
        self.return_type = ""

    def describe(self, description: str) -> "RegistryEntry[T]":
        self.description = description
        return self

    def add_argument(
        self, name: str, type_str: str, description: str = ""
    ) -> "RegistryEntry[T]":
        self.arguments.append(
            {"name": name, "type": type_str, "description": description}
        )
        return self

    def set_return_type(self, rtype: str) -> "RegistryEntry[T]":
        self.return_type = rtype
        return self

    def __call__(self, *args: Any, **kwargs: Any) -> T:
        return self.body(*args, **kwargs)


class Registry(Generic[T]):
    """A named registry of factory entries; ``Registry.get(name)`` returns
    the process-wide registry of that name (``Registry<EntryType>::Get()``).
    """

    _registries: Dict[str, "Registry[Any]"] = {}
    _lock = threading.Lock()

    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, RegistryEntry[T]] = {}
        self._entry_list: List[RegistryEntry[T]] = []

    @classmethod
    def get(cls, name: str) -> "Registry[Any]":
        with cls._lock:
            reg = cls._registries.get(name)
            if reg is None:
                reg = Registry(name)
                cls._registries[name] = reg
            return reg

    # ---- registration --------------------------------------------------
    def register(
        self, name: str, body: Optional[Callable[..., T]] = None
    ) -> Any:
        """Register a factory; usable directly or as a decorator.
        Duplicate names raise (registry.h:88-105)."""

        def do_register(fn: Callable[..., T]) -> RegistryEntry[T]:
            with self._lock:
                if name in self._entries:
                    raise ParamError(
                        f"{name!r} already registered in registry "
                        f"{self.name!r}")
                entry: RegistryEntry[T] = RegistryEntry(name, fn)
                self._entries[name] = entry
                self._entry_list.append(entry)
                return entry

        if body is not None:
            return do_register(body)
        return do_register

    def add_alias(self, key_name: str, alias: str) -> None:
        """Register ``alias`` pointing at ``key_name``'s entry
        (registry.h:108-122)."""
        with self._lock:
            entry = self._entries.get(key_name)
            if entry is None:
                raise ParamError(
                    f"Cannot alias {key_name!r}: not found in {self.name!r}")
            if alias in self._entries and self._entries[alias] is not entry:
                raise ParamError(
                    f"Alias {alias!r} already taken in {self.name!r}")
            self._entries[alias] = entry

    # ---- lookup --------------------------------------------------------
    def find(self, name: str) -> Optional[RegistryEntry[T]]:
        return self._entries.get(name)

    def lookup(self, name: str) -> RegistryEntry[T]:
        entry = self.find(name)
        if entry is None:
            known = ", ".join(sorted(self._entries))
            raise ParamError(
                f"Unknown entry {name!r} in registry {self.name!r}; "
                f"known entries: [{known}]")
        return entry

    def list_entries(self) -> List[RegistryEntry[T]]:
        return list(self._entry_list)

    def list_all_names(self) -> List[str]:
        return list(self._entries.keys())
