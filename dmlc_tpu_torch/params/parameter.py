"""Declarative typed parameter structs (the port of
``dmlc_tpu/params/parameter.py``).

Capability parity with ``dmlc::Parameter`` (reference include/dmlc/parameter.h):

- declare fields with type, default, range/enum constraints, aliases, docs
  (``DMLC_DECLARE_FIELD`` + ``FieldEntry`` specializations, parameter.h:260-292,
  653-1029)
- ``init(kwargs)`` with unknown-key policies kAllowUnknown / kAllMatch /
  kAllowHidden (parameter.h:87-101, 135-160)
- required fields without defaults raise "Required parameter ... not presented"
  (parameter.h:424-429, 595-600)
- string→typed parsing: bool accepts true/false/1/0 (parameter.h:944-977);
  int enums via add_enum (parameter.h:713-925); floats reject INF/NAN-producing
  and subnormal inputs (parameter.h:982-1029 — the reference's stof throws
  out_of_range for subnormals, covered by unittest_param.cc:13-21)
- ``__DICT__``/``update_dict`` (parameter.h:168-180), JSON ``save``/``load``
  (parameter.h:185-197), ``__DOC__`` docgen (parameter.h:202-213)
- rich ``ParamError`` messages embedding the full generated docstring
  (parameter.h:403-421)

Idiomatic-Python shape: fields are class attributes built by ``field(...)``
(a descriptor-light dataclass pattern) instead of CRTP + offset-of; validation
runs on ``init`` and on attribute assignment of parsed values.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Sequence

from dmlc_tpu_torch.utils.logging import DMLCError

# Smallest positive normal float32/float64; the reference parses float fields
# with std::stof which raises out_of_range on subnormal literals
# (unittest_param.cc:13-21 pins this behavior).
_FLT_MIN = 1.17549435e-38
_DBL_MIN = 2.2250738585072014e-308


def _dmlc_json():
    """The io/json.py streaming layer, imported lazily: params is a base
    layer and must not pull the whole io package at import time."""
    from dmlc_tpu_torch.io import json as dmlc_json

    return dmlc_json


class ParamError(DMLCError):
    """Raised on unknown keys, parse failures, constraint violations, or
    missing required fields (reference dmlc::ParamError, parameter.h:62)."""


class _Unset:
    def __repr__(self) -> str:  # pragma: no cover
        return "<unset>"


UNSET = _Unset()


class FieldInfo:
    """Metadata for one declared field (reference FieldEntry hierarchy)."""

    def __init__(
        self,
        ftype: type,
        default: Any = UNSET,
        *,
        description: str = "",
        lower_bound: Any = None,
        upper_bound: Any = None,
        enum: Optional[Mapping[str, Any]] = None,
        aliases: Sequence[str] = (),
        optional_none: bool = False,
    ):
        self.ftype = ftype
        self.default = default
        self.description = description
        self.lower_bound = lower_bound
        self.upper_bound = upper_bound
        self.enum = dict(enum) if enum else None
        self.aliases = tuple(aliases)
        # optional_none: dmlc::optional<T> semantics — the string "None" parses
        # to None (parameter.h:819-925).
        self.optional_none = optional_none
        self.name = "?"  # filled by the metaclass

    # ---- parsing -------------------------------------------------------
    def parse(self, value: Any) -> Any:
        if self.optional_none and (
            value is None or (isinstance(value, str) and value == "None")
        ):
            return None
        if self.enum is not None:
            return self._parse_enum(value)
        if self.ftype is bool:
            return self._parse_bool(value)
        if self.ftype is int:
            return self._parse_int(value)
        if self.ftype is float:
            return self._parse_float(value)
        if self.ftype is str:
            return str(value)
        # Fallback: try the constructor directly.
        try:
            return self.ftype(value)
        except Exception as err:  # noqa: BLE001
            raise ParamError(
                f"Invalid value {value!r} for parameter {self.name}: {err}"
            ) from err

    def _parse_enum(self, value: Any) -> Any:
        assert self.enum is not None
        if isinstance(value, str) and value in self.enum:
            return self.enum[value]
        if value in self.enum.values():
            return value
        expected = ", ".join(f"{k!r}" for k in self.enum)
        raise ParamError(
            f"Invalid value {value!r} for parameter {self.name}; "
            f"expected one of {{{expected}}}"
        )

    def _parse_bool(self, value: Any) -> bool:
        if isinstance(value, bool):
            return value
        s = str(value).strip().lower()
        if s in ("true", "1"):
            return True
        if s in ("false", "0"):
            return False
        raise ParamError(
            f"Invalid value {value!r} for boolean parameter {self.name}; "
            f"expected true/false/1/0"
        )

    def _parse_int(self, value: Any) -> int:
        if isinstance(value, bool):
            raise ParamError(f"Invalid bool for int parameter {self.name}")
        if isinstance(value, int):
            return value
        try:
            return int(str(value).strip(), 0)
        except ValueError as err:
            raise ParamError(
                f"Invalid value {value!r} for int parameter {self.name}"
            ) from err

    def _parse_float(self, value: Any) -> float:
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            out = float(value)
        else:
            s = str(value).strip()
            try:
                out = float(s)
            except ValueError as err:
                raise ParamError(
                    f"Invalid value {value!r} for float parameter {self.name}"
                ) from err
            low = s.lower()
            if "inf" in low or "nan" in low or "x" in low:
                # reference strtonum/stof path rejects INF/NAN/hex literals
                raise ParamError(
                    f"Invalid value {value!r} for float parameter {self.name}"
                )
        if math.isinf(out) or math.isnan(out):
            raise ParamError(
                f"Value {value!r} out of range for float parameter {self.name}"
            )
        if out != 0.0 and abs(out) < _FLT_MIN:
            # std::stof out_of_range on subnormals (unittest_param.cc:13-21)
            raise ParamError(
                f"Value {value!r} is subnormal for float parameter {self.name}"
            )
        return out

    # ---- validation ----------------------------------------------------
    def check(self, value: Any) -> None:
        if value is None and self.optional_none:
            return
        if self.lower_bound is not None and value < self.lower_bound:
            raise ParamError(
                f"Value {value!r} for parameter {self.name} should be "
                f">= {self.lower_bound}"
            )
        if self.upper_bound is not None and value > self.upper_bound:
            raise ParamError(
                f"Value {value!r} for parameter {self.name} should be "
                f"<= {self.upper_bound}"
            )

    # ---- docs / stringification ---------------------------------------
    def type_string(self) -> str:
        base = {int: "int", float: "float", bool: "boolean", str: "string"}.get(
            self.ftype, self.ftype.__name__
        )
        if self.enum is not None:
            base = "{" + ", ".join(repr(k) for k in self.enum) + "}"
        if self.optional_none:
            base = f"optional[{base}]"
        rng = []
        if self.lower_bound is not None:
            rng.append(f">= {self.lower_bound}")
        if self.upper_bound is not None:
            rng.append(f"<= {self.upper_bound}")
        if rng:
            base += ", " + " and ".join(rng)
        if self.default is UNSET:
            base += ", required"
        else:
            base += f", default={self.to_string(self.default)}"
        return base

    def to_string(self, value: Any) -> str:
        if value is None:
            return "None"
        if self.enum is not None:
            for key, val in self.enum.items():
                if val == value:
                    return key
        if isinstance(value, bool):
            return "true" if value else "false"
        return str(value)


def field(
    ftype: type,
    default: Any = UNSET,
    *,
    description: str = "",
    lower_bound: Any = None,
    upper_bound: Any = None,
    enum: Optional[Mapping[str, Any]] = None,
    aliases: Sequence[str] = (),
    optional_none: bool = False,
) -> FieldInfo:
    """Declare a parameter field (reference DMLC_DECLARE_FIELD + modifiers
    set_range/set_lower_bound/add_enum/set_default/describe/DMLC_DECLARE_ALIAS,
    parameter.h:260-292)."""
    return FieldInfo(
        ftype,
        default,
        description=description,
        lower_bound=lower_bound,
        upper_bound=upper_bound,
        enum=enum,
        aliases=aliases,
        optional_none=optional_none,
    )


class _ParameterMeta(type):
    def __new__(mcls, name, bases, ns):
        fields: Dict[str, FieldInfo] = {}
        for base in bases:
            fields.update(getattr(base, "__param_fields__", {}))
        for key, val in list(ns.items()):
            if isinstance(val, FieldInfo):
                val.name = key
                fields[key] = val
                del ns[key]
        ns["__param_fields__"] = fields
        alias_map: Dict[str, str] = {}
        for key, info in fields.items():
            for alias in info.aliases:
                alias_map[alias] = key
        ns["__param_aliases__"] = alias_map
        return super().__new__(mcls, name, bases, ns)


class Parameter(metaclass=_ParameterMeta):
    """Base class for declarative parameter structs.

    Usage::

        class MyParam(Parameter):
            num_hidden = field(int, 64, lower_bound=1, description="...")
            act = field(str, "relu", enum={"relu": "relu", "tanh": "tanh"})

        p = MyParam(num_hidden=128)         # or MyParam().init(kwargs)
    """

    __param_fields__: Dict[str, FieldInfo] = {}
    __param_aliases__: Dict[str, str] = {}

    def __init__(self, **kwargs: Any):
        for key, info in self.__param_fields__.items():
            object.__setattr__(
                self, key, info.default if info.default is not UNSET else UNSET
            )
        if kwargs:
            self.init(kwargs)

    # ---- core init -----------------------------------------------------
    def init(
        self,
        kwargs: Mapping[str, Any],
        *,
        allow_unknown: bool = False,
        allow_hidden: bool = False,
    ) -> Dict[str, Any]:
        """Initialize from string (or typed) kwargs.

        Returns the dict of unknown kwargs when ``allow_unknown`` (reference
        kAllowUnknown, InitAllowUnknown parameter.h:144-152); otherwise raises
        ``ParamError`` listing candidates (parameter.h:403-421). Keys starting
        with ``__`` and ending ``__`` are skipped when ``allow_hidden``
        (kAllowHidden, parameter.h:97-101).
        """
        unknown: Dict[str, Any] = {}
        fields = self.__param_fields__
        aliases = self.__param_aliases__
        for key, value in kwargs.items():
            target = aliases.get(key, key)
            if target in fields:
                info = fields[target]
                parsed = info.parse(value)
                info.check(parsed)
                object.__setattr__(self, target, parsed)
            elif allow_hidden and key.startswith("__") and key.endswith("__"):
                continue
            elif allow_unknown:
                unknown[key] = value
            else:
                raise ParamError(
                    f"Cannot find parameter {key!r} in {type(self).__name__}.\n"
                    f"{self.__doc_string__()}"
                )
        missing = [
            name
            for name, info in fields.items()
            if getattr(self, name) is UNSET and info.default is UNSET
        ]
        if missing:
            raise ParamError(
                f"Required parameter(s) {', '.join(missing)} of "
                f"{type(self).__name__} not presented.\n{self.__doc_string__()}"
            )
        return unknown

    def __setattr__(self, key: str, value: Any) -> None:
        info = self.__param_fields__.get(key)
        if info is not None:
            value = info.parse(value)
            info.check(value)
        object.__setattr__(self, key, value)

    # ---- dict / json / doc surface ------------------------------------
    def to_dict(self) -> Dict[str, str]:
        """All fields as strings (reference __DICT__, parameter.h:168-173)."""
        return {
            name: info.to_string(getattr(self, name))
            for name, info in self.__param_fields__.items()
        }

    def update_dict(self, target: Dict[str, str]) -> None:
        """Merge this parameter's fields into ``target`` (UpdateDict,
        parameter.h:176-180)."""
        target.update(self.to_dict())

    def save(self, fp) -> None:
        """Save as a JSON object of string values (parameter.h:185-190),
        through the in-repo streaming writer (io/json.py — json.h:188)."""
        _dmlc_json().dump(self.to_dict(), fp)

    def load(self, fp) -> None:
        """Load from JSON written by ``save`` (parameter.h:193-197),
        through the in-repo streaming reader (io/json.py — json.h:43)."""
        self.init(_dmlc_json().load(fp))

    def saves(self) -> str:
        return _dmlc_json().dumps(self.to_dict())

    def loads(self, text: str) -> None:
        self.init(_dmlc_json().loads(text))

    @classmethod
    def fields(cls) -> Dict[str, FieldInfo]:
        """Field metadata (reference __FIELDS__, parameter.h:202-205)."""
        return dict(cls.__param_fields__)

    @classmethod
    def __doc_string__(cls) -> str:
        """Generated docstring (reference __DOC__, parameter.h:208-213)."""
        lines = [f"Parameters of {cls.__name__}:"]
        for name, info in cls.__param_fields__.items():
            lines.append(f"  {name} : {info.type_string()}")
            if info.description:
                lines.append(f"      {info.description}")
        return "\n".join(lines)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v}" for k, v in self.to_dict().items())
        return f"{type(self).__name__}({inner})"

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, Parameter):
            return NotImplemented
        return type(self) is type(other) and self.to_dict() == other.to_dict()
