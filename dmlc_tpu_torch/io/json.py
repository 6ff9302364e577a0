"""Streaming JSON reader/writer + declare-fields helper (json.h parity;
the port of ``dmlc_tpu/io/json.py``).

The reference ships its own JSON layer (include/dmlc/json.h): a pull
tokenizer (``JSONReader``, json.h:43 — BeginObject/NextObjectItem,
BeginArray/NextArrayItem, ReadString/ReadNumber with line-tracked errors),
a structured writer (``JSONWriter``, json.h:188 — multi-line objects,
inline arrays, WriteObjectKeyValue), and a typed declare-fields helper
(``JSONObjectReadHelper``, json.h:310 — DeclareField/DeclareOptionalField
+ ReadAllFields with unknown-key and missing-required errors).

This is the Python rebuild of that surface: the same pull-parser shape
(no DOM required — values are read as they are pulled, so a huge nested
document streams), plus ``read_value``/``write_value`` conveniences for
plain Python trees. Parameter.save/load rides it (params/parameter.py),
giving the helper its real call site.
"""

from __future__ import annotations

import codecs
import io as _io
import math
from typing import Any, Dict, Optional, Union

from dmlc_tpu_torch.utils.logging import DMLCError

_WS = " \t\r\n"
_ESCAPES = {
    '"': '"', "\\": "\\", "/": "/", "b": "\b", "f": "\f",
    "n": "\n", "r": "\r", "t": "\t",
}
_ESCAPES_OUT = {v: "\\" + k for k, v in _ESCAPES.items() if k != "/"}


class JSONReader:
    """Pull tokenizer over a str, bytes, or readable stream (json.h:43).

    Usage mirrors the reference::

        reader.begin_object()
        while (key := reader.next_object_item()) is not None:
            value = reader.read_value()

        reader.begin_array()
        while reader.next_array_item():
            item = reader.read_number()
    """

    def __init__(self, source: Union[str, bytes, Any]):
        if isinstance(source, bytes):
            source = source.decode("utf-8")
        if isinstance(source, str):
            self._read = _io.StringIO(source).read
        elif hasattr(source, "read"):
            # byte streams decode incrementally: a multi-byte UTF-8
            # character split across read(1) calls must not error
            decoder = codecs.getincrementaldecoder("utf-8")()

            def _read(n: int, _src=source, _dec=decoder) -> str:
                out = ""
                while len(out) < n:
                    chunk = _src.read(1)
                    if not chunk:
                        break
                    if isinstance(chunk, str):
                        out += chunk
                    else:
                        out += _dec.decode(chunk)
                return out

            self._read = _read
        else:
            raise TypeError("JSONReader wants str, bytes or a stream")
        self._peeked: Optional[str] = None
        self.line = 1  # line counter for error messages (json.h:160)
        # scope_counter_ equivalent: items consumed in the current scope
        self._scope_counts: list = []

    # ---- char-level core ----------------------------------------------

    def _next_char(self) -> str:
        if self._peeked is not None:
            c, self._peeked = self._peeked, None
        else:
            c = self._read(1)
        if c == "\n":
            self.line += 1
        return c

    def _peek_char(self) -> str:
        if self._peeked is None:
            self._peeked = self._read(1)
        return self._peeked

    def _next_nonspace(self) -> str:
        while True:
            c = self._next_char()
            if c == "":
                raise self._error("unexpected end of input")
            if c not in _WS:
                return c

    def _peek_nonspace(self) -> str:
        while True:
            c = self._peek_char()
            if c == "":
                raise self._error("unexpected end of input")
            if c not in _WS:
                return c
            self._next_char()

    def _expect(self, want: str) -> None:
        got = self._next_nonspace()
        if got != want:
            raise self._error(f"expected {want!r}, got {got!r}")

    def _error(self, msg: str) -> DMLCError:
        return DMLCError(f"JSON parse error at line {self.line}: {msg}")

    # ---- token surface (json.h:62-111) --------------------------------

    def read_string(self) -> str:
        self._expect('"')
        out = []
        while True:
            c = self._next_char()
            if c == "":
                raise self._error("unterminated string")
            if c == '"':
                return "".join(out)
            if c == "\\":
                esc = self._next_char()
                if esc == "u":
                    out.append(self._read_unicode_escape())
                elif esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                else:
                    raise self._error(f"bad escape \\{esc}")
            else:
                out.append(c)

    def _read_unicode_escape(self) -> str:
        """\\uXXXX after the backslash-u; combines surrogate pairs (the
        ensure_ascii encoding of non-BMP characters)."""
        code = int("".join(self._next_char() for _ in range(4)), 16)
        if 0xD800 <= code < 0xDC00:
            if self._next_char() == "\\" and self._next_char() == "u":
                low = int("".join(self._next_char() for _ in range(4)), 16)
                if 0xDC00 <= low < 0xE000:
                    return chr(
                        0x10000 + ((code - 0xD800) << 10) + (low - 0xDC00)
                    )
            raise self._error("lone high surrogate in \\u escape")
        return chr(code)

    def read_number(self) -> Union[int, float]:
        buf = [self._next_nonspace()]
        while True:
            c = self._peek_char()
            if c and (c.isdigit() or c in "+-.eE"):
                buf.append(self._next_char())
            else:
                break
        text = "".join(buf)
        try:
            if any(ch in text for ch in ".eE"):
                return float(text)
            return int(text)
        except ValueError as err:
            raise self._error(f"bad number {text!r}") from err

    def read_bool(self) -> bool:
        c = self._peek_nonspace()
        word = "true" if c == "t" else "false"
        for expect in word:
            if self._next_char() != expect:
                raise self._error(f"expected {word!r}")
        return word == "true"

    def read_null(self) -> None:
        for expect in "null":
            got = self._next_nonspace() if expect == "n" else self._next_char()
            if got != expect:
                raise self._error("expected 'null'")
        return None

    def begin_object(self) -> None:
        self._expect("{")
        self._scope_counts.append(0)

    def begin_array(self) -> None:
        self._expect("[")
        self._scope_counts.append(0)

    def next_object_item(self) -> Optional[str]:
        """The key of the next item, or None at object end (json.h:104)."""
        c = self._peek_nonspace()
        if c == "}":
            self._next_char()
            self._scope_counts.pop()
            return None
        if self._scope_counts[-1] > 0:
            self._expect(",")
            if self._peek_nonspace() == "}":  # tolerate trailing close
                self._next_char()
                self._scope_counts.pop()
                return None
        self._scope_counts[-1] += 1
        key = self.read_string()
        self._expect(":")
        return key

    def next_array_item(self) -> bool:
        c = self._peek_nonspace()
        if c == "]":
            self._next_char()
            self._scope_counts.pop()
            return False
        if self._scope_counts[-1] > 0:
            self._expect(",")
            if self._peek_nonspace() == "]":
                self._next_char()
                self._scope_counts.pop()
                return False
        self._scope_counts[-1] += 1
        return True

    # ---- typed read (json.h:119 Read<ValueType>) ----------------------

    def read_value(self) -> Any:
        """Read any JSON value into Python types (dict/list/str/num/...)."""
        c = self._peek_nonspace()
        if c == "{":
            out: Dict[str, Any] = {}
            self.begin_object()
            while (key := self.next_object_item()) is not None:
                out[key] = self.read_value()
            return out
        if c == "[":
            items = []
            self.begin_array()
            while self.next_array_item():
                items.append(self.read_value())
            return items
        if c == '"':
            return self.read_string()
        if c == "t" or c == "f":
            return self.read_bool()
        if c == "n":
            return self.read_null()
        return self.read_number()


class JSONWriter:
    """Structured writer (json.h:188): multi-line objects with indent,
    arrays inline by default, strings escaped."""

    def __init__(self, stream=None, indent: int = 2):
        self._out = stream if stream is not None else _io.StringIO()
        if not hasattr(self._out, "write"):
            raise TypeError(
                f"JSONWriter sink must be writable, got "
                f"{type(self._out).__name__}"
            )
        self._binary: Optional[bool] = None  # detected on first write
        self._indent = indent
        self._scopes: list = []  # [count of items written per open scope]
        self._multi: list = []

    def getvalue(self) -> str:
        if isinstance(self._out, _io.StringIO):
            return self._out.getvalue()
        raise DMLCError("getvalue() only on the default string sink")

    def _w(self, text: str) -> None:
        out = self._out
        if self._binary is None:
            # detect once: the io.Stream surface takes bytes, text files str
            try:
                out.write(text)
                self._binary = False
                return
            except TypeError:
                self._binary = True
        if self._binary:
            out.write(text.encode("utf-8"))
        else:
            out.write(text)

    def _newline_indent(self) -> None:
        self._w("\n" + " " * (self._indent * len(self._scopes)))

    def write_string(self, s: str) -> None:
        out = ['"']
        for ch in s:
            if ch in _ESCAPES_OUT:
                out.append(_ESCAPES_OUT[ch])
            elif ord(ch) < 0x20:
                out.append(f"\\u{ord(ch):04x}")
            else:
                out.append(ch)
        out.append('"')
        self._w("".join(out))

    def write_number(self, v: Union[int, float]) -> None:
        if isinstance(v, bool):  # bool is an int subclass; order matters
            self._w("true" if v else "false")
        elif isinstance(v, float):
            if not math.isfinite(v):
                # repr() would emit bare inf/nan — invalid JSON that no
                # reader accepts; fail at write time, not load time
                raise DMLCError(
                    f"JSON cannot encode non-finite float {v!r}"
                )
            self._w(repr(v))
        else:
            self._w(str(v))

    def begin_object(self, multi_line: bool = True) -> None:
        self._w("{")
        self._scopes.append(0)
        self._multi.append(multi_line)

    def end_object(self) -> None:
        count = self._scopes.pop()
        multi = self._multi.pop()
        if multi and count:
            self._newline_indent()
        self._w("}")

    def write_object_keyvalue(self, key: str, value: Any) -> None:
        if self._scopes[-1] > 0:
            self._w(",")
        if self._multi[-1]:
            self._newline_indent()
        self._scopes[-1] += 1
        self.write_string(key)
        self._w(": ")
        self.write_value(value)

    def begin_array(self, multi_line: bool = False) -> None:
        self._w("[")
        self._scopes.append(0)
        self._multi.append(multi_line)

    def end_array(self) -> None:
        count = self._scopes.pop()
        multi = self._multi.pop()
        if multi and count:
            self._newline_indent()
        self._w("]")

    def write_array_item(self, value: Any) -> None:
        if self._scopes[-1] > 0:
            self._w(",")
            if not self._multi[-1]:
                self._w(" ")
        if self._multi[-1]:
            self._newline_indent()
        self._scopes[-1] += 1
        self.write_value(value)

    def write_value(self, value: Any) -> None:
        """Write any Python tree of dict/list/str/num/bool/None."""
        if value is None:
            self._w("null")
        elif isinstance(value, bool):
            self._w("true" if value else "false")
        elif isinstance(value, (int, float)):
            self.write_number(value)
        elif isinstance(value, str):
            self.write_string(value)
        elif isinstance(value, dict):
            self.begin_object()
            for k, v in value.items():
                self.write_object_keyvalue(str(k), v)
            self.end_object()
        elif isinstance(value, (list, tuple)):
            self.begin_array()
            for item in value:
                self.write_array_item(item)
            self.end_array()
        else:
            raise DMLCError(
                f"JSONWriter cannot encode {type(value).__name__}"
            )


class JSONObjectReadHelper:
    """Declare-fields reader (json.h:310)::

        helper = JSONObjectReadHelper()
        helper.declare_field("name", str)
        helper.declare_optional_field("count", int, default=0)
        values = helper.read_all_fields(reader)

    ``ftype`` may be a type (isinstance-checked after read_value) or a
    callable ``f(reader) -> value`` for custom decoding. Unknown keys and
    missing required fields raise, matching ReadAllFields (json.h:336).
    """

    def __init__(self):
        self._fields: Dict[str, tuple] = {}

    def declare_field(self, key: str, ftype) -> None:
        self._fields[key] = (ftype, False, None)

    def declare_optional_field(self, key: str, ftype, default=None) -> None:
        self._fields[key] = (ftype, True, default)

    def read_all_fields(self, reader: JSONReader) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        reader.begin_object()
        while (key := reader.next_object_item()) is not None:
            spec = self._fields.get(key)
            if spec is None:
                raise DMLCError(
                    f"JSONObjectReadHelper: unknown field {key!r} "
                    f"(declared: {sorted(self._fields)})"
                )
            ftype = spec[0]
            if isinstance(ftype, type):
                value = reader.read_value()
                if ftype in (int, float) and isinstance(value, (int, float)) \
                        and not isinstance(value, bool):
                    value = ftype(value)
                elif not isinstance(value, ftype) or (
                    ftype is not bool and isinstance(value, bool)
                ):
                    raise DMLCError(
                        f"field {key!r}: expected {ftype.__name__}, got "
                        f"{type(value).__name__}"
                    )
            else:
                value = ftype(reader)
            out[key] = value
        for key, (_t, optional, default) in self._fields.items():
            if key not in out:
                if not optional:
                    raise DMLCError(
                        f"JSONObjectReadHelper: required field {key!r} "
                        f"missing"
                    )
                out[key] = default
        return out


# ---- module-level conveniences (the dmlc::JSON loads/dumps shape) ---------


def loads(text: Union[str, bytes]) -> Any:
    return JSONReader(text).read_value()


def dumps(value: Any, indent: int = 2) -> str:
    writer = JSONWriter(indent=indent)
    writer.write_value(value)
    return writer.getvalue()


def load(stream) -> Any:
    return JSONReader(stream).read_value()


def dump(value: Any, stream, indent: int = 2) -> None:
    JSONWriter(stream, indent=indent).write_value(value)
