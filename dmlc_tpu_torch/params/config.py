"""``key = value`` config-file parser (the port of
``dmlc_tpu/params/config.py``).

Capability parity with ``dmlc::Config`` (reference include/dmlc/config.h +
src/config.cc): ``#`` comments, quoted string values with escape sequences,
optional multi-value mode (a key may appear multiple times), iteration in
insertion order, and proto-text export (``ToProtoString``, config.h:102).
"""

from __future__ import annotations

import io
from typing import Dict, Iterator, List, Tuple

from dmlc_tpu_torch.utils.logging import DMLCError

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\"}
_REV_ESCAPES = {"\n": "\\n", "\t": "\\t", "\r": "\\r", '"': '\\"', "\\": "\\\\"}


def _tokenize(text: str) -> List[str]:
    """Tokenize into keys, '=', and (possibly quoted) values.

    Mirrors the tokenizer state machine of src/config.cc:30-100: whitespace
    separates tokens, ``#`` starts a line comment outside quotes, double quotes
    group a token and process escapes.
    """
    tokens: List[str] = []
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        if ch in " \t\r\n":
            i += 1
            continue
        if ch == "#":
            while i < n and text[i] != "\n":
                i += 1
            continue
        if ch == "=":
            tokens.append("=")
            i += 1
            continue
        if ch == '"':
            i += 1
            out = []
            closed = False
            while i < n:
                c = text[i]
                if c == "\\":
                    if i + 1 >= n:
                        raise DMLCError("Config: dangling escape in quoted string")
                    esc = text[i + 1]
                    out.append(_ESCAPES.get(esc, esc))
                    i += 2
                    continue
                if c == '"':
                    closed = True
                    i += 1
                    break
                out.append(c)
                i += 1
            if not closed:
                raise DMLCError("Config: unterminated quoted string")
            tokens.append('"' + "".join(out))  # marker prefix: was quoted
            continue
        start = i
        while i < n and text[i] not in ' \t\r\n=#"':
            i += 1
        tokens.append(text[start:i])
    return tokens


class Config:
    """Ordered key/value config, optionally multi-valued.

    ``multi_value=True`` keeps every occurrence of a repeated key (reference
    Config ctor flag, config.h:46-56); otherwise later wins.
    """

    def __init__(self, source: str | io.TextIOBase | None = None, multi_value: bool = False):
        self.multi_value = multi_value
        self._items: List[Tuple[str, str]] = []
        self._index: Dict[str, int] = {}
        if source is not None:
            if hasattr(source, "read"):
                self.load_string(source.read())  # type: ignore[union-attr]
            else:
                self.load_string(source)  # type: ignore[arg-type]

    # ---- parsing -------------------------------------------------------
    def load_string(self, text: str) -> None:
        tokens = _tokenize(text)
        i = 0
        while i < len(tokens):
            if i + 2 >= len(tokens) + 1 and tokens[i] == "=":
                raise DMLCError("Config: stray '='")
            if i + 2 > len(tokens) or tokens[i + 1] != "=":
                raise DMLCError(
                    f"Config: expected 'key = value' near {tokens[i]!r}"
                )
            key = tokens[i]
            if key.startswith('"'):
                key = key[1:]
            value = tokens[i + 2] if i + 2 < len(tokens) else None
            if value is None:
                raise DMLCError(f"Config: missing value for key {key!r}")
            if value == "=":
                raise DMLCError(f"Config: missing value for key {key!r}")
            if value.startswith('"'):
                value = value[1:]
            self.set_param(key, value)
            i += 3

    def load_file(self, path: str) -> None:
        with open(path, "r", encoding="utf-8") as fp:
            self.load_string(fp.read())

    # ---- mutation ------------------------------------------------------
    def set_param(self, key: str, value) -> None:
        value = str(value)
        if not self.multi_value and key in self._index:
            self._items[self._index[key]] = (key, value)
        else:
            self._index[key] = len(self._items)
            self._items.append((key, value))

    # ---- access --------------------------------------------------------
    def get_param(self, key: str) -> str:
        if key not in self._index:
            raise KeyError(key)
        if self.multi_value:
            # Last occurrence wins for scalar access.
            for k, v in reversed(self._items):
                if k == key:
                    return v
        return self._items[self._index[key]][1]

    def get_all(self, key: str) -> List[str]:
        return [v for k, v in self._items if k == key]

    def __contains__(self, key: str) -> bool:
        return key in self._index

    def __iter__(self) -> Iterator[Tuple[str, str]]:
        """Iterate (key, value) in insertion order (reference ConfigIterator)."""
        return iter(self._items)

    def items(self) -> List[Tuple[str, str]]:
        return list(self._items)

    # ---- export --------------------------------------------------------
    def to_proto_string(self) -> str:
        """proto-text export: ``key : "value"`` lines (config.h:102)."""
        lines = []
        for key, value in self._items:
            escaped = "".join(_REV_ESCAPES.get(c, c) for c in value)
            lines.append(f'{key} : "{escaped}"')
        return "\n".join(lines) + ("\n" if lines else "")
