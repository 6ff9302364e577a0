"""URI "sugar" parsing: ``path?key=val&...#cachefile`` (``dmlc::io::URISpec``).

A ``#cachefile`` selects the InputSplit's chunk cache
(``io/input_split.CachedInputSplit``, and so the parser's);
``data/row_iter.create_row_block_iter`` strips it and caches parsed pages
there instead.
"""

from __future__ import annotations

from typing import Dict

from dmlc_tpu_torch.utils.logging import check_eq


class URISpec:
    def __init__(self, uri: str, part_index: int = 0, num_parts: int = 1):
        name_cache = uri.split("#")
        check_eq(
            len(name_cache) <= 2,
            True,
            "only one `#` is allowed in file path for cachefile specification",
        )
        self.cache_file = ""
        if len(name_cache) == 2:
            cache = name_cache[1]
            if num_parts != 1:
                cache += f".split{num_parts}.part{part_index}"
            self.cache_file = cache
        name_args = name_cache[0].split("?")
        check_eq(
            len(name_args) <= 2,
            True,
            "only one `?` is allowed in file path for argument specification",
        )
        self.args: Dict[str, str] = {}
        if len(name_args) == 2:
            for i, item in enumerate(name_args[1].split("&")):
                if not item:
                    continue
                key, sep, value = item.partition("=")
                check_eq(sep, "=", f"Invalid uri argument format in arg {i + 1}")
                self.args[key] = value
        self.uri = name_args[0]
