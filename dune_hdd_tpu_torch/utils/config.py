"""INI-style configuration (Stuff::Common::Configuration analog).

Counterpart of ``dune_hdd_tpu/utils/config.py``, plain Python: the ``.cfg``
files are shared text, so a config either package writes loads in the
other.  The reference merges (argc, argv, cfg-file) into a ParameterTree
(discreteproblem.hh:98) with the idiom static_id() / default_config() /
create(cfg) on every constructible class.  Values are parsed leniently:
ints, floats, booleans, "[a b c]" vectors, "[a b; c d]" matrices, bare
strings.
"""
from __future__ import annotations

import io
import re
from typing import Any, Dict, List, Mapping, Optional, Union

__all__ = ["Configuration", "parse_value", "format_value"]


def parse_value(s: str) -> Any:
    s = s.strip()
    if re.fullmatch(r"[+-]?\d+", s):
        return int(s)
    try:
        return float(s)
    except ValueError:
        pass
    if s.lower() in ("true", "false"):
        return s.lower() == "true"
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        if ";" in inner:
            return [
                [parse_value(v) for v in row.split()] for row in inner.split(";")
            ]
        return [parse_value(v) for v in inner.split()]
    return s


def format_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (list, tuple)):
        if v and isinstance(v[0], (list, tuple)):
            return "[" + "; ".join(" ".join(str(x) for x in row) for row in v) + "]"
        return "[" + " ".join(str(x) for x in v) + "]"
    return str(v)


class Configuration:
    """Nested string-keyed tree; keys use dotted paths, sections come from
    INI-style ``[section]`` headers."""

    def __init__(self, data: Optional[Mapping] = None):
        self._data: Dict[str, Any] = {}
        if data:
            for k, v in dict(data).items():
                self[k] = v

    # -- dict-ish access with dotted keys -----------------------------------
    def __setitem__(self, key: str, value: Any):
        parts = key.split(".")
        node = self._data
        for p in parts[:-1]:
            node = node.setdefault(p, {})
            if not isinstance(node, dict):
                raise KeyError(f"{key!r}: {p!r} is a leaf")
        if isinstance(value, Mapping):
            sub = node.setdefault(parts[-1], {})
            for k, v in value.items():
                Configuration._set_into(sub, k, v)
        else:
            node[parts[-1]] = value

    @staticmethod
    def _set_into(node, key, value):
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if isinstance(value, Mapping):
            sub = node.setdefault(parts[-1], {})
            for k, v in value.items():
                Configuration._set_into(sub, k, v)
        else:
            node[parts[-1]] = value

    def __getitem__(self, key: str) -> Any:
        node = self._data
        for p in key.split("."):
            node = node[p]
        return node

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def has_key(self, key: str) -> bool:
        return self.get(key, _MISSING) is not _MISSING

    def has_sub(self, key: str) -> bool:
        return isinstance(self.get(key), dict)

    def sub(self, key: str) -> "Configuration":
        v = self[key]
        if not isinstance(v, dict):
            raise KeyError(f"{key!r} is not a section")
        return Configuration(v)

    def add(self, other: Union["Configuration", Mapping], sub_name: str = ""):
        data = other._data if isinstance(other, Configuration) else dict(other)
        for k, v in data.items():
            key = f"{sub_name}.{k}" if sub_name else k
            self[key] = v
        return self

    def as_dict(self) -> Dict:
        return self._data

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    # -- INI round trip ------------------------------------------------------
    @classmethod
    def from_string(cls, text: str) -> "Configuration":
        cfg = cls()
        section = ""
        for raw in text.splitlines():
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            m = re.fullmatch(r"\[([\w.]*)\]", line)
            if m:
                section = m.group(1)
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                key = f"{section}.{k.strip()}" if section else k.strip()
                cfg[key] = parse_value(v)
        return cfg

    @classmethod
    def from_file(cls, path: str) -> "Configuration":
        with open(path) as fh:
            return cls.from_string(fh.read())

    def to_string(self) -> str:
        out = io.StringIO()

        def walk(node: Dict, prefix: str):
            leaves = {k: v for k, v in node.items() if not isinstance(v, dict)}
            subs = {k: v for k, v in node.items() if isinstance(v, dict)}
            if leaves:
                if prefix:
                    out.write(f"[{prefix}]\n")
                for k, v in leaves.items():
                    out.write(f"{k} = {format_value(v)}\n")
                out.write("\n")
            for k, v in subs.items():
                walk(v, f"{prefix}.{k}" if prefix else k)

        walk(self._data, "")
        return out.getvalue()

    def write(self, path: str):
        with open(path, "w") as fh:
            fh.write(self.to_string())

    def __repr__(self):
        return f"Configuration({self._data!r})"


class _Missing:
    pass


_MISSING = _Missing()
