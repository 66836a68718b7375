"""Minimal structured-config engine (OmegaConf-compatible subset).

The port's own copy of the JAX package's config engine
(`ganslate_tpu/configs/omega.py`), so that the two packages share no code.
It implements the subset of OmegaConf the framework needs:

- ``Conf.load(path)`` / ``Conf.from_yaml(text)`` — YAML -> config tree
- ``Conf.from_dotlist(["a.b=1", ...])`` — CLI overrides
- ``Conf.structured(DataclassType)`` — dataclass (tree) -> config tree with
  defaults, preserving nested dataclasses / Optional / Dict / List fields
- ``Conf.merge(a, b, ...)`` — recursive merge, rightmost wins
- ``${a.b.c}`` interpolation resolved lazily against the root at access time
- ``II("a.b")`` helper producing an interpolation string
- ``MISSING`` ("???") values that raise on access
- attribute + item access, ``select``, ``to_yaml``, ``to_container``

PyYAML is imported only by the functions that parse YAML; ``to_yaml`` has
its own emitter. So a config built in Python (``Conf.create`` +
``init_config``), its dump, and the training and serving paths work on
machines without PyYAML.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import re
import typing
from typing import Any, Dict, List, Optional, Union

MISSING: str = "???"

_INTERP_RE = re.compile(r"\$\{([^}]+)\}")


def II(path: str) -> str:
    """Interpolation marker: II("train.batch_size") == "${train.batch_size}"."""
    return "${" + path + "}"


class MissingMandatoryValue(Exception):
    pass


class ConfigKeyError(KeyError):
    pass


class InterpolationResolutionError(Exception):
    pass


def _is_interp(v: Any) -> bool:
    return isinstance(v, str) and _INTERP_RE.search(v) is not None


def _structured_to_raw(obj: Any) -> Any:
    """Convert a dataclass (type or instance) / container to raw python tree."""
    if dataclasses.is_dataclass(obj) and isinstance(obj, type):
        obj = _instantiate_dataclass(obj)
    if dataclasses.is_dataclass(obj):
        out = {}
        for f in dataclasses.fields(obj):
            try:
                v = getattr(obj, f.name)
            except AttributeError:
                v = MISSING
            out[f.name] = _structured_to_raw(v)
        return out
    if isinstance(obj, dict):
        return {k: _structured_to_raw(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_structured_to_raw(v) for v in obj]
    return obj


def _instantiate_dataclass(cls: type) -> Any:
    """Instantiate a dataclass type, filling fields without defaults as MISSING."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            continue
        if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
            continue
        kwargs[f.name] = MISSING
    # Fields with MISSING must accept any value; dataclasses don't type-check.
    return cls(**kwargs)


def _merge_raw(dst: Any, src: Any) -> Any:
    """Recursive merge; src wins. Dicts merge deeply; everything else replaces."""
    if isinstance(dst, dict) and isinstance(src, dict):
        out = dict(dst)
        for k, v in src.items():
            if k in out:
                out[k] = _merge_raw(out[k], v)
            else:
                out[k] = copy.deepcopy(v)
        return out
    if src is MISSING or src == MISSING:
        # don't let a MISSING override a concrete default
        return copy.deepcopy(dst) if dst is not None else MISSING
    return copy.deepcopy(src)


def _parse_value(text: str) -> Any:
    """Parse a dotlist value with YAML semantics ('1'->int, 'null'->None...)."""
    if text == "":
        return ""
    import yaml
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


class Conf:
    """A node in the config tree. Wraps a raw dict and resolves interpolation.

    All mutation goes through the raw tree so that parent/child views stay
    consistent. Access via attributes (``conf.train.batch_size``) or items
    (``conf["train"]["batch_size"]``).
    """

    __slots__ = ("_data", "_root", "_resolving")

    def __init__(self, data: Optional[dict] = None, _root: Optional["Conf"] = None):
        object.__setattr__(self, "_data", data if data is not None else {})
        object.__setattr__(self, "_root", _root)
        object.__setattr__(self, "_resolving", None)

    # ---------------------------------------------------------- constructors
    @staticmethod
    def create(data: Optional[Union[dict, "Conf"]] = None) -> "Conf":
        if isinstance(data, Conf):
            return Conf(copy.deepcopy(data._data))
        return Conf(copy.deepcopy(data) if data else {})

    @staticmethod
    def load(path) -> "Conf":
        import yaml
        with open(path) as f:
            raw = yaml.safe_load(f)
        return Conf(raw or {})

    @staticmethod
    def from_yaml(text: str) -> "Conf":
        import yaml
        return Conf(yaml.safe_load(text) or {})

    @staticmethod
    def from_dotlist(dotlist: List[str]) -> "Conf":
        conf = Conf({})
        for item in dotlist:
            if "=" not in item:
                raise ValueError(f"dotlist entry must be key=value, got {item!r}")
            key, value = item.split("=", 1)
            conf.update(key.strip(), _parse_value(value.strip()))
        return conf

    @staticmethod
    def structured(obj: Any) -> "Conf":
        return Conf(_structured_to_raw(obj))

    @staticmethod
    def merge(*confs: Union["Conf", dict, Any]) -> "Conf":
        raw: Any = {}
        for c in confs:
            if c is None:
                continue
            if isinstance(c, Conf):
                c = c._data
            elif dataclasses.is_dataclass(c) or (isinstance(c, type) and dataclasses.is_dataclass(c)):
                c = _structured_to_raw(c)
            raw = _merge_raw(raw, c)
        return Conf(raw)

    # ---------------------------------------------------------- resolution
    def _get_root(self) -> "Conf":
        return self._root if self._root is not None else self

    def _resolve(self, value: Any, key: str) -> Any:
        if isinstance(value, str):
            if value == MISSING:
                raise MissingMandatoryValue(
                    f"Missing mandatory value: {key} (set it in YAML or CLI)")
            if _is_interp(value):
                return self._resolve_interp(value, key)
            return value
        if isinstance(value, dict):
            return Conf(value, _root=self._get_root())
        if isinstance(value, list):
            return ConfList(value, self._get_root(), key)
        return value

    def _resolve_interp(self, value: str, key: str) -> Any:
        root = self._get_root()
        full = _INTERP_RE.fullmatch(value.strip())
        if full:
            return root._select_resolved(full.group(1), origin=key)
        # string with embedded interpolation(s)
        def sub(m):
            v = root._select_resolved(m.group(1), origin=key)
            return str(v)
        return _INTERP_RE.sub(sub, value)

    def _select_resolved(self, path: str, origin: str = "") -> Any:
        node: Any = self._data
        parent = self
        parts = path.split(".")
        for i, p in enumerate(parts):
            if not isinstance(node, dict) or p not in node:
                raise InterpolationResolutionError(
                    f"Cannot resolve interpolation '${{{path}}}' (referenced from "
                    f"'{origin}'): key '{'.'.join(parts[:i+1])}' not found")
            node = node[p]
        return parent._resolve(node, path)

    # ---------------------------------------------------------- access
    def __getattr__(self, key: str) -> Any:
        if key.startswith("__"):
            raise AttributeError(key)
        try:
            return self[key]
        except ConfigKeyError:
            raise AttributeError(f"Config has no key '{key}'. Keys: {list(self._data)}")

    def __getitem__(self, key: str) -> Any:
        if key not in self._data:
            raise ConfigKeyError(key)
        return self._resolve(self._data[key], key)

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Conf):
            value = copy.deepcopy(value._data)
        elif dataclasses.is_dataclass(value) and not isinstance(value, type):
            value = _structured_to_raw(value)
        elif isinstance(value, tuple):
            value = list(value)
        self._data[key] = value

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other) -> bool:
        if isinstance(other, Conf):
            return self._data == other._data
        if isinstance(other, dict):
            return self._data == other
        return NotImplemented

    def __deepcopy__(self, memo) -> "Conf":
        return Conf(copy.deepcopy(self._data, memo))

    def __repr__(self) -> str:
        return f"Conf({self._data!r})"

    def get(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            return default
        try:
            value = self[key]
        except MissingMandatoryValue:
            return default
        return value if value is not None else (value if default is None else value)

    def keys(self):
        return self._data.keys()

    def values(self):
        return [self[k] for k in self._data]

    def items(self):
        return [(k, self[k]) for k in self._data]

    def pop(self, key: str, *default) -> Any:
        if key in self._data:
            value = self[key]
            del self._data[key]
            return value
        if default:
            return default[0]
        raise ConfigKeyError(key)

    def setdefault(self, key: str, value: Any) -> Any:
        if key not in self._data:
            self[key] = value
        return self[key]

    # ---------------------------------------------------------- utilities
    def update(self, path: str, value: Any) -> None:
        """Set a dotted path, creating intermediate dicts."""
        parts = path.split(".")
        node = self._data
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], dict):
                node[p] = {}
            node = node[p]
        if isinstance(value, Conf):
            value = copy.deepcopy(value._data)
        elif isinstance(value, tuple):
            value = list(value)
        node[parts[-1]] = value

    def select(self, path: str, default: Any = None) -> Any:
        try:
            return self._select_resolved(path)
        except (InterpolationResolutionError, MissingMandatoryValue):
            return default

    def is_missing(self, key: str) -> bool:
        v = self._data.get(key)
        return isinstance(v, str) and v == MISSING

    def raw(self) -> dict:
        """The underlying (unresolved) raw tree. Mutations write through."""
        return self._data

    def to_container(self, resolve: bool = True) -> dict:
        if not resolve:
            return copy.deepcopy(self._data)
        return self._to_container_resolved(self._data, self._get_root(), "")

    @staticmethod
    def _to_container_resolved(node: Any, root: "Conf", path: str) -> Any:
        if isinstance(node, dict):
            return {k: Conf._to_container_resolved(v, root, f"{path}.{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [Conf._to_container_resolved(v, root, path) for v in node]
        if isinstance(node, str):
            if node == MISSING:
                return MISSING
            if _is_interp(node):
                try:
                    view = Conf(root._data)
                    value = view._resolve_interp(node, path)
                except (InterpolationResolutionError, MissingMandatoryValue):
                    return node
                # An interpolation of a subtree resolves to a view of it.
                return value.to_container() if isinstance(value, (Conf, ConfList)) else value
        return node

    def to_yaml(self, resolve: bool = False) -> str:
        """The tree as block-style YAML, from the port's own emitter (no
        PyYAML): every string double-quoted as JSON quotes it, which YAML
        reads back."""
        return _emit_yaml(self.to_container(resolve=resolve))


# Plain keys (left unquoted): identifiers that YAML does not read as a bool
# or null.
_PLAIN_KEY_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_YAML_WORDS = {"y", "n", "yes", "no", "on", "off", "true", "false", "null"}


def _yaml_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        # YAML 1.1 floats have a dot: 1e-05 -> 1.0e-05.
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        text = json.dumps(value, ensure_ascii=False)
        # JSON escapes the C0 controls; YAML also wants the other
        # non-printable characters escaped.
        return "".join(c if c.isprintable() else
                       f"\\u{ord(c):04x}" if ord(c) < 0x10000 else f"\\U{ord(c):08x}"
                       for c in text)
    raise TypeError(f"cannot emit a {type(value).__name__} as a YAML scalar: {value!r}")


def _yaml_key(key: Any) -> str:
    if isinstance(key, str) and _PLAIN_KEY_RE.fullmatch(key) and key.lower() not in _YAML_WORDS:
        return key
    return _yaml_scalar(key)


def _yaml_block(node: Any) -> bool:
    return isinstance(node, (dict, list)) and len(node) > 0


def _yaml_lines(node: Any, indent: int) -> List[str]:
    pad = " " * indent
    lines = []
    if isinstance(node, dict):
        for key, value in node.items():
            if _yaml_block(value):
                lines.append(f"{pad}{_yaml_key(key)}:")
                lines.extend(_yaml_lines(value, indent + 2))
            else:
                lines.append(f"{pad}{_yaml_key(key)}: {_yaml_flow(value)}")
    else:
        for item in node:
            if _yaml_block(item):
                sub = _yaml_lines(item, indent + 2)
                lines.append(f"{pad}- {sub[0][indent + 2:]}")
                lines.extend(sub[1:])
            else:
                lines.append(f"{pad}- {_yaml_flow(item)}")
    return lines


def _yaml_flow(value: Any) -> str:
    """A scalar, or an empty container."""
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, list):
        return "[]"
    return _yaml_scalar(value)


def _emit_yaml(tree: Any) -> str:
    """Block-style YAML of a tree of dicts, lists and scalars."""
    if not _yaml_block(tree):
        return _yaml_flow(tree) + "\n"
    return "\n".join(_yaml_lines(tree, 0)) + "\n"


class ConfList:
    """List view that resolves nested dicts/interpolations on access."""

    __slots__ = ("_data", "_rootc", "_key")

    def __init__(self, data: list, root: Conf, key: str):
        self._data = data
        self._rootc = root
        self._key = key

    def __getitem__(self, i):
        v = self._data[i]
        view = Conf(self._rootc._data)
        return view._resolve(v, f"{self._key}[{i}]")

    def __setitem__(self, i, value):
        self._data[i] = value

    def __len__(self):
        return len(self._data)

    def __iter__(self):
        for i in range(len(self._data)):
            yield self[i]

    def __eq__(self, other):
        if isinstance(other, ConfList):
            return self._data == other._data
        if isinstance(other, (list, tuple)):
            return list(self) == list(other)
        return NotImplemented

    def __repr__(self):
        return f"ConfList({self._data!r})"

    def to_container(self):
        return [x.to_container() if isinstance(x, Conf) else x for x in self]
