"""Config tree with attribute and item access (counterpart of
thyroid_tpu/config/node.py, the same class).

A dependency-free stand-in for Hydra/OmegaConf's DictConfig: dotted-path
get/set/update, deep merge, plain YAML values without interpolation, and
`to_dict` back to plain nested dicts and lists.
"""
from __future__ import annotations

import copy
import json
from typing import Any, Iterator, Mapping


_MISSING = object()


class ConfigNode(dict):
    """A dict whose string keys are also attributes; nested dicts are wrapped."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kw: Any):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v
        for k, v in kw.items():
            self[k] = v

    # -- wrapping ---------------------------------------------------------
    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, ConfigNode):
            return value
        if isinstance(value, Mapping):
            return ConfigNode(value)
        if isinstance(value, (list, tuple)):
            return [ConfigNode._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, ConfigNode._wrap(value))

    # -- attribute protocol ----------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    # -- dotted paths -----------------------------------------------------
    def select(self, path: str, default: Any = _MISSING) -> Any:
        """Get `a.b.c`; returns `default` (or raises KeyError) when absent."""
        node: Any = self
        for part in path.split("."):
            if isinstance(node, ConfigNode) and part in node:
                node = node[part]
            elif isinstance(node, list) and part.lstrip("-").isdigit():
                idx = int(part)
                if -len(node) <= idx < len(node):
                    node = node[idx]
                else:
                    node = _MISSING
            else:
                node = _MISSING
            if node is _MISSING:
                if default is _MISSING:
                    raise KeyError(path)
                return default
        return node

    def update_path(self, path: str, value: Any) -> None:
        """Set `a.b.c = value`, creating intermediate nodes."""
        parts = path.split(".")
        node = self
        for part in parts[:-1]:
            nxt = node.get(part)
            if not isinstance(nxt, ConfigNode):
                nxt = ConfigNode()
                node[part] = nxt
            node = nxt
        node[parts[-1]] = value

    # -- merging ----------------------------------------------------------
    def merge(self, other: Mapping[str, Any]) -> "ConfigNode":
        """Deep-merge `other` into self (other wins); returns self."""
        for k, v in other.items():
            if isinstance(v, Mapping) and isinstance(self.get(k), ConfigNode):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    # -- conversion --------------------------------------------------------
    def to_dict(self) -> dict:
        out: dict = {}
        for k, v in self.items():
            if isinstance(v, ConfigNode):
                out[k] = v.to_dict()
            elif isinstance(v, list):
                out[k] = [x.to_dict() if isinstance(x, ConfigNode) else x for x in v]
            else:
                out[k] = v
        return out

    def to_json(self, **kw: Any) -> str:
        return json.dumps(self.to_dict(), **kw)

    def copy(self) -> "ConfigNode":  # type: ignore[override]
        return ConfigNode(copy.deepcopy(self.to_dict()))

    def __deepcopy__(self, memo: dict) -> "ConfigNode":
        return ConfigNode(copy.deepcopy(self.to_dict(), memo))

    def flat_items(self, prefix: str = "") -> Iterator[tuple[str, Any]]:
        for k, v in self.items():
            path = f"{prefix}{k}"
            if isinstance(v, ConfigNode):
                yield from v.flat_items(prefix=path + ".")
            else:
                yield path, v

    def __repr__(self) -> str:
        return f"ConfigNode({self.to_dict()!r})"
