"""Model registry (counterpart of thyroid_tpu/models/registry.py).

A two-level {type: {name: builder}} map with decorator registration;
`create_model` takes a config mapping (with `name`) or a bare name and
passes the whole config to the builder.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, List, Optional

import torch


class ModelRegistry:
    _registry: Dict[str, Dict[str, Callable[..., torch.nn.Module]]] = {}

    @classmethod
    def register(cls, names: str | Iterable[str],
                 model_type: str = "cnn") -> Callable:
        """Decorator: register a builder under one or more names."""
        if isinstance(names, str):
            names = [names]

        def deco(builder: Callable[..., torch.nn.Module]):
            bucket = cls._registry.setdefault(model_type, {})
            for name in names:
                if name in bucket:
                    raise ValueError(f"model '{name}' already registered in "
                                     f"'{model_type}'")
                bucket[name] = builder
            return builder

        return deco

    @classmethod
    def create_model(cls, config: Any) -> torch.nn.Module:
        if isinstance(config, str):
            name, cfg = config, {}
        else:
            name = config.get("name") if hasattr(config, "get") \
                else getattr(config, "name")
            cfg = config
        if name is None:
            raise ValueError("model config must carry a 'name'")
        builder = cls.lookup(name)
        if builder is None:
            raise ValueError(f"unknown model '{name}'. Registered: "
                             f"{cls.list_models()}")
        return builder(cfg)

    @classmethod
    def lookup(cls, name: str) -> Optional[Callable[..., torch.nn.Module]]:
        for bucket in cls._registry.values():
            if name in bucket:
                return bucket[name]
        return None

    @classmethod
    def list_models(cls, model_type: str | None = None
                    ) -> List[str] | Dict[str, List[str]]:
        if model_type is not None:
            return sorted(cls._registry.get(model_type, {}))
        return {t: sorted(b) for t, b in cls._registry.items()}


def resolve_dtype(cfg: Any) -> torch.dtype:
    """Map a config 'dtype' field ('bf16'/'f32'/None) to a torch dtype."""
    v = cfg_get(cfg, "dtype", None)
    if v in (None, "f32", "float32", "32-true"):
        return torch.float32
    if v in ("bf16", "bfloat16", "16-mixed"):
        return torch.bfloat16
    if isinstance(v, torch.dtype):
        return v
    raise ValueError(f"unsupported model dtype {v!r}")


def cfg_get(cfg: Any, key: str, default: Any = None) -> Any:
    """Tolerant config getter: attribute, mapping, or nested `params`."""
    if cfg is None:
        return default
    if isinstance(cfg, dict):
        if key in cfg and cfg[key] is not None:
            return cfg[key]
    elif hasattr(cfg, key):
        v = getattr(cfg, key)
        if v is not None:
            return v
    params = None
    if hasattr(cfg, "params"):
        params = getattr(cfg, "params")
    elif isinstance(cfg, dict):
        params = cfg.get("params")
    if params is not None and params is not cfg:
        return cfg_get(params, key, default)
    return default
