"""Serving (counterpart of thyroid_tpu/serving): the bucketed engine, the
request aggregator, int8 serving, export bundles and the HTTP front end
(`python -m thyroid_tpu_torch.serving.server`). The names load lazily, so
that the models can import `serving.quantize` without the engine, and a
bundle loads without the model code."""
from __future__ import annotations

import importlib

_EXPORTS = {"InferenceEngine": "engine", "BatchAggregator": "aggregator",
            "QuantConfig": "quantize", "int8_serving": "quantize",
            "quantized_apply": "quantize", "ExportedEngine": "export",
            "export_engine": "export", "load_exported": "export"}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
