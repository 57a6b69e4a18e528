"""Config composition (counterpart of thyroid_tpu/config).

The pydantic schemas load on first use of one of their names, so that
importing this package, and the experiment path, needs no pydantic.
"""
from importlib import import_module
from typing import Any

from .loader import (DEFAULT_CONFIG_DIR, compose, list_model_configs,
                     load_model_config)
from .node import ConfigNode

_SCHEMAS = (
    "PathsConfig", "BaseModelConfig", "OptimizerParams", "SchedulerParams",
    "TrainerConfig", "TrainingConfig", "DatasetConfig", "KFoldConfig",
    "DistillationConfig", "AblationConfig", "AblationParameterConfig",
    "ExperimentConfig", "MainAppConfig",
)

__all__ = ["ConfigNode", "compose", "load_model_config", "list_model_configs",
           "DEFAULT_CONFIG_DIR", *_SCHEMAS]


def __getattr__(name: str) -> Any:
    if name in _SCHEMAS:
        return getattr(import_module(".schemas", __name__), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
