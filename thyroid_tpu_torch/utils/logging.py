"""Console logging (counterpart of thyroid_tpu/utils/logging.py).

`get_logger` configures a named logger once: level, a stderr handler with
time, level and name, no propagation to the root logger. The JAX package
prints through `rich` where it is installed; the port prints plain lines,
since the card's machine has no `rich`.
"""
from __future__ import annotations

import logging
import sys
from typing import Any, Mapping

_CONFIGURED: set[str] = set()


def get_logger(name: str = "thyroid_tpu_torch",
               level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if name not in _CONFIGURED:
        logger.setLevel(level)
        logger.propagate = False
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
        logger.addHandler(handler)
        _CONFIGURED.add(name)
    return logger


def print_table(title: str, rows: Mapping[str, Any]) -> None:
    """Key/value summary, one `key: value` line each under the title."""
    print(f"== {title} ==")
    for k, v in rows.items():
        print(f"  {k}: {v}")


def print_config_summary(cfg: Any, title: str = "config") -> None:
    flat = dict(cfg.flat_items()) if hasattr(cfg, "flat_items") else dict(cfg)
    print_table(title, flat)
