"""Experiment lifecycle (counterpart of thyroid_tpu/experiment/
base_experiment.py): setup, run and log_results, driven by execute()."""
from __future__ import annotations

import abc
from pathlib import Path
from typing import Any, Dict

from ..utils.logging import get_logger

logger = get_logger(__name__)


class BaseExperiment(abc.ABC):
    def __init__(self, config: Any):
        self.config = config
        self.results: Dict[str, Any] = {}
        self.output_dir: Path = Path(getattr(config, "output_dir", None)
                                     or config.get("output_dir", "outputs"))

    @abc.abstractmethod
    def setup(self) -> None:
        ...

    @abc.abstractmethod
    def run(self) -> Dict[str, Any]:
        ...

    @abc.abstractmethod
    def log_results(self) -> None:
        ...

    def execute(self) -> Dict[str, Any]:
        logger.info("experiment setup: %s", type(self).__name__)
        self.setup()
        logger.info("experiment run")
        self.results = self.run()
        self.log_results()
        return self.results
