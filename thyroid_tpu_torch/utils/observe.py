"""Observability (counterpart of thyroid_tpu/utils/observe.py): a JSON-lines
scalar and image logger and a rolling step timer. The TensorBoard and
wandb mirrors of the JAX logger are not ported."""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

from ..data.imageio import encode_png


class MetricLogger:
    """Appends one JSON object per `log` call to log_dir/metrics.jsonl."""

    def __init__(self, log_dir: str | Path):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        record = {"step": step, "time": time.time(),
                  **{k: v for k, v in metrics.items()
                     if isinstance(v, (int, float))}}
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()

    def log_image(self, tag: str, image, step: int) -> Path:
        """Write a matplotlib figure (savefig, then closed) or a gray
        (H, W[, 1]) array (min-max scaled to uint8, data/imageio.py's PNG
        writer) as log_dir/images/{tag}_{step:05d}.png; → the path."""
        img_dir = self.log_dir / "images"
        img_dir.mkdir(exist_ok=True)
        path = img_dir / f"{tag.replace('/', '_')}_{step:05d}.png"
        if hasattr(image, "savefig"):                      # matplotlib figure
            image.savefig(path, dpi=110, bbox_inches="tight")
            import matplotlib.pyplot as plt

            plt.close(image)
        else:
            arr = np.asarray(image)
            arr = (arr - arr.min()) / max(float(arr.max() - arr.min()), 1e-9)
            path.write_bytes(encode_png((arr * 255).astype(np.uint8)))
        return path

    def close(self) -> None:
        self._jsonl.close()


class StepTimer:
    """Rolling per-step wall-clock stats (steps/sec, ms/step)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {}
        dt = float(np.median(self._times))
        return {"ms_per_step": dt * 1000.0,
                "steps_per_sec": 1.0 / dt if dt > 0 else 0.0}
