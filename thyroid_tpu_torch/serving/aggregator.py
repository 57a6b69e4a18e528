"""Request aggregation (counterpart of the BatchAggregator of
thyroid_tpu/serving/engine.py, which serving/engine.py re-exports).

`BatchAggregator` coalesces single-image requests into bucket-sized
`predict` calls of an engine (an `InferenceEngine` or an export bundle's
`ExportedEngine`); it imports no model code.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import numpy as np


@dataclass
class _Pending:
    image: np.ndarray
    t: float
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[Exception] = None


class BatchAggregator:
    """Coalesce single-image requests into bucket-sized engine calls.

    Dispatch fires when `max_batch` requests are queued or the OLDEST
    pending request has waited `max_delay_ms`. `submit()` blocks the
    calling thread until its result is ready; the HTTP front end calls it
    from one thread per connection. A failing batch raises in its own
    callers only; the worker goes on."""

    def __init__(self, engine: Any, max_batch: Optional[int] = None,
                 max_delay_ms: float = 10.0):
        self.engine = engine
        self.max_batch = int(max_batch or engine.buckets[-1])
        self.max_delay = max_delay_ms / 1000.0
        self._pending: List[_Pending] = []
        self._shape = None
        self._cv = threading.Condition()
        self._stop = False
        self.batches_dispatched = 0
        self.requests_served = 0
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, image: np.ndarray, timeout: float = 30.0) -> np.ndarray:
        image = np.asarray(image, np.float32)
        if image.ndim == 2:
            image = image[..., None]
        if image.ndim != 3:
            raise ValueError(f"expected one (S, S[, C]) image, got "
                             f"shape {image.shape}")
        with self._cv:
            if self._shape is None:
                self._shape = image.shape
            elif image.shape != self._shape:
                # every coalesced request must stack: reject this one early
                # instead of failing a whole batch
                raise ValueError(f"image shape {image.shape} != aggregator "
                                 f"shape {self._shape}")
            req = _Pending(image, time.monotonic())
            self._pending.append(req)
            self._cv.notify()
        if not req.event.wait(timeout):
            raise TimeoutError("inference request timed out")
        if req.error is not None:
            raise RuntimeError(f"batched inference failed: {req.error}")
        return req.result

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._stop and not self._due_locked():
                    self._cv.wait(timeout=self.max_delay / 4 or 0.01)
                if self._stop and not self._pending:
                    return
                batch = self._pending[:self.max_batch]
                self._pending = self._pending[len(batch):]
            if not batch:
                continue
            # one bad batch must not kill the worker: a dead loop would
            # strand every queued and later submit() in TimeoutError
            try:
                probs = self.engine.predict(np.stack([r.image for r in batch]))
                self.batches_dispatched += 1
                self.requests_served += len(batch)
                for r, p in zip(batch, probs):
                    r.result = p
                    r.event.set()
            except Exception as exc:  # handed to the waiting callers
                for r in batch:
                    r.error = exc
                    r.event.set()

    def _due_locked(self) -> bool:
        if not self._pending:
            return False
        if len(self._pending) >= self.max_batch:
            return True
        return time.monotonic() - self._pending[0].t >= self.max_delay

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        self._worker.join(timeout=5.0)
