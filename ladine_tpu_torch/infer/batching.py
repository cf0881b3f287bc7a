"""Dynamic micro-batching for serving: concurrent requests coalesce into one
device call.

Counterpart of ``ladine_tpu/infer/batching.py`` (the port keeps its own
copy). Every ``Predictor.predict`` pays a fixed cost per call (the guidance
heads, the member encoders, a launch per layer and step, the host round
trip), so single-image requests waste most of the card. ``MicroBatcher``
lets many threads call ``predict``; a collector thread takes whatever
arrives within ``max_wait_ms`` (up to ``max_batch`` images), runs ONE
predict call and scatters each caller's rows back.

Batches are padded up to a bucket (powers of two up to the cap, and the cap
itself), so the card sees a handful of batch shapes instead of one per
arrival pattern; the padding rows are dropped before the scatter.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np


def _bucket(n: int, max_batch: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class MicroBatcher:
    """Thread-safe dynamic batching around a per-instance predict function.

    predict_fn: (images (B, H, W, 3)) -> dict of arrays with leading axis B.
    """

    def __init__(
        self,
        predict_fn: Callable[[np.ndarray], Dict[str, np.ndarray]],
        max_batch: int = 70,
        max_wait_ms: float = 10.0,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._fn = predict_fn
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self._lock = threading.Lock()
        self._nonempty = threading.Condition(self._lock)
        self._queue: List[dict] = []
        self._closed = False
        # how well coalescing works
        self.calls = 0
        self.requests = 0
        self.images = 0
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    @staticmethod
    def bucket_sizes(max_batch: int) -> List[int]:
        """Every batch shape the batcher can dispatch at this cap: powers of
        two up to the cap, plus the (possibly non-power-of-two) cap."""
        return sorted({_bucket(n, max_batch) for n in range(1, max_batch + 1)})

    # ------------------------------------------------------------- client

    def predict(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """Blocks until the coalesced batch holding these images has run.
        Safe to call from many threads; each caller gets only its rows."""
        images = np.asarray(images, np.float32)
        if images.ndim != 4:
            raise ValueError(f"expected (B, H, W, 3) images, got {images.shape}")
        if len(images) > self.max_batch:
            # an oversized request goes as max_batch chunks, one after another
            outs = [self.predict(images[i : i + self.max_batch])
                    for i in range(0, len(images), self.max_batch)]
            return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        item = {"images": images, "event": threading.Event(), "result": None}
        with self._nonempty:
            if self._closed:
                raise RuntimeError("MicroBatcher is closed")
            self._queue.append(item)
            self._nonempty.notify()
        item["event"].wait()
        if isinstance(item["result"], BaseException):
            raise item["result"]
        return item["result"]

    def close(self) -> None:
        with self._nonempty:
            self._closed = True
            self._nonempty.notify()
        self._worker.join(timeout=5)

    def stats(self) -> Dict[str, float]:
        return {
            "device_calls": self.calls,
            "requests": self.requests,
            "images": self.images,
            "avg_requests_per_call": self.requests / max(self.calls, 1),
        }

    # ------------------------------------------------------------- worker

    def _take_batch(self) -> Optional[List[dict]]:
        """Wait for the first request, then linger up to max_wait for
        co-riders (or until max_batch images are queued)."""
        with self._nonempty:
            while not self._queue and not self._closed:
                self._nonempty.wait()
            if self._closed and not self._queue:
                return None
            deadline = time.monotonic() + self.max_wait
            while True:
                n = sum(len(i["images"]) for i in self._queue)
                remaining = deadline - time.monotonic()
                if n >= self.max_batch or remaining <= 0 or self._closed:
                    break
                self._nonempty.wait(timeout=remaining)
            batch: List[dict] = []
            total = 0
            while self._queue and total + len(self._queue[0]["images"]) <= self.max_batch:
                item = self._queue.pop(0)
                total += len(item["images"])
                batch.append(item)
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                images = np.concatenate([i["images"] for i in batch])
                n = len(images)
                b = _bucket(n, self.max_batch)
                if b > n:  # pad to the bucket so the batch shapes stay few
                    pad = np.broadcast_to(images[-1:], (b - n,) + images.shape[1:])
                    images = np.concatenate([images, pad])
                out = self._fn(images)
                self.calls += 1
                self.requests += len(batch)
                self.images += n
                start = 0
                for item in batch:
                    k = len(item["images"])
                    item["result"] = {key: np.asarray(v[start : start + k]) for key, v in out.items()}
                    start += k
                    item["event"].set()
            except BaseException as e:  # every waiting caller gets the error
                for item in batch:
                    if item["result"] is None:
                        item["result"] = e
                        item["event"].set()
