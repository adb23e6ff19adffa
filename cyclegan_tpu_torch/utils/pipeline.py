"""Depth-bounded inference pipeline: enqueue batch k+1 before fetching k.

Counterpart of ``cyclegan_tpu/utils/pipeline.py``. PyTorch launches CUDA
work asynchronously, so a prediction returns while the device still
computes; holding the device tensor and fetching it only after the next
batch is enqueued lets the card compute batch k+1 while the host writes
batch k's PNGs. Results are consumed strictly in submission order, so the
output equals the serial loop's; only the fetch point moves. The fetch is
``.cpu()``, which waits for that tensor alone; there is no per-batch
``synchronize``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch


class InferencePipeline:
    """Order-preserving bounded queue of in-flight device results.

    ``put(payload, device_result)`` enqueues a device tensor with its
    host-side payload; whenever more than ``depth`` results are pending the
    oldest is fetched to a numpy array and handed to
    ``consume(payload, fetched)``. ``flush()`` drains everything.
    """

    def __init__(self, consume: Callable[[Any, np.ndarray], None], depth: int = 1) -> None:
        self._consume = consume
        self.depth = max(0, depth)
        self._pending: list[tuple[Any, torch.Tensor]] = []

    def put(self, payload: Any, device_result: torch.Tensor) -> None:
        self._pending.append((payload, device_result))
        self._drain(self.depth)

    def flush(self) -> None:
        self._drain(0)

    def _drain(self, limit: int) -> None:
        while len(self._pending) > limit:
            payload, dev = self._pending.pop(0)
            self._consume(payload, dev.cpu().numpy())
