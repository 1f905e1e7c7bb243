"""Host -> device staging with background prefetch (port of
``vae_hmc_tpu.io.staging``, plus the pinned copy to the device).

For file-backed sources, host decode (wav/mp3 -> PCM -> resample) and
device compute (STFT -> mel -> ...) would be serial in a naive loop; a
background thread decodes batch i+1..i+depth while the device processes
batch i (the reference decodes strictly serially per track,
scripts/06:92-141).  ``to_device`` copies a host batch through page-locked
memory with ``non_blocking=True``, so the copy queues behind the device's
work instead of waiting for it.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Sequence, Tuple

import numpy as np
import torch


def prefetch_batches(
    produce: Callable[[Sequence[int]], object],
    index_batches: Sequence[Sequence[int]],
    depth: int = 2,
) -> Iterator[Tuple[Sequence[int], object]]:
    """Yield (idx_batch, produce(idx_batch)) with `depth` batches produced
    ahead on a background thread.  Exceptions propagate to the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _SENTINEL = object()

    def worker():
        try:
            for idx in index_batches:
                q.put((idx, produce(idx)))
        except BaseException as e:      # propagate to consumer
            q.put((_SENTINEL, e))
            return
        q.put((_SENTINEL, None))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        idx, payload = q.get()
        if idx is _SENTINEL:
            if payload is not None:
                raise payload
            return
        yield idx, payload


def batched_indices(n: int, batch: int) -> List[List[int]]:
    return [list(range(s, min(s + batch, n))) for s in range(0, n, batch)]


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on `device`: through page-locked memory and a
    non-blocking copy for a CUDA device (the caching host allocator keeps
    the page-locked block until the copy is done), as is for the CPU."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
