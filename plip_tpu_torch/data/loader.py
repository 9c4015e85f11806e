"""Host-to-device input pipeline: the port of ``plip_tpu.data.loader``.

A thread pool loads and transforms items (PIL's decode releases the
interpreter lock), batches are stacked as host numpy with the last one
zero-padded to the static batch size (the true count is returned beside
it), and with a CUDA ``device`` each array goes through pinned host memory
to the card with a non-blocking copy, ``PREFETCH`` batches ahead of the
consumer. Strings (captions) stay host lists. ``collate=`` replaces the
stacking (the embedders' images of many sizes stay a list).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.profiling import span

PREFETCH = 2  # batches in flight ahead of the consumer


class PrefetchLoader:
    """Iterate ``(batch, count)`` over an indexable dataset of numpy items
    (or tuples of them). ``device``: where arrays go (``None``: host numpy).
    ``collate(items, batch_size)``: a batch from its items (default: stacked
    and zero-padded)."""

    def __init__(self, dataset, batch_size: int, num_workers: int = 8, device=None,
                 collate: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.device = None if device is None else torch.device(device)
        self.collate = collate or _collate

    def _to_device(self, x):
        if not isinstance(x, np.ndarray) or self.device is None:
            return x
        t = torch.from_numpy(x)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def __iter__(self) -> Iterator[Tuple]:
        n, bs = len(self.dataset), self.batch_size
        out_q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """Bounded put that gives up once the consumer has gone."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for start in range(0, n, bs):
                        if stop.is_set():
                            return
                        idxs = list(range(start, min(start + bs, n)))
                        batch = self.collate(list(pool.map(self.dataset.__getitem__, idxs)),
                                             bs)
                        if isinstance(batch, tuple):
                            batch = tuple(self._to_device(c) for c in batch)
                        else:
                            batch = self._to_device(batch)
                        if not put_or_stop((batch, len(idxs))):
                            return
                put_or_stop(None)
            except BaseException as e:  # handed to the consumer, which raises it
                put_or_stop(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                with span("loader.wait"):
                    item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


def _collate(items: Sequence, batch_size: int):
    """Stack items (arrays or tuples of arrays/scalars/strings); zero-pad to
    ``batch_size``."""
    if isinstance(items[0], tuple):
        return tuple(_collate_column(c, batch_size) for c in zip(*items))
    return _collate_column(items, batch_size)


def _collate_column(col, batch_size: int):
    if isinstance(col[0], (np.ndarray, int, np.integer, float, np.floating)):
        arr = np.stack(col) if isinstance(col[0], np.ndarray) else np.asarray(col)
        if arr.shape[0] < batch_size:
            pad = np.zeros((batch_size - arr.shape[0],) + arr.shape[1:], arr.dtype)
            arr = np.concatenate([arr, pad])
        return arr
    return list(col)
