"""Training input pipeline: host batching and a background copy to the card.

Counterpart of ``vit_with_opencl_tpu/data.py``:

- :func:`memory_dataset` — epochs of shuffled host batches over in-memory
  arrays, in the JAX package's order for the same seed (NumPy's generator
  seeded with ``seed + epoch``).
- :func:`input_bin_dataset` — the reference ``input.bin`` format straight
  into the pipeline (``io/binfmt.load_image_data`` → unlabelled batches).
- :class:`DevicePrefetcher` — wraps any iterator of host batches and keeps
  ``buffer_size`` batches in flight to the device: a thread copies each
  batch into pinned host memory and issues the host-to-device copy on a
  stream of its own, so the copy of batch N+1 overlaps the step on batch N.
  The consumer's stream waits for that copy before it uses the batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

__all__ = ["memory_dataset", "input_bin_dataset", "DevicePrefetcher"]


def memory_dataset(
    images: np.ndarray,
    labels: Optional[np.ndarray],
    batch_size: int,
    *,
    epochs: Optional[int] = 1,
    shuffle: bool = True,
    seed: int = 0,
    drop_last: bool = True,
) -> Iterator[tuple]:
    """Yield ``(images, labels)`` host batches for ``epochs`` passes
    (``epochs=None`` → forever), shuffled per epoch with the seed ``seed +
    epoch`` so runs are reproducible and resumable by epoch index."""
    n = images.shape[0]
    if labels is not None and labels.shape[0] != n:
        raise ValueError(
            f"images ({n}) and labels ({labels.shape[0]}) length mismatch")
    if batch_size < 1 or (drop_last and batch_size > n):
        raise ValueError(f"batch_size {batch_size} invalid for dataset of {n}")
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
        stop = n - batch_size + 1 if drop_last else n
        for lo in range(0, max(stop, 0), batch_size):
            idx = order[lo:lo + batch_size]
            yield images[idx], None if labels is None else labels[idx]
        epoch += 1


def input_bin_dataset(path: str, batch_size: int, **kw) -> Iterator[tuple]:
    """Reference ``input.bin`` → unlabelled host batches (labels None)."""
    from .io import binfmt

    return memory_dataset(binfmt.load_image_data(path), None, batch_size, **kw)


_STOP = object()


class DevicePrefetcher:
    """Iterate device-resident batches, keeping ``buffer_size`` in flight.

    A daemon thread pulls host batches (tuples of arrays or None) from
    ``source``, pins each array and starts its copy to ``device`` (default
    the card, which must be there) on the thread's own CUDA stream, then
    parks the batch with the copy's event in a bounded queue. ``next()``
    makes the current stream wait for that event, so the batch is ready
    when the step uses it. On ``device="cpu"`` the batches are plain
    tensors. An exception in the source is raised by ``next()``;
    ``close()`` stops the thread.
    """

    def __init__(self, source: Iterable, *, buffer_size: int = 2,
                 device=None):
        if buffer_size < 1:
            raise ValueError(f"buffer_size must be >= 1, got {buffer_size}")
        from .engine import resolve_device

        self._stop = threading.Event()
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._q: queue.Queue = queue.Queue(maxsize=buffer_size)
        self._thread = threading.Thread(target=self._run, args=(iter(source),),
                                        daemon=True)
        self._thread.start()

    def _to_device(self, a):
        if a is None:
            return None
        t = torch.as_tensor(np.ascontiguousarray(a))
        if not self._cuda:
            return t.to(self.device)
        return t.pin_memory().to(self.device, non_blocking=True)

    def _put_batch(self, batch):
        if not self._cuda:
            return tuple(self._to_device(a) for a in batch), None
        stream = self._stream
        with torch.cuda.stream(stream):
            out = tuple(self._to_device(a) for a in batch)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def _put_or_stop(self, item) -> bool:
        """A bounded put that honours the stop flag (a blocking put on a
        full queue after the consumer stopped would leak the thread and the
        batches it holds)."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, it):
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
                self._stream = torch.cuda.Stream(self.device)
            for batch in it:
                if self._stop.is_set():
                    return
                if not self._put_or_stop(self._put_batch(batch)):
                    return
            self._put_or_stop(_STOP)
        except BaseException as e:  # noqa: BLE001 — raised by the consumer
            self._put_or_stop(e)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive() and self._q.empty():
                    raise StopIteration
        if item is _STOP:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        batch, event = item
        if event is not None:
            torch.cuda.current_stream(self.device).wait_event(event)
            for t in batch:  # the allocator must not reuse them early
                if t is not None:
                    t.record_stream(torch.cuda.current_stream(self.device))
        return batch

    def close(self):
        self._stop.set()

    def __del__(self):  # pragma: no cover — best-effort cleanup
        self._stop.set()
