"""Batches produced on a background thread and copied to the device ahead
of the step that reads them.

Port of the JAX package's ``data/pipeline.prefetch_to_device`` (there a
thread that ``device_put``s each batch; the reference overlaps loading and
compute with DataLoader workers, train.py:157-170). A producer thread pulls
host batches from the dataset iterator, copies each numpy array to the
device from pinned memory with a non-blocking copy, and keeps up to
``depth`` (``CUDA.PREFETCH_DEPTH``) batches in flight.

On CUDA the producer works on a side stream of its own: the copies, and any
kernels the dataset launches while it makes a batch (the online backend's
flow and crops), are queued there. Each batch carries an event recorded on
that stream after it was made; the consumer's stream waits for the event
before the batch is handed out, and every tensor is marked as used on the
consumer's stream so the allocator does not recycle it early. An exception
in the producer reaches the consumer when it asks for the batch.
"""

from __future__ import annotations

import queue
import threading
from contextlib import nullcontext
from typing import Any, Dict, Iterator

import numpy as np
import torch

_END = object()


class _Error:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _to_device(batch: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(v)
            if device.type == "cuda":
                v = v.pin_memory()
        out[k] = v.to(device, non_blocking=True) if isinstance(v, torch.Tensor) else v
    return out


def prefetch_to_device(batches: Iterator[Dict[str, Any]], device,
                       depth: int = 1) -> Iterator[Dict[str, Any]]:
    """Yield the batches of ``batches`` (dicts of arrays) with every array a
    tensor on ``device``, made ``depth`` batches ahead on a producer thread
    (``depth <= 0``: made in the caller's thread, on its stream). Stopping
    early stops the producer after the batch it is making."""
    device = torch.device(device)
    if depth <= 0:
        for batch in batches:
            yield _to_device(batch, device)
        return

    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        try:
            with torch.cuda.stream(stream) if cuda else nullcontext():
                for batch in batches:
                    item = _to_device(batch, device)
                    event = None
                    if cuda:
                        event = torch.cuda.Event()
                        event.record(stream)
                    q.put((item, event))
                    if stop.is_set():
                        return
        except BaseException as e:  # handed to the consumer
            q.put(_Error(e))
            return
        q.put(_END)

    thread = threading.Thread(target=producer, name="prefetch_to_device", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, _Error):
                raise item.exc
            batch, event = item
            if cuda:
                consumer = torch.cuda.current_stream(device)
                consumer.wait_event(event)
                for v in batch.values():
                    if isinstance(v, torch.Tensor) and v.is_cuda:
                        v.record_stream(consumer)
            yield batch
    finally:
        stop.set()
        while thread.is_alive():  # unblock a producer waiting on a full queue
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
        thread.join()

