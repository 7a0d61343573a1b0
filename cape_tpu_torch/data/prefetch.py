"""Background-thread batch prefetcher, the port of `cape_tpu.data.prefetch`.

A single daemon thread assembles the next fixed-shape episode batches (PNG
decode, crop, resize, tokenize — GIL-releasing numpy/cv2 work) while the
consumer decodes the current one, and with `transform=to_device` it also
copies them to the card.

That build overlaps the decode; the copy does not. It is a blocking copy
from pageable memory on the legacy default stream, so it queues behind
the kernels the consumer has launched, which is correct but serial.
Pinned memory with `non_blocking=True` on a stream of its own would also
need a CUDA event that the consumer waits on before it reads the batch;
that is left for a performance change.

Spans (`trace`): `prefetch.build` (the producer's `next(iterable)`),
`prefetch.copy` (its `transform`) and `prefetch.wait` (the consumer
blocked on the queue).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Mapping, Optional

import numpy as np
import torch

from .. import trace
from ..device import DeviceLike, resolve_device


def _stack(items):
    """Stack a list of equally-shaped nested dicts leaf by leaf."""
    if isinstance(items[0], Mapping):
        return {k: _stack([it[k] for it in items]) for k in items[0]}
    return np.stack(items)


def stack_batches(iterable: Iterable, n: int) -> Iterator:
    """Group every `n` consecutive batch dicts into one stacked dict.

    Each leaf gains a leading (n,) axis — the micro-step axis consumed by
    `train.make_scan_train_step`. A final incomplete group is DROPPED (a
    different leading dim would change the step's shapes); callers size
    their epoch to a multiple of `n`.
    """
    group = []
    for item in iterable:
        group.append(item)
        if len(group) == n:
            yield _stack(group)
            group = []


def to_device(batch, device: DeviceLike = None):
    """A batch (nested dicts of numpy arrays) as tensors on `device` (the
    card unless the caller asks for the CPU). Every leaf is copied, so a
    tensor never shares memory with a dataset's cached, read-only record
    arrays."""
    dev = resolve_device(device)
    if isinstance(batch, Mapping):
        return {k: to_device(v, dev) for k, v in batch.items()}
    return torch.tensor(np.asarray(batch), device=dev)


def prefetch(iterable: Iterable, buffer_size: int = 2,
             transform: Optional[Callable] = None) -> Iterator:
    """Iterate `iterable` on a daemon thread, `buffer_size` items ahead.

    `transform` (e.g. `to_device`) runs on the producer thread, after the
    build of the item it transforms (see the module docstring for what a
    copy to the card overlaps). An exception raised by
    the producer (in `iterable` or `transform`) is re-raised to the
    consumer after the items before it.
    """
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    sentinel = object()
    error: list = []

    def producer():
        try:
            items = iter(iterable)
            while True:
                with trace.span("prefetch.build"):
                    item = next(items, sentinel)
                if item is sentinel:
                    break
                if transform is not None:
                    with trace.span("prefetch.copy"):
                        item = transform(item)
                q.put(item)
        except BaseException as e:  # propagate to consumer
            error.append(e)
        finally:
            q.put(sentinel)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        with trace.span("prefetch.wait"):
            item = q.get()
        if item is sentinel:
            if error:
                raise error[0]
            return
        yield item
