"""Host -> device prefetch (port of ``data/prefetch.py``).

- ``prefetch(iterator, buffer_size, transfer)``: a background thread runs
  the host iterator (decoding, batching) and ``transfer`` on each batch
  while the consumer works on the previous ones; an error in the producer
  is raised in the consumer.
- ``frame_chunks(...)``: a sequence's frames decoded in fixed-size chunks
  by the native loader (``native_io.load_batch``), converted to gray, the
  tail padded by repeating the last frame with ``count`` the real number,
  and streamed to ``device``.

``PinnedTransfer`` is the transfer to a CUDA device: each host batch is
copied into a pinned buffer, then to the card with ``non_blocking=True``
on a side stream; the consumer's stream waits on the copy's event before
it touches the chunk, and a pinned buffer is refilled only after its last
copy has finished. On the CPU the transfer is the identity (the numpy
arrays become tensors that share their memory).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch


def prefetch(iterator: Iterable, buffer_size: int = 2, transfer: Optional[Callable] = None) -> Iterator:
    """Yield ``transfer(item)`` for each item of ``iterator``, computed by a
    background thread at most ``buffer_size`` items ahead."""
    transfer = transfer or (lambda item: item)
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    end = object()
    err: list = []

    def producer():
        try:
            for item in iterator:
                q.put(transfer(item))
        except BaseException as e:  # raised again in the consumer
            err.append(e)
        finally:
            q.put(end)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is end:
            break
        yield item
    t.join()
    if err:
        raise err[0]


class PinnedTransfer:
    """Host batch (a dict of numpy arrays and scalars) -> the same dict
    with tensors on ``device``, through pinned buffers and a side stream
    (see the module docstring). ``pinned_copies`` counts the arrays that
    went to the card from a pinned buffer; ``yield_ready`` makes the
    caller's current stream wait for a batch's copy."""

    def __init__(self, device: torch.device, slots: int):
        self.device = torch.device(device)
        self.slots = [dict() for _ in range(slots)]
        self.events: list = [None] * slots
        self.next = 0
        self.pinned_copies = 0
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def __call__(self, batch: dict) -> dict:
        if self.stream is None:
            return {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}
        slot = self.next
        self.next = (slot + 1) % len(self.slots)
        if self.events[slot] is not None:
            self.events[slot].synchronize()  # the buffers' last copy has landed
        buffers, out = self.slots[slot], {}
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                if not isinstance(v, np.ndarray):
                    out[k] = v
                    continue
                src = torch.from_numpy(v)
                buf = buffers.get(k)
                if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
                    buf = buffers[k] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
                buf.copy_(src)
                self.pinned_copies += int(buf.is_pinned())
                out[k] = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
        out["_event"] = event
        return out

    @staticmethod
    def yield_ready(batch: dict) -> dict:
        """``batch`` without its event, once the current stream waits on it;
        its tensors are marked as used on that stream."""
        event = batch.pop("_event", None)
        if event is not None:
            stream = torch.cuda.current_stream()
            stream.wait_event(event)
            for v in batch.values():
                if isinstance(v, torch.Tensor):
                    v.record_stream(stream)
        return batch


def frame_chunks(
    rgb_paths,
    depth_paths,
    chunk: int = 16,
    width: int = 640,
    height: int = 480,
    depth_scale: float = 5000.0,
    num_threads: int = 8,
    to_gray: bool = True,
    buffer_size: int = 2,
    device: str | torch.device = "cuda",
    transfer: Optional[PinnedTransfer] = None,
):
    """Stream a sequence's frames to ``device`` in chunks of ``chunk``.

    Yields dicts {'gray' (C, H, W) or 'rgb' (C, H, W, 3), 'depth' (C, H, W):
    float32 tensors on ``device``, 'count': np.int32}; the last chunk is
    padded by repeating its last frame, and 'count' gives its real number
    of frames. ``transfer`` (default: a new ``PinnedTransfer``) may be
    passed to read its ``pinned_copies`` afterwards."""
    from . import native_io

    n = len(rgb_paths)
    transfer = transfer or PinnedTransfer(device, buffer_size + 2)

    def host_chunks():
        for start in range(0, n, chunk):
            rp = list(rgb_paths[start : start + chunk])
            dp = list(depth_paths[start : start + chunk])
            count = len(rp)
            while len(rp) < chunk:  # pad the tail
                rp.append(rp[-1])
                dp.append(dp[-1])
            rgb, depth = native_io.load_batch(
                rp, dp, width=width, height=height, depth_scale=depth_scale, num_threads=num_threads,
            )
            out = {"depth": depth, "count": np.int32(count)}
            if to_gray:
                out["gray"] = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
            else:
                out["rgb"] = rgb
            yield out

    for batch in prefetch(host_chunks(), buffer_size=buffer_size, transfer=transfer):
        yield PinnedTransfer.yield_ready(batch)
