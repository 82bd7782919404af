"""Serving: the folded network as one function ``images → boxes``, and a
dynamic micro-batching front end for it.

Mirrors ``make_serving_fn`` and ``MicroBatcher`` of
``singleshotpose_tpu/serving.py``: the same pick modes for a single object,
the same bucket and deadline policy.  Results come back to the host with
``.cpu()``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .models.darknet import DarknetSpec, apply_folded
from .ops.decode import best_boxes, decode_grid

__all__ = ["make_serving_fn", "MicroBatcher"]

# None / ("grid",) → the decoded grid; ("best",) → (B, 2K+3) best box per image
Pick = Optional[Tuple]


def make_serving_fn(spec: DarknetSpec, folded: Dict[str, Dict[str, torch.Tensor]],
                    *, pick: Pick = None, compute_dtype=torch.bfloat16):
    """The serving function ``images → boxes`` over the folded weights of
    :func:`~singleshotpose_tpu_torch.models.darknet.fold_batchnorm`.

    ``images``: NHWC, uint8 (normalized on the device) or float in [0, 1],
    a tensor or a numpy array; it runs on the device the weights are on.
    """
    if pick is not None and pick[0] not in ("grid", "best"):
        raise ValueError(f"unknown pick {pick!r}")
    K, C, nA = spec.num_keypoints, spec.num_classes, spec.num_anchors
    device = next(iter(folded.values()))["w"].device
    # a device-tensor divisor: true division on the card too, where a
    # Python-scalar divisor becomes a multiply by its reciprocal
    u8_scale = torch.full((), 255.0, device=device)

    @torch.inference_mode()
    def serve(images):
        images = torch.as_tensor(images).to(device)
        if not images.is_floating_point():
            images = images.float() / u8_scale
        head = apply_folded(spec, folded, images, compute_dtype=compute_dtype)
        decoded = decode_grid(head.float(), K, C, nA)
        if pick is None or pick[0] == "grid":
            return decoded
        return best_boxes(decoded)

    return serve


def _to_host(out):
    if isinstance(out, torch.Tensor):
        return out.cpu()
    return type(out)(*(_to_host(v) for v in out))


def _row(out, i: int):
    if isinstance(out, torch.Tensor):
        return out[i]
    return type(out)(*(_row(v, i) for v in out))


class MicroBatcher:
    """Dynamic micro-batching front end for a serving function.

    Concurrent requests are coalesced into one batch, padded to the next
    bucket size, run through the serving function, and fanned back out.  A
    batch closes when the largest bucket fills or ``max_delay_ms`` has passed
    since its first request, so a lone request waits at most
    ``max_delay_ms``.

    ``serve_fn``: ``images (B, H, W, 3) → a tensor or tuple of tensors`` with
    a leading batch dim, e.g. from :func:`make_serving_fn`; it serves every
    bucket.  The batch thread launches the work (PyTorch returns
    before the device finishes) and a resolver thread waits for the results,
    so one batch's assembly overlaps the previous batch's compute;
    ``max_in_flight`` bounds the batches launched and not yet resolved.

    Thread-safe; use as a context manager or call :meth:`close`.
    """

    _STOP = object()

    def __init__(self, serve_fn, *, height: int, width: int,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 max_delay_ms: float = 2.0, input_dtype="uint8",
                 max_in_flight: int = 2):
        self._buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self._buckets or self._buckets[0] < 1:
            raise ValueError(f"bad buckets {buckets!r}")
        self._serve = serve_fn
        self._shape = (height, width, 3)
        self._dtype = np.dtype(input_dtype)
        self._max_delay = max_delay_ms / 1e3
        self._queue: "queue.Queue" = queue.Queue()
        self._inflight: "queue.Queue" = queue.Queue(
            maxsize=max(int(max_in_flight), 1))
        self._closed = False
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="ssp-microbatcher")
        self._resolver = threading.Thread(target=self._resolve, daemon=True,
                                          name="ssp-microbatcher-resolver")
        self._thread.start()
        self._resolver.start()

    def submit(self, image) -> Future:
        """Enqueue one frame; returns a ``Future`` whose result is this
        frame's slice of the serving output."""
        if self._closed:
            raise RuntimeError("MicroBatcher is closed")
        img = np.asarray(image, self._dtype)
        if img.shape != self._shape:
            raise ValueError(f"frame shape {img.shape} != {self._shape}")
        fut: Future = Future()
        self._queue.put((img, fut))
        return fut

    def infer(self, image, timeout: Optional[float] = None):
        """Blocking one-frame inference through the batcher."""
        return self.submit(image).result(timeout)

    def _collect(self):
        """One batch: the first request blocks; then drain until the largest
        bucket fills or max_delay since the first request elapses."""
        item = self._queue.get()
        if item is self._STOP:
            return None
        batch = [item]
        deadline = time.monotonic() + self._max_delay
        max_b = self._buckets[-1]
        while len(batch) < max_b:
            remaining = deadline - time.monotonic()
            try:
                item = self._queue.get(
                    timeout=max(remaining, 0) if remaining > 0 else None,
                    block=remaining > 0)
            except queue.Empty:
                break
            if item is self._STOP:
                self._queue.put(self._STOP)   # re-post for the outer loop
                break
            batch.append(item)
        return batch

    def _worker(self):
        while True:
            batch = self._collect()
            if batch is None:
                self._inflight.put(self._STOP)
                break
            n = len(batch)
            bucket = next(b for b in self._buckets if b >= n)
            imgs = np.zeros((bucket,) + self._shape, self._dtype)
            for i, (img, _) in enumerate(batch):
                imgs[i] = img
            try:
                out = self._serve(imgs)           # launched, not awaited
            except Exception as e:     # noqa: BLE001 — fan the error out
                for _, fut in batch:
                    fut.set_exception(e)
                continue
            self._inflight.put((out, batch))      # bounded: backpressure

    def _resolve(self):
        while True:
            item = self._inflight.get()
            if item is self._STOP:
                break
            out, batch = item
            try:
                host = _to_host(out)
            except Exception as e:     # noqa: BLE001 — device-side failure
                for _, fut in batch:
                    fut.set_exception(e)
                continue
            for i, (_, fut) in enumerate(batch):
                fut.set_result(_row(host, i))

    def close(self):
        """Stop accepting requests, drain the queue, join the threads."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(self._STOP)
        self._thread.join()
        self._resolver.join()
        # reject anything racing close(): fail pending futures loudly
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not self._STOP:
                item[1].set_exception(RuntimeError("MicroBatcher closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
