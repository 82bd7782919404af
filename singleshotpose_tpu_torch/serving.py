"""Serving: the folded network as one function ``images → boxes``, that
function captured for one static shape, exported as a self-contained
artifact, and a dynamic micro-batching front end for any of them.

Mirrors ``make_serving_fn``, ``aot_serving``, ``export_serving``,
``save_exported``, ``load_serving`` and ``MicroBatcher`` of
``singleshotpose_tpu/serving.py``: the same pick modes, single- and
multi-object, the same bucket and deadline policy, over folded bf16 weights
or an int8 pytree (``models/quantize.py``), told apart by what the params
hold.  Where JAX compiles a serving executable ahead of time, the port
records a CUDA graph; where JAX exports StableHLO, the port writes a
``torch.export`` program.  Results come back to the host with ``.cpu()``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .data.device_augment import INV255
from .models.darknet import DarknetSpec, apply_folded
from .models.quantize import Int8Forward
from .ops.decode import (best_box_for_class, best_boxes, best_boxes_per_class,
                         decode_grid, decode_heads)
from .tracing import span

__all__ = ["make_serving_fn", "aot_serving", "export_serving", "save_exported",
           "load_serving", "MicroBatcher"]

# (pick-mode, extras):
#   None / ("grid",)            → the decoded grid
#   ("best",)                   → (B, 2K+3) best box per image
#   ("per_class", conf)         → (B, C, 2K+3) per-class best with fallback
#   ("for_class", cls, conf)    → (B, 2K+3) best box of one class
Pick = Optional[Tuple]
_PICKS = ("grid", "best", "per_class", "for_class")


def _is_quantized(params) -> bool:
    """An int8 pytree: a layer holds ``wq``
    (``singleshotpose_tpu/serving.py:53``)."""
    return any(isinstance(v, dict) and "wq" in v for v in params.values())


class _ServeModule(torch.nn.Module):
    """The body of the serving function, ``images → boxes``, as a module:
    u8 frames scaled by f32(1/255) (or float frames in [0, 1]), the folded
    bf16 forward (or the int8 forward over an int8 pytree), decode and the
    pick; a net with several [yolo] heads decodes them into one grid
    (``ops.decode.decode_heads``).  :func:`make_serving_fn` calls it
    eagerly; :func:`export_serving` exports it.  The weights, the int8 forward's scales and packed weights,
    the u8 scale and a for_class pick's class are held here, as tensors
    (not parameters or buffers), so an export bakes them in as
    constants."""

    def __init__(self, spec: DarknetSpec, folded, *, pick: Pick = None,
                 compute_dtype=torch.bfloat16,
                 scales_as_constants: bool = True, group=None):
        super().__init__()
        self.group = group
        if pick is not None and pick[0] not in _PICKS:
            raise ValueError(f"unknown pick {pick!r}")
        self.spec, self.folded = spec, folded
        self.compute_dtype = compute_dtype
        device = _device(folded)
        self.int8 = None
        if _is_quantized(folded):
            self.int8 = Int8Forward(spec, folded,
                                    scales_as_constants=scales_as_constants)
        # f32(1/255) on the device, as XLA compiles JAX's ``u8 / 255.0``;
        # held here, since the serve graphs of ``aot_serving`` read it
        self.u8_scale = torch.full((), INV255, device=device)
        if pick is not None and pick[0] == "for_class":
            # the class on the device once: a host copy in every call would
            # wait for the stream, and a CUDA graph cannot record one
            pick = (pick[0], torch.as_tensor(pick[1], dtype=torch.int64,
                                             device=device), pick[2])
        self.pick = pick

    def forward(self, images: torch.Tensor):
        spec, pick, compute_dtype = self.spec, self.pick, self.compute_dtype
        if self.int8 is not None:
            u8 = not images.is_floating_point()
            head = self.int8(images.float() if u8 else images,
                             compute_dtype=compute_dtype,
                             input_scale=INV255 if u8 else None)
        else:
            if not images.is_floating_point():
                images = images.float() * self.u8_scale
            head = apply_folded(spec, self.folded, images,
                                compute_dtype=compute_dtype, group=self.group)
        if spec.heads:
            decoded = decode_heads([h.float() for h in head],
                                   spec.num_keypoints, spec.num_classes,
                                   spec.num_anchors)
        else:
            decoded = decode_grid(head.float(), spec.num_keypoints,
                                  spec.num_classes, spec.num_anchors)
        if pick is None or pick[0] == "grid":
            return decoded
        if pick[0] == "best":
            return best_boxes(decoded)
        if pick[0] == "per_class":
            return best_boxes_per_class(decoded, pick[1])
        return best_box_for_class(decoded, pick[1], pick[2])


def make_serving_fn(spec: DarknetSpec, folded: Dict[str, Dict[str, torch.Tensor]],
                    *, pick: Pick = None, compute_dtype=torch.bfloat16,
                    scales_as_constants: bool = True, transfer: str = "rgb",
                    out_shape: Optional[Tuple[int, int]] = None, group=None):
    """The serving function ``images → boxes`` over ``folded``: the folded
    weights of :func:`~singleshotpose_tpu_torch.models.darknet.fold_batchnorm`
    (bf16 forward, the serving stem's kernel), or an int8 pytree of
    ``models.quantize`` (``quantize_folded`` / ``load_quantized``: the int8
    forward, its convs on the int8 kernel), told apart by content as JAX's
    ``make_serving_fn`` tells them.  The int8 pytree's scales and re-packed
    weights are held by this closure.

    ``images``: NHWC, uint8 (scaled on the device by f32(1/255), as JAX's
    compiled serve scales it) or float in [0, 1],
    a tensor or a numpy array; it runs on the device the weights are on.
    ``scales_as_constants`` (int8 only): round as JAX's serve compiled with
    the weights closed over (True), or as its eval driver, which passes them
    as arguments (False); ``models.quantize.apply_quantized`` has the two
    forms.

    ``transfer="yuv420"``: the function takes ``(y, cbcr)``, the frames'
    native-size u8 planes (``NativeLoader.test_batch_yuv420``), and
    converts them on the device to f32 frames at ``out_shape`` (w, h)
    before the net (``ops/yuv.yuv420_to_rgb_resized``), as JAX's eval
    forward does (``singleshotpose_tpu/drivers.py:_eval_forward``).

    ``group``: a data × model grid (``parallel.sharding.make_dp_group``
    with ``mp > 1``) whose model axis the folded weights are split over
    (``models.darknet.shard_folded``): each split conv's channels are
    gathered over the model group (``apply_folded``), so every rank of it
    returns the same boxes.  The int8 forward takes whole params and has
    no use for it.
    """
    if transfer not in ("rgb", "yuv420"):
        raise ValueError(f"unknown transfer {transfer!r}")
    if transfer == "yuv420" and out_shape is None:
        raise ValueError("transfer='yuv420' needs out_shape (w, h)")
    body = _ServeModule(spec, folded, pick=pick, compute_dtype=compute_dtype,
                       scales_as_constants=scales_as_constants, group=group)
    device = _device(folded)

    if transfer == "yuv420":
        from .ops.yuv import yuv420_to_rgb_resized
        out_w, out_h = out_shape

        @torch.inference_mode()
        def serve(y, cbcr):
            return body(yuv420_to_rgb_resized(
                torch.as_tensor(y).to(device),
                torch.as_tensor(cbcr).to(device), out_w=out_w, out_h=out_h))
    else:
        @torch.inference_mode()
        def serve(images):
            return body(torch.as_tensor(images).to(device))

    serve.int8 = body.int8
    return serve


def _device(folded: Dict[str, Dict[str, torch.Tensor]]) -> torch.device:
    """Where the weights are: every conv and connected layer, folded or
    int8, has a bias ``b``."""
    return torch.as_tensor(next(iter(folded.values()))["b"]).device


def _map(fn, out):
    """``fn`` on each tensor of a serving output: a tensor or a tuple
    (``DecodedGrid``) of them."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    return type(out)(*(_map(fn, v) for v in out))


def _bytes(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor's bytes as a flat numpy array (a view of a contiguous
    tensor)."""
    return t.reshape(-1).view(torch.uint8).numpy()


# The MicroBatchers whose threads run.  A CUDA graph capture in CUDA's
# global mode fails when another thread of the process uses the card
# meanwhile, so aot_serving refuses to capture while one runs; the set is
# the process's, as that constraint is.
_RUNNING: set = set()
_RUNNING_LOCK = threading.Lock()


def aot_serving(spec: DarknetSpec, folded: Dict[str, Dict[str, torch.Tensor]],
                *, batch: int, width: int, height: int, pick: Pick = ("best",),
                compute_dtype=torch.bfloat16, input_dtype=torch.uint8):
    """The serving function of :func:`make_serving_fn` for one static
    shape, (batch, height, width, 3) of ``input_dtype``, ready before its
    first request (``singleshotpose_tpu/serving.py:aot_serving``).

    On a card the function's body — u8 normalize, the folded forward with
    the serving stem's kernel (or, over an int8 pytree, the int8 forward
    with the int8 conv kernel), decode and the pick — is recorded once as a
    CUDA graph after a warm-up call.  Each call fills the graph's input with
    its frames, replays the graph on the current stream (counted in the
    function's ``replays``) and returns a clone of its outputs, so a later
    call cannot overwrite a result not yet read.  Nothing in a call waits
    for the card: it returns once its work is queued.

    Frames on the host (a CPU tensor or a numpy array) take a staged way in,
    counted in ``staged``, so that their copy to the card runs on the copy
    engine while the previous call's graph runs.  The function holds two
    pinned host slots and two landing slots on the card of the input's shape,
    taken in turn, and a stream of its own for the copies.  The host copies
    the frames into pinned slot ``k``, so the caller's array is free once
    the call returns; the copy stream waits for the event that says the
    graph's input has taken landing slot ``k``'s last frames, copies pinned
    ``k`` into landing ``k`` without blocking and records that the frames
    landed; the current stream waits for that and copies landing ``k`` into
    the graph's input.  Before refilling a pinned slot the host waits for
    that slot's previous copy to the card to end; ``slot_waits`` counts the
    calls that found it still running (with two calls in flight, none does).
    Frames already on the card are copied into the graph's input on the
    current stream.  While a torch profiler records, the frames' check and
    their way into the graph's input are the span ``ssp.serve.copy_in``
    (:mod:`~singleshotpose_tpu_torch.tracing`); the replay and the clone
    have none, as a range around them costs a traced call more than it
    tells.

    With the weights on the CPU the function runs eagerly on the frames
    where they are, ``ssp.serve.copy_in`` their check alone.  Either way any
    other shape or dtype raises.  Capture before a :class:`MicroBatcher`
    that serves it starts (``start=False``): it raises while any
    MicroBatcher's threads run.
    """
    serve = make_serving_fn(spec, folded, pick=pick,
                            compute_dtype=compute_dtype)
    device = _device(folded)
    shape = (batch, height, width, 3)

    def checked(images) -> torch.Tensor:
        images = torch.as_tensor(images)
        if tuple(images.shape) != shape or images.dtype != input_dtype:
            raise ValueError(
                f"this serving function takes {shape} {input_dtype}, got "
                f"{tuple(images.shape)} {images.dtype}")
        return images

    if device.type != "cuda":
        def eager(images):
            with span("ssp.serve.copy_in"):
                images = checked(images)
            return serve(images)
        return eager

    with _RUNNING_LOCK:
        if _RUNNING:
            raise RuntimeError(
                "a MicroBatcher's threads are running: a CUDA graph capture "
                "fails while another thread uses the card; capture first "
                "(MicroBatcher(..., start=False), then start())")
    static_in = torch.zeros(shape, dtype=input_dtype, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        serve(static_in)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        static_out = serve(static_in)

    pinned = [torch.empty(shape, dtype=input_dtype, pin_memory=True)
              for _ in range(2)]
    pinned_bytes = [_bytes(slot) for slot in pinned]
    landing = [torch.empty(shape, dtype=input_dtype, device=device)
               for _ in range(2)]
    copier = torch.cuda.Stream(device)
    for slot in landing:
        # written on the copy stream: freed, its memory waits for that too
        slot.record_stream(copier)
    landed = [torch.cuda.Event() for _ in range(2)]
    taken = [torch.cuda.Event() for _ in range(2)]

    def replay(images):
        with span("ssp.serve.copy_in"):
            images = checked(images)
            if images.device.type != "cpu":
                static_in.copy_(images)
            else:
                k = replay.staged % 2
                replay.staged += 1
                if not landed[k].query():
                    replay.slot_waits += 1
                    landed[k].synchronize()
                # on this thread alone: Tensor.copy_ splits a copy this size
                # over the intra-op threads, and one of them scheduled late
                # holds the call for milliseconds
                np.copyto(pinned_bytes[k], _bytes(images))
                copier.wait_event(taken[k])
                with torch.cuda.stream(copier):
                    landing[k].copy_(pinned[k], non_blocking=True)
                    landed[k].record()
                stream = torch.cuda.current_stream(device)
                stream.wait_event(landed[k])
                static_in.copy_(landing[k])
                taken[k].record(stream)
        graph.replay()
        replay.replays += 1
        return _map(torch.Tensor.clone, static_out)

    replay.replays = replay.staged = replay.slot_waits = 0
    # the graph reads tensors that only ``serve`` holds (the u8 divisor, a
    # for_class pick's class, the int8 forward's scales and packed
    # weights): freed, their memory would be reused under it
    replay.serve = serve
    return replay


def export_serving(spec: DarknetSpec, folded: Dict[str, Dict[str, torch.Tensor]],
                   *, width: int, height: int, batch: Optional[int] = None,
                   pick: Pick = ("best",), compute_dtype=torch.bfloat16,
                   input_dtype=torch.uint8) -> torch.export.ExportedProgram:
    """The serving function of :func:`make_serving_fn` as one
    ``torch.export`` program (``singleshotpose_tpu/serving.py:
    export_serving``): the weights baked in as constants, the kernels kept
    as the custom ops ``ssp::stem_conv_pool_infer`` (bf16) and
    ``ssp::int8_conv`` (an int8 pytree, its scales closed over as JAX's
    export closes over them).

    Args:
      width, height: serving resolution (stride-divisible, like any eval
        size).
      batch: fixed batch size, or ``None`` for a batch-polymorphic export
        (a symbolic leading dim: one artifact, any batch size).
      pick: box pick in the artifact (see :data:`Pick`).
      input_dtype: ``torch.uint8`` (the artifact scales internally) or a
        float dtype taking [0, 1] inputs.

    JAX's ``platforms`` has no counterpart: the program is traced on the
    device the weights are on, and :func:`load_serving` (``device=``) moves
    it to another.  Its ops dispatch by device when it runs, so a program
    exported on the CPU launches the kernels on a card.  Persist it with
    :func:`save_exported`.  A net with several [yolo] heads is not exported
    yet (``ValueError``).
    """
    spec.require_one_head("export_serving")
    body = _ServeModule(spec, folded, pick=pick, compute_dtype=compute_dtype,
                        scales_as_constants=True)
    # a symbolic batch is traced at 2: an example of 1 would specialize it
    example = torch.zeros((2 if batch is None else batch, height, width, 3),
                          dtype=input_dtype, device=_device(folded))
    dynamic = None if batch is not None else \
        ({0: torch.export.Dim("b", min=1)},)
    return torch.export.export(body, (example,), dynamic_shapes=dynamic)


def save_exported(path: str, exported: torch.export.ExportedProgram) -> None:
    """Write an export to one file: the program and its constants, the
    weights among them (``torch.export.save``)."""
    torch.export.save(exported, path)


def load_serving(path: str, device="cuda"):
    """Load a saved artifact → a callable ``images → boxes`` that takes a
    tensor or a numpy array (NHWC, of the dtype it was exported for) and
    runs on ``device``: the program is moved there by
    ``torch.export.passes.move_to_device_pass``, wherever it was exported,
    and its ops then launch that device's kernels.  The default is the
    card: without CUDA this raises rather than run on the CPU;
    ``device="cpu"`` asks for the CPU.

    Needs ``torch`` and this package's op registrations, which importing
    this module makes (the ``ssp::`` ops of ``ops/stem.py`` and
    ``ops/int8_conv.py``), but no cfg, weight file or model code: where
    JAX's artifact loads with jax alone, this one loads with torch and the
    port's ops.

    A floating input is cast to the program's float input dtype, as JAX's
    loaded artifact takes it with x64 off (a float64 numpy array runs as
    f32).
    """
    from torch.export.passes import move_to_device_pass

    from .ops import int8_conv, stem  # noqa: F401 — the ssp:: ops
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"load_serving: device {device}: CUDA is not "
                           "available (pass device='cpu' to run on the CPU)")
    program = torch.export.load(path)
    (name,) = program.graph_signature.user_inputs
    dtype = next(n.meta["val"].dtype for n in program.graph.nodes
                 if n.op == "placeholder" and n.name == name)
    module = move_to_device_pass(program, device).module()

    @torch.inference_mode()
    def serve(images):
        x = torch.as_tensor(images)
        if x.is_floating_point() and dtype.is_floating_point:
            x = x.to(dtype)
        return module(x.to(device))

    return serve


class MicroBatcher:
    """Dynamic micro-batching front end for a serving function.

    Concurrent requests are coalesced into one batch, padded to the next
    bucket size, run through the serving function, and fanned back out.  A
    batch closes when the largest bucket fills or ``max_delay_ms`` has passed
    since its first request, so a lone request waits at most
    ``max_delay_ms``.

    ``serve_fn``: ``images (B, H, W, 3) → a tensor or tuple of tensors`` with
    a leading batch dim, e.g. from :func:`make_serving_fn`, which then
    serves every bucket; or a dict ``{bucket: fn}``, e.g. from
    :func:`aot_serving` per bucket.  The batch thread launches the work
    (PyTorch returns before the device finishes) and a resolver thread waits
    for the results, so one batch's assembly overlaps the previous batch's
    compute; ``max_in_flight`` bounds the batches launched and not yet
    resolved.  The threads start at construction, or with ``start=False``
    at :meth:`start`; requests submitted before then wait in the queue.

    Thread-safe; use as a context manager (which starts it) or call
    :meth:`close`.
    """

    _STOP = object()

    def __init__(self, serve_fn, *, height: int, width: int,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16, 32),
                 max_delay_ms: float = 2.0, input_dtype="uint8",
                 max_in_flight: int = 2, start: bool = True):
        self._buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not self._buckets or self._buckets[0] < 1:
            raise ValueError(f"bad buckets {buckets!r}")
        self._fns = (dict(serve_fn) if isinstance(serve_fn, dict)
                     else {b: serve_fn for b in self._buckets})
        missing = [b for b in self._buckets if b not in self._fns]
        if missing:
            raise ValueError(f"no serve_fn for buckets {missing}")
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
        self._started = False
        if start:
            self.start()

    def start(self) -> "MicroBatcher":
        """Start the batch and resolver threads (once)."""
        if not self._started:
            with _RUNNING_LOCK:
                _RUNNING.add(self)
            self._started = True
            self._thread.start()
            self._resolver.start()
        return self

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
                out = self._fns[bucket](imgs)     # launched, not awaited
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
                host = _map(torch.Tensor.cpu, out)
            except Exception as e:     # noqa: BLE001 — device-side failure
                for _, fut in batch:
                    fut.set_exception(e)
                continue
            for i, (_, fut) in enumerate(batch):
                fut.set_result(_map(lambda t: t[i], host))

    def close(self):
        """Stop accepting requests, drain the queue, join the threads."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(self._STOP)
        if self._started:
            self._thread.join()
            self._resolver.join()
            with _RUNNING_LOCK:
                _RUNNING.discard(self)
        # reject anything racing close(): fail pending futures loudly
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not self._STOP:
                item[1].set_exception(RuntimeError("MicroBatcher closed"))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

