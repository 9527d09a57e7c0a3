"""Host-to-device staging for the serving pipeline (counterpart of
``tmr_tpu/serve/staging.py``).

One formed batch becomes a :class:`StagedBatch`: its requests are padded and stacked on
the host (a ragged tail pads up to its power-of-two sub-bucket, :func:`_pad_to`, with
zero images and a dummy exemplar; padded rows compute values that unpadding drops, real
rows are untouched), then copied to the predictor's device. The engine runs this on a
thread of its own feeding a depth-2 queue, so batch N+1's copy overlaps batch N's
compute: the counterpart of the JAX stager's ``jax.device_put`` prefetch.

On the card the stack is written into **pinned** host buffers and copied with
``non_blocking=True`` on a copy stream of the stager's own; an event recorded after the
copies is what the dispatch thread's stream waits on (:meth:`StagedBatch.wait`, which
also ``record_stream``\\ s the staged tensors to that stream, so the allocator does not
hand their memory out again before the compute that reads them is done). Each pinned
buffer is one of two per row shape, and is written again only after the copy that read
it has passed its event: depth 2, as the JAX stager's ``queue.Queue(maxsize=2)``. On the
CPU the stack is used as it is. The model holds its weights, so there are no weights to
stage per device.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tmr_tpu_torch import obs
from tmr_tpu_torch.serve.batcher import Request

#: dummy exemplar box for padded slots: any in-range box works (the rows are dropped at
#: unpad); mid-image keeps the capacity pick happy
_PAD_BOX = (0.45, 0.45, 0.55, 0.55)

#: pinned host buffers kept per row shape: one being read by a copy in flight, one being
#: written
_PINNED_DEPTH = 2


@dataclass
class StagedBatch:
    bucket: tuple
    requests: List[Request]
    device: torch.device
    images: Optional[torch.Tensor] = None  # (B, S, S, 3) f32; None for pure-hit heads
    exemplars: Optional[torch.Tensor] = None  # (B, K, 4) f32
    k_real: Optional[torch.Tensor] = None  # (B,) i32 (multi path)
    features: List[Any] = field(default_factory=list)  # heads: cached rows or None
    fill_index: List[int] = field(default_factory=list)  # heads rows needing the encoder
    padded_slots: int = 0
    t_staged: float = 0.0
    ready: Optional[torch.cuda.Event] = None  # the copies' event (on the card)

    def wait(self) -> None:
        """Order the calling thread's current stream after this batch's copies (on the
        card; nothing to do on the CPU)."""
        if self.ready is None:
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(self.ready)
        for t in (self.images, self.exemplars, self.k_real):
            if t is not None:
                t.record_stream(stream)


def _pad_to(n: int, bound: int) -> int:
    """Ragged-tail batch shape: the next power of two >= n, capped at the bucket's
    bound. A lone timeout-flushed request must not pay a full bound-sized execution, so
    tails run in power-of-two sub-buckets: at most log2(bound) extra shapes per bucket."""
    p = 1
    while p < n:
        p *= 2
    return min(max(p, 1), max(bound, n))


class DeviceStager:
    """Pads and stacks a batch on the host and starts its copies to ``device``. One
    thread stages at a time (the engine's staging thread, or its constructor's warmup
    before that thread starts)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._copy_stream: Optional[torch.cuda.Stream] = None
        #: (row shape, dtype) -> [pinned tensor, event of the copy that last read it]
        #: slots, used in turn
        self._pinned: Dict[Tuple[tuple, np.dtype], List[list]] = {}
        self._turn: Dict[Tuple[tuple, np.dtype], int] = {}

    def _host_buffer(self, shape: tuple, dtype) -> Tuple[torch.Tensor, Optional[list]]:
        """A host tensor of ``shape`` to fill (through its ``.numpy()`` view): on the
        card a pinned buffer whose previous copy has completed, with its slot (which
        takes the next copy's event); on the CPU a fresh tensor."""
        if not self._cuda:
            return torch.from_numpy(np.empty(shape, dtype)), None
        key = (tuple(shape[1:]), np.dtype(dtype))
        slots = self._pinned.setdefault(key, [])
        turn = self._turn.get(key, 0)
        self._turn[key] = (turn + 1) % _PINNED_DEPTH
        if len(slots) < _PINNED_DEPTH:
            slots.append([None, None])
        slot = slots[turn]
        buf, event = slot
        if event is not None:
            event.synchronize()  # the copy that read this buffer is done
        if buf is None or buf.shape[0] < shape[0]:
            buf = torch.from_numpy(np.empty(shape, dtype)).pin_memory()
            slot[0] = buf
        return buf[:shape[0]], slot

    def _put(self, arrays: List[Tuple[torch.Tensor, Optional[list]]]) -> tuple:
        """Copy the filled host tensors to the device: on the card, on the copy stream,
        non-blocking, with one event after them all. Returns (tensors, event)."""
        if not self._cuda:
            return [t for t, _ in arrays], None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        out = []
        with torch.cuda.stream(self._copy_stream):
            for t, _ in arrays:
                dev = torch.empty(t.shape, dtype=t.dtype, device=self.device)
                dev.copy_(t, non_blocking=True)
                out.append(dev)
        event = torch.cuda.Event()
        event.record(self._copy_stream)
        for _, slot in arrays:
            slot[1] = event
        return out, event

    def stage(self, bucket: tuple, requests: List[Request], bound: int) -> StagedBatch:
        """Pad/stack the batch on the host and start its copies; ``bound`` is the
        bucket's batch bound."""
        kind, size, _cap, k = bucket
        n = len(requests)
        bound = _pad_to(n, int(bound))
        staged = StagedBatch(bucket=bucket, requests=list(requests), device=self.device,
                             padded_slots=bound - n)
        t_assemble = time.perf_counter()
        exemplars = self._host_buffer((bound, k, 4), np.float32)
        ex = exemplars[0].numpy()
        ex[:] = _PAD_BOX
        for i, r in enumerate(requests):
            ex[i] = r.exemplars
        arrays = [exemplars]
        if kind == "heads":
            # requests with cached features move only their exemplars; promotion fills
            # move their image for the encoder, padded to a power-of-two sub-bucket too
            staged.fill_index = [i for i, r in enumerate(requests) if r.features is None]
            staged.features = [r.features for r in requests]
            rows = [requests[i].image for i in staged.fill_index]
        else:
            rows = [r.image for r in requests]
        if rows:
            images = self._host_buffer((_pad_to(len(rows), bound), size, size, 3),
                                       np.float32)
            im = images[0].numpy()
            im[len(rows):] = 0.0
            for i, img in enumerate(rows):
                im[i] = img
            arrays.append(images)
        if kind == "multi":
            k_real = self._host_buffer((bound,), np.int32)
            kr = k_real[0].numpy()
            kr[:] = 1
            for i, r in enumerate(requests):
                kr[i] = r.k_real
            arrays.append(k_real)
        t_put = time.perf_counter()
        tensors, staged.ready = self._put(arrays)
        staged.exemplars = tensors[0]
        if rows:
            staged.images = tensors[1]
        if kind == "multi":
            staged.k_real = tensors[2]
        staged.t_staged = time.perf_counter()
        if obs.tracing_enabled():
            # batch-level windows attributed to each rider: host pad/stack (assemble),
            # then the copies (stage), under the trace id each request carries
            for r in requests:
                tid = r.trace_id or None
                obs.add_span("serve.batch_assemble", t_assemble, t_put, trace_id=tid,
                             bucket=str(bucket), batch=n, padded=staged.padded_slots)
                obs.add_span("serve.stage", t_put, staged.t_staged, trace_id=tid,
                             device=str(self.device))
        return staged
