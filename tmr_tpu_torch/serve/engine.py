"""ServeEngine: throughput-oriented serving over the ``Predictor``'s bucketed programs
(counterpart of ``tmr_tpu/serve/engine.py``, the unsharded one-device engine).

Pipeline (one thread per stage, bounded queues between them):

    submit() -> [result cache / in-flight coalescing / feature routing]
        -> MicroBatcher (dynamic micro-batching under max_wait_ms)
        -> staging thread (pad + stack into pinned buffers, copies on a copy stream,
           depth-2 queue = double-buffered prefetch)
        -> dispatch thread (the bucket's program, launched after the copies' event)
        -> completion thread (one device-to-host copy per batch into pinned memory and
           one event wait, unpad, resolve futures, populate caches)

Contracts:

- **Exactness**: a served request's detections equal the same ``Predictor`` program run
  on the engine's padded stack bit for bit: padded rows are dropped, real rows are
  untouched. Whether they also equal a sequential B = 1 call depends on the library
  calls inside the model, which may pick other algorithms at other batch sizes (on the
  CPU the decoder's 3x3 convolutions do; on the card cuDNN's convolutions do at some
  batch sizes); the port's own kernels work per plane and do not.
- **Isolation**: a request that cannot be served fails only its own future. Malformed
  requests are rejected at submit; a batch-level failure falls back to per-request
  execution. A CUDA error is sticky, so that fallback cannot recover a poisoned context.
- **Device**: everything runs on the predictor's device (``cuda`` unless it was built
  with ``device="cpu"``); the engine never moves work to another device.
- **Observable**: every counter lives in a per-engine metrics registry (``stats()``
  keeps the JAX engine's shape; ``metrics_snapshot()`` is the metrics_report/v1 view),
  and with ``TMR_TRACE=1`` each request's trace id follows it through spans for all
  seven pipeline stages (submit, queue_wait, batch_assemble, stage, execute,
  postprocess, resolve).

``attach_gallery`` / ``search_gallery`` serve a standing pattern bank
(``serve/gallery.GalleryBank``) beside the request pipeline. Two hooks are ported from
the JAX engine: ``submit(..., features=)``, which stream sessions (``serve/streams.py``)
use to run a frame's heads on its anchor's features, and ``feature_client=``, the
disaggregated feature tier (``serve/feature_tier.py``), whose remote features feed the
heads-only programs; frames the tier cannot serve run locally, on the same device
through the same programs, counted.

Not ported, refused by name where the JAX engine has them: mesh serving (``mesh=``,
``TMR_SERVE_MESH``, more than one device), ROADMAP A7; the live tuner
(``attach_live_tuner``) and the measured batch bound, ROADMAP A8. ``aot=`` has no
counterpart (no jit): ``warmup_buckets=`` runs each padded shape of each bucket once,
which builds the kernels and lets cuDNN pick its algorithms. ``donate=True`` (XLA buffer
donation) has no eager counterpart and raises.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from tmr_tpu_torch import obs
from tmr_tpu_torch.diagnostics import HEALTH_REPORT_SCHEMA
from tmr_tpu_torch.obs.metrics import MetricsRegistry
from tmr_tpu_torch.serve.admission import AdmissionController, RejectedError, class_weight_fn
from tmr_tpu_torch.serve.batcher import MicroBatcher, Request
from tmr_tpu_torch.serve.caches import LRUCache, array_digest
from tmr_tpu_torch.serve.degrade import DegradeController, downscale_image
from tmr_tpu_torch.serve.staging import _PAD_BOX, DeviceStager, StagedBatch, _pad_to

_DET_FIELDS = ("boxes", "scores", "refs", "valid")

#: the engine's counter names, ``serve.<name>`` in its registry
_COUNTER_NAMES = (
    "submitted", "completed", "errors", "rejected", "coalesced",
    "batches", "padded_slots", "batch_fallbacks", "heads_batches",
    "feature_fills",
)


def _det_fields(dets: dict) -> tuple:
    """The detection keys to copy to the host: the fixed four, plus the device tail's
    ``count`` when the program made one (``decode_tail="device"``)."""
    return _DET_FIELDS + (("count",) if "count" in dets else ())


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported to tmr_tpu_torch (ROADMAP {item})")


class ServeEngine:
    """Batched, cached request serving for one Predictor on its device.

    Parameters
    ----------
    predictor: a ``tmr_tpu_torch.inference.Predictor`` whose weights were set
        (``init_params``, ``load_state_dict`` or ``load_jax_params``).
    batch: per-bucket coalescing bound. None resolves ``TMR_SERVE_BATCH`` -> 4.
    max_wait_ms: latency bound a lone request waits for batch-mates
        (None -> ``TMR_SERVE_MAX_WAIT_MS``, default 10).
    devices: None, or a list holding the predictor's device alone.
    exemplar_cache / feature_cache: LRU capacities (None -> ``TMR_SERVE_EXEMPLAR_CACHE``
        (default 256) / ``TMR_SERVE_FEATURE_CACHE`` (default 8); 0 disables);
        ``TMR_SERVE_FEATURE_CACHE_MB`` adds a byte bound to the feature cache.
    admission / degrade / watch: controllers (default: from their env knobs, off).
    warmup_buckets: ``Predictor.bucket_key`` tuples to run once per padded shape at
        construction.
    feature_client: optional disaggregated match tier (``serve/feature_tier.py``): an
        object with ``holds(size)`` and ``fetch(image, digest, size)``. Single-exemplar
        requests whose size partition has a live feature worker run the heads-only
        programs on remotely extracted features; frames with no holder, and rows whose
        fetch fails, run locally on this engine's device, counted
        (``feature_tier.cold_frames`` / ``feature_tier.fallback_frames``; the remote ones
        ``feature_tier.remote_frames``), and their futures always resolve.
    """

    def __init__(self, predictor, *, batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 devices: Optional[Sequence[Any]] = None,
                 exemplar_cache: Optional[int] = None,
                 feature_cache: Optional[int] = None,
                 donate: Optional[bool] = None,
                 admission: Optional[AdmissionController] = None,
                 degrade: Optional[DegradeController] = None,
                 watch: Optional[Any] = None,
                 mesh: Optional[str] = None,
                 warmup_buckets: Optional[Sequence[tuple]] = None,
                 feature_client: Optional[Any] = None):
        if not getattr(predictor, "weights_set", False):
            raise RuntimeError("predictor has no weights set (init_params, "
                               "load_state_dict or load_jax_params)")
        spec = os.environ.get("TMR_SERVE_MESH", "") if mesh is None else mesh
        if (spec or "").strip() not in ("", "0", "off", "none"):
            _refuse(f"mesh serving (mesh={spec!r} / TMR_SERVE_MESH)", "A7")
        if donate:
            raise ValueError("donate=True: XLA buffer donation has no eager counterpart")
        self._pred = predictor
        self.device = torch.device(predictor.device)
        if devices is not None:
            devices = [torch.device(d) for d in devices]
            if len(devices) > 1:
                _refuse(f"serving on {len(devices)} devices (devices=)", "A7")
            if devices and (devices[0].type, devices[0].index or 0) != (
                    self.device.type, self.device.index or 0):
                raise ValueError(f"devices={devices}: the engine runs on its predictor's "
                                 f"device, {self.device}")
        self.devices = [self.device]
        self._cuda = self.device.type == "cuda"
        self._explicit_batch = batch
        self.max_wait_ms = (_env_float("TMR_SERVE_MAX_WAIT_MS", 10.0)
                            if max_wait_ms is None else float(max_wait_ms))
        #: per-engine metrics registry: every counter the engine and its caches keep
        self.metrics = MetricsRegistry()
        self.result_cache = LRUCache(
            _env_int("TMR_SERVE_EXEMPLAR_CACHE", 256)
            if exemplar_cache is None else exemplar_cache,
            registry=self.metrics, name="serve.cache.result",
        )
        feat_mb = _env_float("TMR_SERVE_FEATURE_CACHE_MB", 0.0)
        self.feature_cache = LRUCache(
            _env_int("TMR_SERVE_FEATURE_CACHE", 8)
            if feature_cache is None else feature_cache,
            registry=self.metrics, name="serve.cache.feature",
            max_bytes=int(feat_mb * (1 << 20)) if feat_mb > 0 else None,
        )
        # image digests seen once: the second sighting promotes the image into the
        # feature cache (cold traffic stays on the fused path)
        self._seen = LRUCache(max(4 * self.feature_cache.capacity, 16))
        #: feature-cache key provenance: (weights digest, backbone formulation); a
        #: predictor without the stamp keys on the image alone, as in the JAX engine
        fstamp = getattr(predictor, "feature_stamp", None)
        self._feat_stamp = tuple(fstamp()) if callable(fstamp) else ()
        #: the disaggregated match tier (serve/feature_tier.py); None keeps every routing
        #: decision as before
        self._feature_client = feature_client

        self._batch_bounds: Dict[int, int] = {}
        self._lock = threading.Lock()
        self._inflight: Dict[tuple, Request] = {}
        self._gallery: Optional[Any] = None
        self._closed = False
        self._t_start = time.time()
        self._watch = obs.HealthWatch() if watch is None else watch
        self._admission = AdmissionController() if admission is None else admission
        self._degrade = DegradeController() if degrade is None else degrade
        #: default per-request deadline (TMR_SERVE_DEADLINE_MS; 0/unset = none)
        self._default_deadline_ms = _env_float("TMR_SERVE_DEADLINE_MS", 0.0)
        #: close() drain bound (TMR_SERVE_DRAIN_TIMEOUT_S)
        self._drain_timeout_s = _env_float("TMR_SERVE_DRAIN_TIMEOUT_S", 300.0)
        self._drain_timed_out = False
        #: overload counters (admission rejections, sheds, degrade steps), created on
        #: their first event so the default metrics and stats shapes stay the JAX ones
        self._mx: Dict[str, Any] = {}
        # compile events before this engine existed must not fire a storm on the
        # first health() pass: a sequence cursor, not a list offset
        self._compile_seen = obs.compile_event_seq()
        self._heartbeat = None
        self._m = {name: self.metrics.counter(f"serve.{name}") for name in _COUNTER_NAMES}
        self._lat = self.metrics.histogram("serve.request_latency_s")
        self._per_device: Dict[str, int] = {}
        self._warmup_stats: Optional[Dict[str, Any]] = None
        stamp = getattr(predictor, "quant_stamp", None)
        self._quant_stamp = stamp() if callable(stamp) else None
        #: device-to-host side of the completion thread: its stream and pinned buffer
        self._d2h_stream: Optional[torch.cuda.Stream] = None
        self._d2h_buf: Optional[torch.Tensor] = None

        self._batcher = MicroBatcher(self.max_wait_ms, self._bound_for,
                                     class_weight=class_weight_fn())
        self._stager = DeviceStager(self.device)
        self._staged_q: "queue.Queue" = queue.Queue(maxsize=2)
        self._done_q: "queue.Queue" = queue.Queue(maxsize=2)
        #: the constructing thread's intra-op thread count: OpenMP keeps it per
        #: thread, and the CPU kernels' sums follow it, so the pipeline threads run
        #: under the caller's
        self._torch_threads = torch.get_num_threads()
        self._threads = [
            threading.Thread(target=self._thread_main, args=(loop,), name=name,
                             daemon=True)
            for loop, name in ((self._stage_loop, "serve-stage"),
                               (self._dispatch_loop, "serve-dispatch"),
                               (self._complete_loop, "serve-complete"))
        ]
        if warmup_buckets:
            self._warmup(warmup_buckets)
        for t in self._threads:
            t.start()

    # -------------------------------------------------------------- gallery
    def attach_gallery(self, gallery: Any) -> None:
        """Arm :meth:`search_gallery` with a pattern-search backend: any object with
        ``search(image) -> {name: dets}``, such as a ``serve.gallery.GalleryBank`` (built
        with ``feature_cache=engine.feature_cache``, it shares the engine's frame
        features under the same ``feature_stamp`` keys). Detached, nothing changes."""
        with self._lock:
            self._gallery = gallery

    def search_gallery(self, image, **kw) -> Dict[str, dict]:
        """Match every registered pattern against one frame through the attached backend,
        counted as ``serve.gallery.searches``; RuntimeError when none is attached."""
        with self._lock:
            gallery = self._gallery
        if gallery is None:
            raise RuntimeError("no gallery attached (ServeEngine.attach_gallery)")
        self.metrics.counter("serve.gallery.searches").inc()
        return gallery.search(image, **kw)

    # ------------------------------------------------- refused (not ported)
    def attach_live_tuner(self, tuner: Any) -> bool:
        _refuse("continuous autotune (attach_live_tuner)", "A8")

    # -------------------------------------------------------------- sizing
    def _bound_for(self, bucket: tuple) -> int:
        """Coalescing bound of a bucket: explicit ``batch=`` > ``TMR_SERVE_BATCH`` > 4.
        (The JAX engine puts the measured bench-sweep winner before the default 4; that
        step comes with the measurement plane, ROADMAP A8.)"""
        size = bucket[1]
        with self._lock:
            if size in self._batch_bounds:
                return self._batch_bounds[size]
        if self._explicit_batch is not None:
            bound = int(self._explicit_batch)
        else:
            bound = _env_int("TMR_SERVE_BATCH", 0) or 4
        bound = max(1, bound)
        with self._lock:
            self._batch_bounds[size] = bound
        return bound

    def _feature_key(self, digest: str, size: int) -> tuple:
        """The feature-cache key of one frame: image digest, size and the predictor's
        stamp, so reuse never crosses a weights or formulation change."""
        return (digest, size) + self._feat_stamp

    def _count(self, name: str, n: int = 1) -> None:
        """Overload counters (``serve.<name>``), created on their first event."""
        with self._lock:
            c = self._mx.get(name)
            if c is None:
                c = self._mx[name] = self.metrics.counter(f"serve.{name}")
        c.inc(n)

    # -------------------------------------------------------------- warmup
    def _warmup(self, buckets) -> None:
        """Run each padded shape (the power-of-two ladder up to the bound) of each
        declared bucket once on zero inputs, so serving never meets a first call; the
        heads buckets warm through their fill traffic."""
        t0 = time.perf_counter()
        stats = {"programs": 0, "skipped": 0, "wall_s": 0.0}
        for bucket in buckets:
            kind, size, cap, k = bucket
            if kind == "heads":
                continue
            bound = self._bound_for(bucket)
            shapes = sorted({_pad_to(n, bound) for n in range(1, bound + 1)})
            for shape in shapes:
                reqs = [Request(image=np.zeros((size, size, 3), np.float32),
                                exemplars=np.tile(np.asarray(_PAD_BOX, np.float32), (k, 1)),
                                bucket=bucket) for _ in range(shape)]
                staged = self._stager.stage(bucket, reqs, shape)
                out, _ = self._run_batch(staged)
                if self._cuda:
                    torch.cuda.synchronize(self.device)
                del out
                stats["programs"] += 1
        stats["wall_s"] = round(time.perf_counter() - t0, 3)
        self._warmup_stats = stats

    # -------------------------------------------------------------- submit
    def submit(self, image, exemplars, multi: bool = False,
               k_real: Optional[int] = None, priority: int = 0,
               deadline_ms: Optional[float] = None,
               features: Optional[Any] = None) -> Future:
        """Enqueue one request; returns a Future resolving to the fixed-slot detections
        dict (numpy, leading dim 1; treat it as read-only, results may be shared with
        the cache).

        ``priority`` is the request's class (higher = scheduled sooner under the class
        weighting; admission bounds apply per class). ``deadline_ms`` bounds the
        request's useful lifetime from this call: a request still unserved past it is
        shed by the next pipeline stage (its future raises RejectedError cause
        "deadline"). None -> ``TMR_SERVE_DEADLINE_MS`` (unset = no deadline). Identical
        concurrent requests coalesce into one group that inherits the earliest deadline
        and the highest class of its riders.

        ``features`` is the stream sessions' reuse hook (``serve/streams.py``): this
        frame's precomputed (1, h, w, C) encoder features (an array or a tensor, moved to
        the engine's device). The request skips the encoder (the heads-only program), and
        its result, cache entry included, carries ``degrade_steps: ["temporal_reuse"]``
        under a result-cache key of its own, so a reused answer is never served to a
        frame-independent query. Single-exemplar requests only.

        A request that cannot be served (bad shapes, an exemplar needing a template
        bucket beyond cfg.template_buckets, ...) fails only its own future; a request
        the admission controller bounces fails with a :class:`RejectedError`."""
        fut: Future = Future()
        if self._closed:
            fut.set_exception(RuntimeError("engine is closed"))
            return fut
        rej = self._admission.try_admit(priority)
        if rej is not None:
            self._count("admit_rejected")
            self._count(f"admit_rejected.{rej.cause}")
            fut.set_exception(rej)
            return fut
        tid = obs.new_trace_id() if obs.tracing_enabled() else ""
        with obs.span("serve.submit", trace_id=tid or None):
            try:
                req = self._make_request(image, exemplars, multi, k_real, fut, tid,
                                         priority, deadline_ms, features)
            except Exception as e:  # isolation: reject this request alone
                self._admission.release_class(priority)
                self._m["rejected"].inc()
                fut.set_exception(e)
                return fut
            if req is None:  # resolved from cache / coalesced: the slot frees now
                self._admission.release_class(priority)
                return fut
            req.admitted = self._admission.enabled
            try:
                self._batcher.put(req)
            except Exception as e:  # closed mid-submit: a rejection, not traffic
                self._drop_inflight(req)
                self._admission.release(req)
                self._m["rejected"].inc()
                fut.set_exception(e)
                return fut
            self._m["submitted"].inc()
        return fut

    def predict(self, image, exemplars, **kw) -> dict:
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(image, exemplars, **kw).result()

    def _make_request(self, image, exemplars, multi, k_real, fut, trace_id: str = "",
                      priority: int = 0, deadline_ms: Optional[float] = None,
                      features: Optional[Any] = None) -> Optional[Request]:
        image = np.asarray(image, np.float32)
        if image.ndim == 4 and image.shape[0] == 1:
            image = image[0]
        if image.ndim != 3 or image.shape[0] != image.shape[1] or image.shape[2] != 3:
            raise ValueError(f"expected one square (S, S, 3) image, got {image.shape}")
        ex = np.asarray(exemplars, np.float32).reshape(-1, 4)
        size = int(image.shape[0])
        k = int(k_real) if k_real is not None else len(ex)
        if not 1 <= k <= len(ex):
            raise ValueError(f"k_real={k} out of range for {len(ex)} exemplar rows")
        # degrade steps apply BEFORE the bucket and the digests are computed, so the
        # result-cache key describes exactly what ran
        steps = self._degrade.active_steps()
        applied = []
        if features is not None:
            if multi:
                raise ValueError("features= (temporal reuse) supports single-exemplar "
                                 "requests only")
            # temporal reuse: keyed and counted like a degrade step before the cache
            # lookup, so a reused result lives under a cache/coalesce key of its own
            applied.append("temporal_reuse")
        if "downscale" in steps and size // 2 >= self._degrade.min_size:
            image = downscale_image(image)
            size = int(image.shape[0])
            applied.append("downscale")
        if "truncate_k" in steps and multi and k > 1:
            k = 1
            k_real = 1
            applied.append("truncate_k")
        bucket = self._pred.bucket_key(size, ex[:k] if multi else ex, multi=multi,
                                       k_real=k_real)
        if multi:
            ex = ex[:k]
            ex = np.concatenate([ex, np.tile(ex[-1:], (bucket[3] - k, 1))], axis=0)
        digest = array_digest(image)
        result_key = (bucket, digest, array_digest(ex[:k] if multi else ex),
                      k if multi else None)
        if applied:
            # degraded traffic lives under its own cache/coalesce keys, counted before
            # the lookup so a cache-hit serve of a degraded request is still counted
            result_key = result_key + (tuple(applied),)
            self._count("degraded")
            for step in applied:
                self._count(f"degrade.{step}")

        cached = self.result_cache.get(result_key)
        if cached is not None:
            fut.set_result(cached)
            self._m["submitted"].inc()
            self._m["completed"].inc()
            return None

        deadline_ms = ((self._default_deadline_ms or None) if deadline_ms is None
                       else float(deadline_ms))
        req = Request(image=image, exemplars=ex, bucket=bucket, futures=[fut], k_real=k,
                      image_digest=digest, result_key=result_key, trace_id=trace_id,
                      priority=max(int(priority), 0))
        if deadline_ms is not None:
            req.deadline = req.t_submit + deadline_ms / 1000.0
        client = self._feature_client
        if features is not None:
            # stream-session reuse: the caller supplies this frame's features, and the
            # request skips the encoder
            req.features = torch.as_tensor(features, device=self.device)
            req.bucket = ("heads",) + bucket[1:]
        elif not multi and (self.feature_cache.capacity > 0 or client is not None):
            feat = (self.feature_cache.get(self._feature_key(digest, size))
                    if self.feature_cache.capacity > 0 else None)
            if feat is not None:
                req.features = feat
                req.bucket = ("heads",) + bucket[1:]
            elif client is not None and client.holds(size):
                # a live feature worker holds this size's partition: heads-only, the
                # fetch happens batch-side (_run_heads)
                req.needs_features = True
                req.bucket = ("heads",) + bucket[1:]
            elif client is not None:
                # no holder: this cold frame stays on the local fused path, counted
                self._count("feature_tier.cold_frames")
                if self.feature_cache.capacity > 0:
                    self._seen.put((digest, size), True)
            elif (digest, size) in self._seen:
                req.needs_features = True
                req.bucket = ("heads",) + bucket[1:]
            elif "prefer_heads" in steps:
                # degrade: promote on the FIRST sighting; a routing step, so it stays
                # out of the result key (the stored result's degrade_steps says it)
                req.needs_features = True
                req.bucket = ("heads",) + bucket[1:]
                applied.append("prefer_heads")
                if len(applied) == 1:  # not already counted before the lookup
                    self._count("degraded")
                self._count("degrade.prefer_heads")
            else:
                self._seen.put((digest, size), True)
        if applied:
            req.degrade_steps = tuple(applied)
        # lookup and registration under ONE lock hold: a second identical submit
        # racing this one either sees our registration or wins the slot itself
        with self._lock:
            live = self._inflight.get(result_key)
            if live is not None:
                live.futures.append(fut)
                if req.deadline is not None and (
                        live.deadline is None or req.deadline < live.deadline):
                    live.deadline = req.deadline
                if req.priority > live.priority:
                    live.priority = req.priority
                self._m["submitted"].inc()
                self._m["coalesced"].inc()
                return None
            self._inflight[result_key] = req
        return req

    # ------------------------------------------------------------- threads
    def _thread_main(self, loop) -> None:
        torch.set_num_threads(self._torch_threads)
        loop()

    def _shed_expired(self, requests: List[Request], stage: str) -> List[Request]:
        """Drop expired requests before the next stage spends work on them, each with a
        deadline rejection counted per stage (``serve.shed.<stage>``); returns the rest."""
        if all(r.deadline is None for r in requests):
            return requests
        now = time.perf_counter()
        live = []
        for req in requests:
            if not req.expired(now):
                live.append(req)
                continue
            self._drop_inflight(req)
            self._admission.release(req)
            req.fail(RejectedError(
                "deadline", f"deadline expired before {stage} "
                f"(waited {(now - req.t_submit) * 1000:.1f} ms)", priority=req.priority))
            n = len(req.futures)
            self._count("shed", n)
            self._count(f"shed.{stage}", n)
        return live

    def _stage_loop(self) -> None:
        while True:
            nb = self._batcher.next_batch()
            if nb is None:
                self._staged_q.put(None)
                return
            bucket, reqs = nb
            reqs = self._shed_expired(reqs, "stage")
            if not reqs:
                continue
            try:
                staged = self._stager.stage(bucket, reqs, self._bound_for(bucket))
                self._m["batches"].inc()
                self._m["padded_slots"].inc(staged.padded_slots)
                with self._lock:
                    dev = str(staged.device)
                    self._per_device[dev] = self._per_device.get(dev, 0) + 1
                self._staged_q.put(staged)
            except Exception as e:
                self._isolate(reqs, e)

    def _dispatch_loop(self) -> None:
        while True:
            staged = self._staged_q.get()
            if staged is None:
                self._done_q.put(None)
                return
            # a batch whose every rider expired while staged skips the program
            if staged.requests and all(r.deadline is not None and r.expired()
                                       for r in staged.requests):
                self._shed_expired(staged.requests, "dispatch")
                continue
            try:
                t0 = time.perf_counter()
                out, fill_map = self._run_batch(staged)
                done = None
                if self._cuda:
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(self.device))
                if obs.tracing_enabled():
                    t1 = time.perf_counter()
                    for r in staged.requests:
                        obs.add_span("serve.execute", t0, t1, trace_id=r.trace_id or None,
                                     bucket=str(staged.bucket), device=str(staged.device))
                self._done_q.put((staged, out, done, fill_map))
            except Exception as e:
                self._isolate(staged.requests, e, batch_level=True)

    def _complete_loop(self) -> None:
        while True:
            item = self._done_q.get()
            if item is None:
                return
            staged = item[0]
            try:
                self._finish(*item)
            except Exception as e:
                self._isolate(staged.requests, e, batch_level=True)

    # ------------------------------------------------------------ dispatch
    @torch.inference_mode()
    def _run_batch(self, staged: StagedBatch):
        """Run the bucket's program on the staged tensors, after their copies. Returns
        (detections on the device, fill_map): the heads path's {row: (1, h, w, C)
        feature} of the rows the encoder ran for, else None."""
        kind, size, cap, k = staged.bucket
        staged.wait()
        if kind == "heads":
            return self._run_heads(staged, size, cap)
        if kind == "single":
            return self._pred._get_fn(cap)(staged.images, staged.exemplars), None
        if kind == "multi":
            return self._pred._get_multi_batched_fn(cap, k)(
                staged.images, staged.exemplars, staged.k_real), None
        raise RuntimeError(f"unknown bucket kind {kind!r}")

    def _run_heads(self, staged: StagedBatch, size: int, cap: int):
        self._m["heads_batches"].inc()
        fill_map: Dict[int, torch.Tensor] = {}
        fill_local = list(staged.fill_index)
        if fill_local and self._feature_client is not None:
            # the disaggregated match tier: each fill row's features from the remote
            # worker; a row whose fetch fails (dead worker, saturated window) drops to the
            # local encoder below, counted, and its future still resolves
            still = []
            for i in fill_local:
                req = staged.requests[i]
                try:
                    feat = self._feature_client.fetch(req.image, req.image_digest, size)
                except Exception:
                    feat = None
                if feat is None:
                    still.append(i)
                    self._count("feature_tier.fallback_frames")
                else:
                    fill_map[i] = torch.as_tensor(feat, device=self.device)
                    self._count("feature_tier.remote_frames")
            fill_local = still
        if fill_local:
            feats = self._pred._get_backbone_fn()(staged.images)
            self._m["feature_fills"].inc(len(fill_local))
            # a clone per row: a view would keep the whole batch's features alive in
            # the cache, and its bytes would not be the row's
            for j, i in enumerate(staged.fill_index):
                if i in fill_local:
                    fill_map[i] = feats[j:j + 1].clone()
        rows = [fill_map.get(i, staged.features[i]) for i in range(len(staged.requests))]
        pad = staged.exemplars.shape[0] - len(rows)
        rows.extend([torch.zeros_like(rows[0])] * pad)
        feats = torch.cat(rows) if len(rows) > 1 else rows[0]
        return (self._pred._get_heads_fn(cap, size)(feats, staged.exemplars),
                fill_map or None)

    # ---------------------------------------------------------- completion
    def _fetch(self, out: dict, done) -> Dict[str, np.ndarray]:
        """The batch's detection fields on the host. On the card: one device-to-host
        copy of all of them (packed as bytes, widest first so every field stays
        aligned) into a pinned buffer, on a stream of the completion thread's own that
        waits for the batch's event, then one event wait."""
        names = _det_fields(out)
        if not self._cuda:
            return {name: out[name].numpy() for name in names}
        if self._d2h_stream is None:
            self._d2h_stream = torch.cuda.Stream(self.device)
        stream = self._d2h_stream
        fields = sorted(((name, out[name]) for name in names),
                        key=lambda nt: -nt[1].element_size())
        with torch.cuda.stream(stream):
            stream.wait_event(done)
            for _, t in fields:
                t.record_stream(stream)
            packed = torch.cat([t.contiguous().view(-1).view(torch.uint8)
                                for _, t in fields])
            if self._d2h_buf is None or self._d2h_buf.numel() < packed.numel():
                self._d2h_buf = torch.empty(packed.numel(), dtype=torch.uint8,
                                            pin_memory=True)
            host = self._d2h_buf[:packed.numel()]
            host.copy_(packed, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(stream)
        copied.synchronize()
        result, off = {}, 0
        for name, t in fields:
            nbytes = t.numel() * t.element_size()
            result[name] = host[off:off + nbytes].view(t.dtype).view(t.shape).numpy()
            off += nbytes
        return result

    def _finish(self, staged: StagedBatch, out: dict, done, fill_map) -> None:
        t_post0 = time.perf_counter()
        host = self._fetch(out, done)
        # the fetch is the batch's postprocess cost: each rider's span is this shared
        # window (like batch_assemble/stage/execute)
        t_fetch1 = time.perf_counter()
        kind, size = staged.bucket[0], staged.bucket[1]
        traced = obs.tracing_enabled()
        now = time.perf_counter()
        for i, req in enumerate(staged.requests):
            if req.expired(now):
                self._drop_inflight(req)
                self._admission.release(req)
                req.fail(RejectedError("deadline", "deadline expired before postprocess",
                                       priority=req.priority))
                n = len(req.futures)
                self._count("shed", n)
                self._count("shed.postprocess", n)
                continue
            try:
                # .copy(): a row view would keep the whole batch's host buffer alive
                # (and the pinned one is written again by the next batch)
                result = {name: host[name][i:i + 1].copy() for name in host}
                if req.degrade_steps:
                    result["degrade_steps"] = list(req.degrade_steps)
                if req.result_key is not None:
                    self.result_cache.put(req.result_key, result)
                if kind == "heads" and fill_map and i in fill_map:
                    self.feature_cache.put(self._feature_key(req.image_digest, size),
                                           fill_map[i])
                self._drop_inflight(req)
                self._admission.release(req)
                t_res0 = time.perf_counter()
                req.resolve(result)
                t_res1 = time.perf_counter()
                if traced:
                    tid = req.trace_id or None
                    obs.add_span("serve.postprocess", t_post0, t_fetch1, trace_id=tid)
                    obs.add_span("serve.resolve", t_res0, t_res1, trace_id=tid,
                                 futures=len(req.futures))
                self._lat.observe(t_res1 - req.t_submit)
                if obs.flight_enabled():
                    obs.flight_record(
                        "serve.request", bucket=str(staged.bucket),
                        latency_s=round(t_res1 - req.t_submit, 6),
                        batch=len(staged.requests), padded=staged.padded_slots,
                        device=str(staged.device), futures=len(req.futures))
                # per future: coalesced riders counted into `submitted` land in a
                # terminal count too
                self._m["completed"].inc(len(req.futures))
            except Exception as e:  # isolation: this request alone
                self._drop_inflight(req)
                self._admission.release(req)
                req.fail(e)
                self._m["errors"].inc(len(req.futures))

    # ------------------------------------------------------ error fallback
    def _isolate(self, requests: List[Request], exc: BaseException,
                 batch_level: bool = False) -> None:
        """Batch-level failure -> per-request fallback: each request re-runs alone
        through the predictor, so one poison request fails alone."""
        if batch_level:
            self._m["batch_fallbacks"].inc()
        for req in requests:
            try:
                result = self._run_single(req)
                self._drop_inflight(req)
                self._admission.release(req)
                req.resolve(result)
                self._lat.observe(time.perf_counter() - req.t_submit)
                self._m["completed"].inc(len(req.futures))
            except Exception as e:
                self._drop_inflight(req)
                self._admission.release(req)
                req.fail(e)
                self._m["errors"].inc(len(req.futures))

    def _run_single(self, req: Request) -> dict:
        # np.stack, not [None]: a new axis gets stride 0, and the CPU convolutions
        # pick their path by the input's strides
        image = np.stack([req.image])
        if req.bucket[0] == "multi":
            dets = self._pred.predict_multi_exemplar(image, req.exemplars,
                                                     k_real=req.k_real)
        else:  # single and heads requests share __call__ semantics
            dets = self._pred(image, np.stack([req.exemplars]))
        out = {name: dets[name].cpu().numpy() for name in _det_fields(dets)}
        if req.degrade_steps:
            out["degrade_steps"] = list(req.degrade_steps)
        return out

    def _drop_inflight(self, req: Request) -> None:
        if req.result_key is None:
            return
        with self._lock:
            if self._inflight.get(req.result_key) is req:
                del self._inflight[req.result_key]

    # --------------------------------------------------------------- health
    def health(self) -> dict:
        """One ``health_report/v1`` snapshot: queue depths, per-device batches, cache
        stats, compile-event tallies (the kernels' ``nvcc`` builds) and the anomalies
        the health watch fired on this pass (its detector state advances per call: the
        heartbeat's interval is the detection window, and the degrade ladder's control
        step)."""
        with self._lock:
            new_events, self._compile_seen = obs.compile_events_since(self._compile_seen)
            per_device = dict(self._per_device)
            batch_bounds = dict(self._batch_bounds)
            inflight = len(self._inflight)
            closed = self._closed
        pending = self._batcher.pending()
        anomalies = self._watch.observe(self.metrics.snapshot(),
                                        compile_events=new_events, pending=pending)
        if self._degrade.enabled:
            self._degrade.observe(anomalies)
        now = time.time()
        # lifetime tallies from the monotone registry counters (the event log is
        # bounded); `recent` is the log's tail
        reg = obs.get_registry()
        doc = {
            "schema": HEALTH_REPORT_SCHEMA,
            "ts": now,
            "uptime_s": round(now - self._t_start, 3),
            "closed": closed,
            "inflight": inflight,
            "queues": {
                "pending": pending,
                "per_bucket": {str(k): v
                               for k, v in self._batcher.depth_snapshot().items()},
            },
            "devices": [str(d) for d in self.devices],
            "per_device_batches": per_device,
            "batch_bounds": {str(k): v for k, v in batch_bounds.items()},
            "max_wait_ms": self.max_wait_ms,
            "caches": {"result": self.result_cache.stats(),
                       "feature": self.feature_cache.stats()},
            "counters": self.counters,
            "compile": {
                "total": int(reg.counter("compile.total").value),
                "cold": int(reg.counter("compile.cold").value),
                "key_change": int(reg.counter("compile.key_change").value),
                "recent": obs.compile_events()[-8:],
            },
            "anomalies": anomalies,
        }
        if self._quant_stamp is not None:
            doc["quant"] = dict(self._quant_stamp)
        # the overload sections appear only when the features are on
        if self._admission.enabled:
            doc["admission"] = self._admission.stats()
        if self._degrade.enabled:
            doc["degrade"] = self._degrade.stats()
        return doc

    def start_heartbeat(self, path: str, interval_s: Optional[float] = None):
        """Append :meth:`health` to ``path`` as JSONL every ``interval_s`` seconds
        (default ``TMR_HEALTH_INTERVAL_S``). Returns the obs.Heartbeat; :meth:`close`
        stops it."""
        hb = obs.Heartbeat(self.health, path, interval_s=interval_s)
        with self._lock:
            old, self._heartbeat = self._heartbeat, hb
        if old is not None:
            old.stop()
        return hb

    # ------------------------------------------------------------ lifecycle
    def close(self, timeout: Optional[float] = None) -> None:
        """Drain pending requests and stop the pipeline threads within a bound:
        ``timeout`` (None -> ``TMR_SERVE_DRAIN_TIMEOUT_S``, default 300) caps the whole
        drain; past it every unresolved request's future fails with a shutdown
        :class:`RejectedError` instead of leaving its caller hanging (the pipeline
        threads are daemons, so an abandoned drain cannot block process exit)."""
        timeout = self._drain_timeout_s if timeout is None else float(timeout)
        with self._lock:
            if self._closed:
                return
            self._closed = True
            hb, self._heartbeat = self._heartbeat, None
        if hb is not None:
            hb.stop()
        self._batcher.close()
        deadline = time.perf_counter() + max(timeout, 0.0)
        for t in self._threads:
            t.join(timeout=max(deadline - time.perf_counter(), 0.0))
        if not any(t.is_alive() for t in self._threads):
            return
        # bounded drain expired: the inflight registry is the complete set of
        # unresolved requests, and Request.fail only touches futures not done, so a
        # straggler resolving late is a harmless no-op on both sides
        with self._lock:
            leftovers = list(self._inflight.values())
            self._inflight.clear()
            self._drain_timed_out = True
        for req in leftovers:
            self._admission.release(req)
            req.fail(RejectedError(
                "shutdown", f"engine closed; request unserved after the "
                f"{timeout:.1f}s drain bound", priority=req.priority))
            n = len(req.futures)
            self._count("shed", n)
            self._count("shed.shutdown", n)

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- metrics
    @property
    def counters(self) -> Dict[str, int]:
        """The engine's counters as a dict, read from its registry."""
        return {name: c.value for name, c in self._m.items()}

    def metrics_snapshot(self) -> dict:
        """This engine's registry as one ``metrics_report/v1`` document."""
        return self.metrics.snapshot()

    def overload_counters(self) -> Dict[str, int]:
        """The admission, shed and degrade tallies as plain ints, zero when nothing
        fired, with their per-cause, per-stage and per-step splits."""
        with self._lock:
            live = {name: int(c.value) for name, c in self._mx.items()}
        return {
            "admit_rejected": live.get("admit_rejected", 0),
            "shed": live.get("shed", 0),
            "degraded": live.get("degraded", 0),
            **{k: v for k, v in sorted(live.items()) if "." in k},
        }

    def stats(self) -> dict:
        with self._lock:
            per_device = dict(self._per_device)
            batch_bounds = dict(self._batch_bounds)
        out = {
            **self.counters,
            "batch_occupancy": {str(k): v for k, v in
                                sorted(self._batcher.occupancy_snapshot().items())},
            "pending": self._batcher.pending(),
            "result_cache": self.result_cache.stats(),
            "feature_cache": self.feature_cache.stats(),
            "devices": [str(d) for d in self.devices],
            "per_device_batches": per_device,
            "max_wait_ms": self.max_wait_ms,
            "batch_bounds": {str(k): v for k, v in batch_bounds.items()},
            "donate": False,
        }
        if self._quant_stamp is not None:
            out["quant"] = dict(self._quant_stamp)
        if self._warmup_stats is not None:
            out["warmup"] = dict(self._warmup_stats)
        with self._lock:
            any_fired = bool(self._mx)
            drain_timed_out = self._drain_timed_out
        if self._admission.enabled or self._degrade.enabled or any_fired:
            out["overload"] = {
                "counters": self.overload_counters(),
                "admission": self._admission.stats(),
                "degrade": self._degrade.stats(),
                "drain_timed_out": drain_timed_out,
            }
        return out
