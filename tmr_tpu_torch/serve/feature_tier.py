"""Feature tier: encoder-only workers on the fleet's lease discipline, streaming features
to match-tier engines over the feature sink's link (counterpart of
``tmr_tpu/serve/feature_tier.py``, the same protocol on the wire, so either package's
workers serve either package's clients).

The encoder is nearly all of a frame's work while the match and decode tail is cheap,
yet the fused serving path scales both on one axis. This module splits them:

- **feature partitions** (one per image size) are leased from the port's
  :class:`~tmr_tpu_torch.parallel.leases.LeaseService`; :class:`FeatureTier` is the
  coordinator (hello / lease / beat / fail / bye over the JSON-lines control protocol,
  liveness through ``expire_pass``);
- each :class:`FeatureWorker` runs only the encoder program
  (``Predictor._get_backbone_fn()``) and answers ``extract`` round trips on its data
  plane, a :class:`~tmr_tpu_torch.serve.gallery.FeatureSinkServer` composed through its
  ``on_request`` hook. Every extract is fenced against the worker's currently held
  (partition, epoch): a revoked worker answers ``fenced``, never stale features. A worker
  built on a real ``Predictor`` runs on the card, and refuses the CPU unless asked
  (``device="cpu"``);
- the **match tier** consumes this through :class:`FeatureTierClient`: a
  ``ServeEngine(feature_client=...)`` runs its heads-only programs on remote features.
  The client's in-flight window (``TMR_FEATURE_TIER_WINDOW``) fails fast when it is
  full, so the engine drops to its counted local path instead of queueing on the link.
  Frames with no live holder (``feature_tier.cold_frames``) and fetches that fail
  (``feature_tier.fallback_frames``) run locally, on the engine's own device through the
  same programs, counted, and their futures always resolve.

Every extract reply carries the worker predictor's ``feature_stamp()`` (the port's is a
content digest of the weights, so a worker in another process with the same weights
matches), and the client refuses a reply whose stamp differs from its engine's (counted
``stamp_mismatches``).

Env knobs (read lazily): the ``TMR_ELASTIC_*`` lease-liveness family shared with the map
phase, ``TMR_FEATURE_TIER_WINDOW`` and ``TMR_FEATURE_TIER_TIMEOUT_S``. The JAX package's
fleet observability spans (``TMR_FLEET_OBS``) come with the fleet (ROADMAP A7.4); set,
the worker and the client refuse to start.
"""

from __future__ import annotations

import os
import socket
import socketserver
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tmr_tpu_torch.obs.tracing import _env_flag
from tmr_tpu_torch.parallel.leases import (
    LeasePolicy,
    LeaseService,
    Resource,
    connect_timeout,
    oneshot,
    recv_line,
    send_line,
)
from tmr_tpu_torch.serve.fleet import (
    StubFleetPredictor,
    _np32,
    fleet_policy,
    pack_array,
    unpack_array,
)
from tmr_tpu_torch.serve.gallery import FeatureSinkServer


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


def _refuse_fleet_obs() -> None:
    """The JAX tier opens fleet observability spans under ``TMR_FLEET_OBS``; the port has
    no fleet plane yet, so a run asking for it stops here rather than running without
    what it asked for."""
    if _env_flag("TMR_FLEET_OBS"):
        raise NotImplementedError(
            "TMR_FLEET_OBS: the fleet observability plane (obs/fleetobs.py) is not ported "
            "yet (ROADMAP A7.4, with the fleet); unset it to run the feature tier")


# ------------------------------------------------------------- partitions
class FeaturePartition(Resource):
    """One feature partition: an image-size bucket, leased for the lifetime of its
    holder (it never settles)."""

    __slots__ = ("size",)

    def __init__(self, index: int, size: int):
        super().__init__(index, f"feat{size}")
        self.size = int(size)


# ------------------------------------------------------------ coordinator
class _TierHandler(socketserver.StreamRequestHandler):
    """Control-plane handler: JSON lines in and out; EOF with leases held is the
    kill -9 signature."""

    def handle(self):
        tier = self.server.tier
        control_worker = None
        clean = False
        try:
            while True:
                try:
                    msg = recv_line(self.rfile)
                except (OSError, ValueError):
                    break
                if msg is None:
                    break
                if msg.get("op") == "hello":
                    control_worker = msg.get("worker")
                if msg.get("op") == "bye":
                    clean = True
                reply = tier.dispatch(msg)
                try:
                    send_line(self.connection, reply)
                except OSError:
                    break
                if clean:
                    break
        finally:
            if control_worker is not None:
                tier.control_closed(control_worker, clean=clean)


class _TierServer(socketserver.ThreadingTCPServer):
    daemon_threads = True
    allow_reuse_address = True


class FeatureTier:
    """The feature-tier coordinator: encoder workers lease image-size partitions here,
    and match-tier clients resolve the current holder of a size. One per cluster, usually
    beside the front door."""

    def __init__(self, sizes: Sequence[int], *, policy: Optional[LeasePolicy] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 check_interval_s: Optional[float] = None):
        self.sizes = sorted({int(s) for s in sizes})
        if not self.sizes:
            raise ValueError("a feature tier needs at least one size")
        partitions = [FeaturePartition(i, size) for i, size in enumerate(self.sizes)]
        self.policy = fleet_policy(policy)
        # indefinite serving: a flapping worker must not grow the event history forever
        self._svc = LeaseService(partitions, self.policy, metrics_prefix="feature_tier",
                                 noun="partition", key_field="partition",
                                 history_bound=4096)
        self._partitions = partitions
        self._index_by_size = {p.size: p.index for p in partitions}
        self._host, self._port = host, int(port)
        self._lock = threading.RLock()
        self._worker_addr: Dict[str, Tuple[str, int]] = {}
        self._closed = False
        self._stop_event = threading.Event()
        self._server: Optional[_TierServer] = None
        self._threads: List[threading.Thread] = []
        self._check_s = (self.policy.check_interval_s if check_interval_s is None
                         else float(check_interval_s))

    # ----------------------------------------------------------- lifecycle
    def start(self) -> Tuple[str, int]:
        server = _TierServer((self._host, self._port), _TierHandler)
        server.tier = self
        threads = [
            threading.Thread(target=server.serve_forever, kwargs={"poll_interval": 0.05},
                             name="feature-tier-control", daemon=True),
            threading.Thread(target=self._monitor_loop, name="feature-tier-monitor",
                             daemon=True),
        ]
        with self._lock:
            self._server = server
            self._threads = threads
        self._svc.restart_clock()
        for t in threads:
            t.start()
        return self.address

    @property
    def address(self) -> Tuple[str, int]:
        with self._lock:
            if self._server is None:
                raise RuntimeError("feature tier not started")
            return self._server.server_address[:2]

    def close(self, timeout: float = 10.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            server = self._server
            threads = list(self._threads)
        self._stop_event.set()
        if server is not None:
            server.shutdown()
            server.server_close()
        deadline = time.monotonic() + max(timeout, 0.0)
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))

    def __enter__(self) -> "FeatureTier":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _monitor_loop(self) -> None:
        while not self._stop_event.wait(self._check_s):
            try:
                self._svc.expire_pass()
            except Exception:
                pass  # the liveness loop must survive anything

    # ---------------------------------------------------- control protocol
    def dispatch(self, msg: dict) -> dict:
        op = msg.get("op")
        handler = {
            "hello": self._op_hello,
            "lease": self._op_lease,
            "beat": self._op_beat,
            "fail": self._op_fail,
            "bye": self._op_bye,
            "state": lambda m: self.state(),
        }.get(op)
        if handler is None:
            return {"ok": False, "error": f"unknown op {op!r}"}
        try:
            return handler(msg)
        except Exception as e:  # the protocol answers, never wedges
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _op_hello(self, msg: dict) -> dict:
        wid = str(msg.get("worker"))
        # a rejoining worker id is alive again
        self._svc.rejoin(wid)
        data_addr = msg.get("data_addr")
        if isinstance(data_addr, (list, tuple)) and len(data_addr) == 2:
            with self._lock:
                self._worker_addr[wid] = (str(data_addr[0]), int(data_addr[1]))
        return {"ok": True, "sizes": list(self.sizes), "ttl_s": self.policy.lease_ttl_s,
                "hb_interval_s": self.policy.hb_interval_s,
                "partitions": len(self._partitions)}

    def _op_lease(self, msg: dict) -> dict:
        wid = str(msg.get("worker"))
        wait = {"partition": None, "wait_s": max(self.policy.check_interval_s, 0.05)}
        verdict, part, epoch = self._svc.select(wid)
        if verdict == "drained":
            return {"partition": None, "drained": True}
        if verdict != "grant":
            return wait  # a tier is never "done" while it serves
        if self._svc.install(part, epoch, wid) is None:
            return wait
        return {"partition": part.key, "index": part.index, "epoch": epoch,
                "size": part.size, "ttl_s": self.policy.lease_ttl_s,
                "hb_interval_s": self.policy.hb_interval_s}

    def _op_beat(self, msg: dict) -> dict:
        wid = str(msg.get("worker"))
        stale: List[List[int]] = []
        for pair in msg.get("held") or ():
            index, epoch = int(pair[0]), int(pair[1])
            if not self._svc.heartbeat(wid, index, epoch):
                stale.append([index, epoch])
        worker = self._svc.worker_rec(wid)
        return {"ok": True, "stale": stale, "drained": worker.drained}

    def _op_fail(self, msg: dict) -> dict:
        wid = str(msg.get("worker"))
        index, epoch = int(msg.get("index", -1)), int(msg.get("epoch", -1))
        res = self._svc.fail(wid, index, epoch, msg.get("causes") or [])
        return {"ok": True, **res}

    def _op_bye(self, msg: dict) -> dict:
        wid = str(msg.get("worker"))
        self._svc.bye(wid)
        # a clean leaver still releases its partitions for rebalance
        self._svc.revoke_worker(wid, "worker_exit")
        return {"ok": True}

    def control_closed(self, wid: str, clean: bool) -> None:
        self._svc.control_closed(str(wid), clean)

    # ------------------------------------------------------------- resolve
    def holder_for(self, size: int) -> Optional[Tuple[str, int, int, Tuple[str, int]]]:
        """The live holder of one size's partition as ``(worker id, epoch, partition
        index, data address)``, or None (unknown size, unheld partition, or a holder that
        never registered a data plane)."""
        index = self._index_by_size.get(int(size))
        if index is None:
            return None
        holder = self._svc.holder(index)
        if holder is None:
            return None
        wid, epoch = holder
        with self._lock:
            addr = self._worker_addr.get(wid)
        if addr is None:
            return None
        return wid, epoch, index, addr

    def client(self, predictor: Any = None, **kw) -> "FeatureTierClient":
        """A match-tier client over this tier (the in-process resolve path). Pass the
        engine's predictor so that the stamp fence is armed."""
        return FeatureTierClient(self, predictor=predictor, **kw)

    def state(self) -> dict:
        with self._svc.lock:
            with self._lock:
                return {
                    "ok": True,
                    "partitions": {p.key: {"size": p.size, "status": p.status,
                                           "holder": self._svc.holder(p.index)}
                                   for p in self._partitions},
                    "workers": {w.wid: {"drained": w.drained, "dead": w.dead}
                                for w in self._svc.workers.values()},
                    "reassignments": [dict(r) for r in self._svc.reassignments],
                }


# ---------------------------------------------------------------- worker
class FeatureWorker:
    """One encoder-only worker: joins a :class:`FeatureTier`, leases size partitions,
    heartbeats them, and answers fenced ``extract`` round trips on its data plane, a
    :class:`~tmr_tpu_torch.serve.gallery.FeatureSinkServer` composed through
    ``on_request`` (the sink's push half keeps working beside it).

    ``predictor`` needs only ``_get_backbone_fn()`` (and ``feature_stamp()`` for the
    stamp fence): a ``Predictor`` or the stub. ``device`` is where the worker runs: None
    means the card (``RuntimeError`` when there is none), ``"cpu"`` asks for the CPU, and
    a predictor on another device is refused."""

    def __init__(self, coordinator: Tuple[str, int], worker_id: str, predictor, *,
                 device=None, data_host: str = "127.0.0.1", data_port: int = 0,
                 timeout: float = 30.0):
        from tmr_tpu_torch.models import resolve_device

        _refuse_fleet_obs()
        want = resolve_device(device)
        have = getattr(predictor, "device", None)
        if have is not None and torch.device(have).type != want.type:
            raise ValueError(f"the worker runs on {want.type} but its predictor is on "
                             f"{torch.device(have)}")
        self.worker_id = worker_id
        self._pred = predictor
        self.coordinator = (coordinator[0], int(coordinator[1]))
        self._lock = threading.RLock()
        self._held: Dict[int, int] = {}  # partition index -> epoch
        self._stop_event = threading.Event()
        self._drained = False
        self._coordinator_lost = False
        self._counters = {"extracted": 0, "fenced": 0, "errors": 0}
        self._sink = FeatureSinkServer(host=data_host, port=data_port,
                                       on_request=self._on_request)
        data_addr = self._sink.start()
        self._sock = socket.create_connection(self.coordinator,
                                              timeout=connect_timeout(min(timeout, 5.0)))
        self._sock.settimeout(timeout)
        self._file = self._sock.makefile("rb")
        self._ctl_lock = threading.Lock()
        self.config = self._call({"op": "hello", "data_addr": list(data_addr[:2])})
        self._hb_interval = float(self.config.get("hb_interval_s") or 2.5)
        self._threads: List[threading.Thread] = []

    # ------------------------------------------------------------- control
    def _call(self, doc: dict) -> dict:
        doc = dict(doc)
        doc.setdefault("worker", self.worker_id)
        with self._ctl_lock:
            send_line(self._sock, doc)
            reply = recv_line(self._file)
        if reply is None:
            raise ConnectionError("feature-tier coordinator closed the connection")
        return reply

    def start(self) -> "FeatureWorker":
        threads = [
            threading.Thread(target=self._lease_loop, name=f"feat-lease-{self.worker_id}",
                             daemon=True),
            threading.Thread(target=self._beat_loop, name=f"feat-beat-{self.worker_id}",
                             daemon=True),
        ]
        with self._lock:
            self._threads = threads
        for t in threads:
            t.start()
        return self

    def _lease_loop(self) -> None:
        while not self._stop_event.is_set():
            try:
                grant = self._call({"op": "lease"})
            except (ConnectionError, OSError):
                if not self._stop_event.is_set():
                    with self._lock:
                        self._coordinator_lost = True
                return
            if grant.get("drained"):
                with self._lock:
                    self._drained = True
                return
            index = grant.get("index")
            if index is None:
                if self._stop_event.wait(float(grant.get("wait_s", 0.2))):
                    return
                continue
            with self._lock:
                self._held[int(index)] = int(grant["epoch"])

    def _beat_loop(self) -> None:
        while not self._stop_event.wait(self._hb_interval):
            try:
                self._beat_once()
            except (ConnectionError, OSError):
                pass  # missed beats are the liveness signal

    def _beat_once(self) -> dict:
        with self._lock:
            held = [[i, e] for i, e in self._held.items()]
        reply = oneshot(self.coordinator, {"op": "beat", "worker": self.worker_id,
                                           "held": held})
        stale = reply.get("stale") or ()
        with self._lock:
            for index, epoch in stale:
                if self._held.get(int(index)) == int(epoch):
                    del self._held[int(index)]
            if reply.get("drained"):
                self._drained = True
        return reply

    # ---------------------------------------------------------- data plane
    def holds(self, index: int, epoch: int) -> bool:
        with self._lock:
            return self._held.get(int(index)) == int(epoch)

    def _on_request(self, doc: dict, state: dict) -> Optional[dict]:
        """The sink's online-op hook: ``extract`` runs the encoder on one frame, fenced
        against the currently held (partition, epoch). Other ops fall through (None) to
        the sink's unknown-op error."""
        if doc.get("op") != "extract":
            return None
        index = int(doc.get("partition", -1))
        epoch = int(doc.get("epoch", -1))
        if not self.holds(index, epoch):
            with self._lock:
                self._counters["fenced"] += 1
            return {"op": "extract", "ok": False, "status": "fenced"}
        try:
            feats = self._extract(unpack_array(doc["image"]))
            packed = pack_array(feats)
        except Exception as e:
            with self._lock:
                self._counters["errors"] += 1
            return {"op": "extract", "ok": False, "status": "error",
                    "message": f"{type(e).__name__}: {e}"}
        with self._lock:
            self._counters["extracted"] += 1
        reply = {"op": "extract", "ok": True, "status": "ok", "features": packed}
        stamp = getattr(self._pred, "feature_stamp", None)
        if callable(stamp):
            reply["stamp"] = list(stamp())
        return reply

    def _extract(self, image):
        """One encoder pass, the tier's only program: ``_get_backbone_fn()`` on the frame
        as a batch of one (stacked: a ``[None]`` axis has stride 0, and the CPU
        convolutions pick their path by the input's strides)."""
        batch = np.stack([image]) if image.ndim == 3 else image
        return self._pred._get_backbone_fn()(batch)

    # ----------------------------------------------------------- lifecycle
    @property
    def held(self) -> Dict[int, int]:
        with self._lock:
            return dict(self._held)

    @property
    def drained(self) -> bool:
        with self._lock:
            return self._drained

    @property
    def coordinator_lost(self) -> bool:
        with self._lock:
            return self._coordinator_lost

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def stop(self, timeout: float = 10.0) -> None:
        self._stop_event.set()
        try:
            self._call({"op": "bye"})
        except (ConnectionError, OSError):
            pass
        try:  # shutdown first: it unblocks any reader before the close
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._sink.close()
        with self._lock:
            threads = list(self._threads)
        deadline = time.monotonic() + max(timeout, 0.0)
        for t in threads:
            t.join(timeout=max(deadline - time.monotonic(), 0.0))


# ---------------------------------------------------------------- client
class _ExtractLink:
    """One persistent extract connection to a feature worker's data plane. Round trips
    serialize under the link's lock (one request in flight per connection: TCP's order
    pairs each reply with its request); concurrency comes from the client's window."""

    def __init__(self, address: Tuple[str, int], timeout_s: float):
        self.address = (address[0], int(address[1]))
        self.sock = socket.create_connection(self.address,
                                             timeout=connect_timeout(min(timeout_s, 5.0)))
        self.sock.settimeout(timeout_s)
        self.file = self.sock.makefile("rb")
        self._lock = threading.Lock()
        self.dead = False

    def call(self, doc: dict) -> Optional[dict]:
        with self._lock:
            if self.dead:
                return None
            try:
                send_line(self.sock, doc)
                reply = recv_line(self.file)
            except (OSError, ValueError):
                self.dead = True
                return None
            if reply is None:
                self.dead = True
            return reply

    def close(self) -> None:
        # shutdown first: a reader blocked in the buffered file under the link's lock
        # would deadlock a lock-then-close order; the shutdown unblocks it
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass
        with self._lock:
            self.dead = True


class FeatureTierClient:
    """The match tier's side of the link, what ``ServeEngine(feature_client=...)``
    consumes:

    - ``holds(size)``: does a live worker hold this size's partition (with a registered
      data plane)? False keeps the frame on the counted local fused path;
    - ``fetch(image, digest, size)``: one fenced extract round trip to the current
      holder. Returns the (1, h, w, C) features, or None on any failure (dead link,
      fenced epoch, stamp mismatch, full window), so the engine's fallback (counted local
      execution, futures always resolve) owns every error path.

    Backpressure is the window semaphore (``window`` -> ``TMR_FEATURE_TIER_WINDOW``,
    default 4): when it is full, ``fetch`` fails fast instead of queueing.
    ``TMR_FEATURE_TIER_TIMEOUT_S`` (default 10) bounds each round trip."""

    def __init__(self, tier: FeatureTier, *, predictor: Any = None,
                 window: Optional[int] = None, timeout_s: Optional[float] = None):
        _refuse_fleet_obs()
        self._tier = tier
        fstamp = getattr(predictor, "feature_stamp", None)
        self._expect_stamp: Optional[tuple] = tuple(fstamp()) if callable(fstamp) else None
        self._window_n = max(_env_int("TMR_FEATURE_TIER_WINDOW", 4) if window is None
                             else int(window), 1)
        self._window = threading.BoundedSemaphore(self._window_n)
        self._timeout_s = (_env_float("TMR_FEATURE_TIER_TIMEOUT_S", 10.0)
                           if timeout_s is None else float(timeout_s))
        self._lock = threading.Lock()
        self._links: Dict[str, _ExtractLink] = {}
        self._counters = {"fetches": 0, "fetched": 0, "no_holder": 0,
                          "window_rejections": 0, "link_failures": 0, "fenced": 0,
                          "errors": 0, "stamp_mismatches": 0}

    def _bump(self, name: str) -> None:
        with self._lock:
            self._counters[name] += 1

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def holds(self, size: int) -> bool:
        return self._tier.holder_for(size) is not None

    def _link_for(self, wid: str, addr: Tuple[str, int]) -> Optional[_ExtractLink]:
        with self._lock:
            link = self._links.get(wid)
        if link is not None and not link.dead and link.address == (addr[0], int(addr[1])):
            return link
        try:
            fresh = _ExtractLink(addr, self._timeout_s)
        except OSError:
            return None
        with self._lock:
            old = self._links.get(wid)
            self._links[wid] = fresh
        if old is not None:
            old.close()
        return fresh

    def fetch(self, image, digest: str, size: int):
        self._bump("fetches")
        resolved = self._tier.holder_for(size)
        if resolved is None:
            self._bump("no_holder")
            return None
        wid, epoch, index, addr = resolved
        if not self._window.acquire(blocking=False):
            # backpressure: fail fast at a full window; the engine's local path beats
            # queueing on the link
            self._bump("window_rejections")
            return None
        try:
            link = self._link_for(wid, addr)
            if link is None:
                self._bump("link_failures")
                return None
            reply = link.call({"op": "extract", "partition": index, "epoch": epoch,
                               "digest": str(digest), "image": pack_array(image)})
            if reply is None:
                self._bump("link_failures")
                return None
            if reply.get("ok") is not True:
                self._bump("fenced" if reply.get("status") == "fenced" else "errors")
                return None
            stamp = reply.get("stamp")
            if (self._expect_stamp is not None and stamp is not None
                    and tuple(stamp) != self._expect_stamp):
                # a worker serving other weights or another formulation must never feed
                # this engine's caches
                self._bump("stamp_mismatches")
                return None
            feats = unpack_array(reply["features"])
            self._bump("fetched")
            return feats
        finally:
            self._window.release()

    def close(self) -> None:
        with self._lock:
            links = list(self._links.values())
            self._links.clear()
        for link in links:
            link.close()


# ------------------------------------------------------------------ stub
class StubFeaturePredictor(StubFleetPredictor):
    """The fleet stub with a real data path through its features: the encoder embeds each
    image's mean signature into every feature cell, and the heads derive ``scores[:, 0]``
    back out of the features (exactly: the mean of a constant float32 array is that
    constant). Remote-against-local equality through this stub checks the disaggregated
    data path end to end: crossed wires, stale features or a dropped row show as
    signature mismatches."""

    def feature_stamp(self) -> tuple:
        return ("stub-params", "stub-backbone")

    def _get_backbone_fn(self):
        def bb(image):
            arr = _np32(image)
            b = arr.shape[0]
            sig = arr.reshape(b, -1).mean(axis=1)
            return torch.from_numpy(np.tile(sig.reshape(b, 1, 1, 1),
                                            (1, 2, 2, 4)).astype(np.float32))
        return bb

    def _get_heads_fn(self, capacity, size):
        def heads(feats, ex):
            f = _np32(feats)
            b = f.shape[0]
            sig = f.reshape(b, -1).mean(axis=1)
            if self.delay_s:
                time.sleep(self.delay_s)
            dets = self._dets(np.zeros((b, 1, 1, 3), np.float32))
            dets["scores"][:, 0] = torch.from_numpy(sig)
            return dets
        return heads
