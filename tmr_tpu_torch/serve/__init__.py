"""Throughput serving over the ``Predictor``'s bucketed programs (counterpart of the
single-process part of ``tmr_tpu/serve``).

``ServeEngine`` is the entry point: dynamic micro-batching under a latency bound, pinned
double-buffered staging, content-addressed result and feature caches, admission control
and the degrade ladder; see engine.py for the pipeline and its contracts. ``GalleryBank`` serves
standing pattern banks (``gallery.py``; ``FeatureSinkServer`` takes the map phase's
streamed features). Stream sessions (``streams.py``: ``StreamRouter`` and the engine's
``submit(features=)``) and the disaggregated feature tier (``feature_tier.py``:
``FeatureTier``, ``FeatureWorker``, ``FeatureTierClient`` and the engine's
``feature_client=``) are ported; the fleet (``ServeFleet``, ``FleetWorker``), the gallery
fleet and mesh plans are ROADMAP A7.4's.
"""

from tmr_tpu_torch.serve.admission import (
    REJECTION_CAUSES,
    AdmissionController,
    RejectedError,
    class_weight_fn,
)
from tmr_tpu_torch.serve.batcher import MicroBatcher, Request
from tmr_tpu_torch.serve.caches import LRUCache, array_digest
from tmr_tpu_torch.serve.degrade import DEGRADE_STEPS, DegradeController
from tmr_tpu_torch.serve.engine import ServeEngine
from tmr_tpu_torch.serve.feature_tier import FeatureTier, FeatureTierClient, FeatureWorker
from tmr_tpu_torch.serve.gallery import FeatureSinkServer, GalleryBank, gallery_fused_ok
from tmr_tpu_torch.serve.staging import DeviceStager, StagedBatch
from tmr_tpu_torch.serve.streams import StreamRouter, block_signature

__all__ = [
    "AdmissionController",
    "DEGRADE_STEPS",
    "DegradeController",
    "DeviceStager",
    "FeatureSinkServer",
    "FeatureTier",
    "FeatureTierClient",
    "FeatureWorker",
    "GalleryBank",
    "LRUCache",
    "MicroBatcher",
    "REJECTION_CAUSES",
    "RejectedError",
    "Request",
    "ServeEngine",
    "StagedBatch",
    "StreamRouter",
    "array_digest",
    "block_signature",
    "class_weight_fn",
    "gallery_fused_ok",
]
