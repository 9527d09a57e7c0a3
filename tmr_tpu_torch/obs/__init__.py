"""Telemetry the serving layer records into (counterpart of the ported part of
``tmr_tpu/obs``): span tracing (``tracing.py``: request-scoped spans, Chrome trace JSON
and ``torch.profiler.record_function`` regions, nothing under ``TMR_TRACE=0``), the
metrics registry (``metrics.py``: counters, gauges and histograms, ``metrics_report/v1``
snapshots), compile accounting (``compile.py``: the ``nvcc`` builds of the kernels), and
``flight.py`` (the ``TMR_FLIGHT`` recorder ring, the anomaly-detecting HealthWatch and
the health heartbeat). Per-program device time and MFU (``devtime.py``) are ROADMAP
A8's, the fleet plane (``fleetobs.py``) A7's. Nothing here imports torch at module load.
"""

from tmr_tpu_torch.obs.compile import (
    compile_event_seq,
    compile_events,
    compile_events_since,
    record_compile_event,
)
from tmr_tpu_torch.obs.flight import (
    FlightRecorder,
    Heartbeat,
    HealthWatch,
    flight_enabled,
)
from tmr_tpu_torch.obs.flight import configure as flight_configure
from tmr_tpu_torch.obs.flight import get_recorder as flight_recorder
from tmr_tpu_torch.obs.flight import record as flight_record
from tmr_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
)
from tmr_tpu_torch.obs.tracing import (
    add_span,
    chrome_trace,
    clear,
    configure,
    dropped_spans,
    new_trace_id,
    span,
    spans,
    tracing_enabled,
)

__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "HealthWatch",
    "Heartbeat",
    "Histogram",
    "MetricsRegistry",
    "add_span",
    "chrome_trace",
    "clear",
    "compile_event_seq",
    "compile_events",
    "compile_events_since",
    "configure",
    "dropped_spans",
    "flight_configure",
    "flight_enabled",
    "flight_record",
    "flight_recorder",
    "get_registry",
    "new_trace_id",
    "record_compile_event",
    "span",
    "spans",
    "tracing_enabled",
]
