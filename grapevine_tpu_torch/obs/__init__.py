"""Obliviousness-safe observability (port of ``grapevine_tpu/obs``, the
part ported so far).

- ``registry``: the TelemetryRegistry (counters, gauges, histograms with
  fixed buckets) whose label-key allowlist and declared label values make
  a per-client or per-op series a registration-time error, and whose
  ``audit()`` re-checks the whole registry;
- ``phases``: the canonical round-phase names, wall-clock phase timers
  feeding the registry, and ``torch.profiler`` ranges;
- ``exporter``: Prometheus text exposition of a registry;
- ``httpd``: a stdlib ``http.server`` thread serving ``/metrics`` and
  ``/healthz``.

The leak monitor, flight recorder, round tracer, SLO tracker, profiler
gate, workload and cost telemetry and the fleet aggregator are ROADMAP.md
queue A item 16.
"""

from .registry import (  # noqa: F401
    ALLOWED_LABEL_KEYS,
    FORBIDDEN_LABEL_KEYS,
    Counter,
    Gauge,
    Histogram,
    TelemetryLeakError,
    TelemetryRegistry,
)
from .phases import PHASES, device_phase, phase_timer  # noqa: F401
from .exporter import render_prometheus  # noqa: F401
from .httpd import MetricsServer  # noqa: F401
