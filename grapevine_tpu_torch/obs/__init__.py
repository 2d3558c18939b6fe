"""Obliviousness-safe observability (port of ``grapevine_tpu/obs``).

- ``registry``: the TelemetryRegistry (counters, gauges, histograms with
  fixed buckets) whose label-key allowlist and declared label values make
  a per-client or per-op series a registration-time error, and whose
  ``audit()`` re-checks the whole registry;
- ``phases``: the canonical round-phase names, wall-clock phase timers
  feeding the registry, and ``torch.profiler`` ranges;
- ``exporter``: Prometheus text exposition of a registry;
- ``httpd``: a stdlib ``http.server`` thread serving ``/metrics``,
  ``/healthz``, ``/leakaudit``, ``/flightrec``, ``/trace`` and
  ``/profile``;
- ``leakmon``: the streaming transcript leak monitor — the detectors of
  ``testing/leakcheck.py`` run continuously over a sliding window of
  production rounds on the monitor's own thread, publishing
  aggregate-only statistics and a PASS/SUSPECT verdict;
- ``flightrec``: a fixed-size ring of schema-checked per-round
  summaries, dumped on demand or on a PASS→SUSPECT transition;
- ``tracer``: the round-trace profiler — a fixed ring of per-round span
  ledgers exported as Chrome trace-event JSON plus the derived
  host/device bubble-ratio gauge;
- ``slo``: end-to-end commit-latency SLOs with multi-window burn-rate
  alerting folded into ``/healthz``;
- ``profiler``: the gated ``torch.profiler`` capture of a live engine
  (``/profile?ms=N``, ``--profile-enable``);
- ``workload``: batch-level workload telemetry (fill, queue depth,
  arrival-rate EWMA, per-phase utilization, saturation counters);
- ``costmon``: the modeled round-cost ledger (``analysis/costmodel.py``)
  and the per-round roofline residual;
- ``fleet``: the multi-process scrape aggregator with the cross-shard
  schedule-uniformity detectors (``leakmon.FleetUniformityMonitor``).
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
from .flightrec import FlightRecorder  # noqa: F401
from .leakmon import (  # noqa: F401
    EngineLeakMonitor,
    FleetUniformityConfig,
    FleetUniformityMonitor,
    LeakMonitorConfig,
    TranscriptLeakMonitor,
)
from .fleet import FleetAggregator, FleetConfig, parse_exposition  # noqa: F401
from .tracer import RoundTracer  # noqa: F401
from .slo import SloConfig, SloTracker  # noqa: F401
from .profiler import ProfilerBusy, ProfilerGate  # noqa: F401
from .workload import WorkloadTelemetry  # noqa: F401
from .costmon import CostMonitor  # noqa: F401


def attach_round_observability(engine, registry, *, trace_ring_size=512,
                               slo=None, profile_enable=False):
    """Attach the round tracer + commit-latency SLO + workload and cost
    telemetry (always on for the device owner — each costs a few
    dict/histogram ops per ROUND, not per op) and the optional profiler
    gate to ``engine``; the ONE place the serving layers
    (server/service.py, server/tier.py) share the policy.

    No explicit SLO config = observe-only (server/cli.py ``_slo_config``):
    latencies and burn rates export, but /healthz only gates once an
    operator-supplied config enforces a target. The profiler gate stays
    opt-in (``--profile-enable``): a capture has real overhead and writes
    traces to disk.

    Returns ``(tracer, slo_tracker, profiler_or_None)``.
    """
    tracer = RoundTracer(capacity=trace_ring_size, registry=registry)
    engine.attach_tracer(tracer)
    slo_tracker = SloTracker(
        slo if slo is not None else SloConfig(enforce=False),
        registry=registry,
    )
    engine.attach_slo(slo_tracker)
    # the queue-depth signal the adaptive batcher needs exists on every
    # device-owning engine, not only under a load harness
    engine.attach_workload(
        WorkloadTelemetry(registry, batch_size=engine.ecfg.batch_size)
    )
    # the static grapevine_cost_* ledger plus the per-round roofline
    # residual against the round's device span (CUDA events on the card,
    # the tracer's host-observed one elsewhere), at the bandwidth of the
    # engine's device type
    engine.attach_costmon(CostMonitor(engine.ecfg, registry,
                                      device_type=engine.device.type))
    gate = ProfilerGate(device_type=engine.device.type) if profile_enable else None
    return tracer, slo_tracker, gate
