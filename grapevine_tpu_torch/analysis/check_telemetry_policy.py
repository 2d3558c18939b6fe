"""Telemetry leak-policy gate (port of ``tools/check_telemetry_policy.py``).

Two passes, as ``testing/leakcheck.py`` checks the transcript:

1. **Static scan** — every instrumentation call site under
   ``grapevine_tpu_torch/`` (or ``root=``) is searched for forbidden label
   keys (per-client / per-op dimensions). A kwarg like ``op_type=`` on a
   ``labels()``/``inc()``/``observe()`` call, or a forbidden key inside a
   ``labels={...}`` registration, fails with its ``file:line`` before the
   code ever runs. The keys are the port's own
   ``obs.registry.FORBIDDEN_LABEL_KEYS``.
2. **Registry audits** — each namespace's registry is built as the port
   builds it and must pass ``TelemetryRegistry.audit()`` (every label key
   allowlisted, every series declared, every histogram's buckets fixed),
   plus the namespace's own rule and its "teeth" (a leaky registration or
   record must raise ``TelemetryLeakError``): the shipped engine registry,
   the leak monitor, the tracer and SLO tracker, the workload telemetry,
   the eviction canaries, the fleet aggregator, the cost monitor and the
   host serving pipeline. :func:`audit_live_registry` applies the same
   namespace rules to a running engine's registry.

Exit 0 = the policy holds; exit 1 = a violation, printed with its place.

    python -m grapevine_tpu_torch.analysis.check_telemetry_policy
"""

from __future__ import annotations

import os
import re
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _forbidden() -> tuple:
    from ..obs.registry import FORBIDDEN_LABEL_KEYS

    return tuple(sorted(FORBIDDEN_LABEL_KEYS))


#: telemetry call sites: sample calls with label kwargs, and registration
#: calls with a labels= declaration
_CALL_RE = re.compile(r"\.(?:labels|inc|observe|set|set_max|counter|gauge|histogram)\(")

#: the label keys each namespace may carry (a family's only dimensions)
NAMESPACE_KEYS = {
    "grapevine_leakmon_": {"tree"},
    "grapevine_trace_": set(),
    "grapevine_slo_": set(),
    "grapevine_round_bubble_ratio": set(),
    "grapevine_load_": {"phase"},
    "grapevine_evict_buffer_": set(),
    "grapevine_fleet_": {"shard"},
    "grapevine_cost_": {"phase"},
    "grapevine_host_": {"phase", "worker"},
}


def _call_site_spans(text: str):
    """``(lineno, span)`` for each telemetry call, the span running through
    its closing paren (label kwargs may sit on continuation lines)."""
    for m in _CALL_RE.finditer(text):
        start = m.end() - 1  # the opening paren
        depth, end = 0, start
        for i in range(start, min(len(text), start + 2000)):
            c = text[i]
            if c == "(":
                depth += 1
            elif c == ")":
                depth -= 1
                if depth == 0:
                    end = i + 1
                    break
        yield text.count("\n", 0, m.start()) + 1, text[m.start():end]


def scan_call_sites(root: str = PKG) -> list:
    """Static pass: forbidden label keys at instrumentation call sites
    under ``root``, as ``file:line: ...`` strings (paths relative to
    ``root``'s parent)."""
    keys = _forbidden()
    kwarg_res = [(k, re.compile(rf"[(,]\s*{k}\s*=")) for k in keys]
    decl_res = [(k, re.compile(rf"""labels\s*=\s*\{{[^}}]*['"]{k}['"]""")) for k in keys]
    base = os.path.dirname(os.path.abspath(root))
    violations = []
    for dirpath, dirnames, names in os.walk(root):
        dirnames.sort()
        for name in sorted(names):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, base)
            with open(path, encoding="utf-8") as fh:
                text = fh.read()
            for lineno, span in _call_site_spans(text):
                for key, rx in kwarg_res:
                    if rx.search(span):
                        violations.append(f"{rel}:{lineno}: telemetry call passes "
                                          f"forbidden label key {key!r}")
            for key, rx in decl_res:
                for m in rx.finditer(text):
                    lineno = text.count("\n", 0, m.start()) + 1
                    violations.append(f"{rel}:{lineno}: metric registration declares "
                                      f"forbidden label key {key!r}")
    return violations


class PolicyViolation(SystemExit):
    """A registry audit's finding (exits 1 when it escapes ``main``)."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self.msg = msg


def _fail(msg: str):
    raise PolicyViolation(msg)


def check_namespace(reg, prefix: str) -> list:
    """The families of one namespace, each carrying only its allowed label
    keys (:data:`NAMESPACE_KEYS`)."""
    allowed = NAMESPACE_KEYS[prefix]
    fams = [m for m in reg.collect() if m.name.startswith(prefix)]
    for m in fams:
        bad = set(m.label_keys) - set(allowed)
        if bad:
            _fail(f"metric {m.name!r} carries label keys {sorted(bad)} — the "
                  f"{prefix}* namespace admits only {sorted(allowed) or 'none'}")
    return fams


def _teeth(register, cases, what: str) -> None:
    """Each ``labels`` of ``cases`` must be refused at registration."""
    from ..obs.registry import TelemetryLeakError

    for labels, why in cases:
        try:
            register(labels)
        except TelemetryLeakError:
            continue
        _fail(f"{what} label policy has no teeth: {why} was accepted at registration")


def audit_shipped_registry() -> dict:
    """The registry ``EngineMetrics`` ships (what /metrics exports) must
    pass audit."""
    from ..engine.metrics import EngineMetrics

    return EngineMetrics().registry.audit()


def audit_leakmon_registry() -> dict:
    """The leak monitor's ``grapevine_leakmon_*`` families exist and carry
    only the ``tree`` key."""
    from ..engine.metrics import EngineMetrics
    from ..obs.flightrec import FlightRecorder
    from ..obs.leakmon import EngineLeakMonitor

    em = EngineMetrics()
    mon = EngineLeakMonitor(mb_leaves=1 << 4, rec_leaves=1 << 7, mb_choices=2,
                            registry=em.registry, recorder=FlightRecorder(capacity=8))
    try:
        report = em.registry.audit()
        fams = check_namespace(em.registry, "grapevine_leakmon_")
        if not fams:
            _fail("leakmon namespace missing: EngineLeakMonitor registered no "
                  "grapevine_leakmon_* metrics")
        report["leakmon_families"] = len(fams)
        return report
    finally:
        mon.close()


def audit_trace_slo_registry() -> dict:
    """The tracer's and SLO tracker's families and the bubble gauge carry
    no label key; the span allowlist is the phase vocabulary, the two
    derived windows and the facade's declared stages; the ring refuses a
    per-op span name and a malformed span."""
    from ..engine.metrics import EngineMetrics
    from ..obs.phases import PHASES
    from ..obs.registry import TelemetryLeakError
    from ..obs.slo import SloTracker
    from ..obs.tracer import ALLOWED_SPAN_NAMES, STAGE_SPANS, RoundTracer

    em = EngineMetrics()
    tracer = RoundTracer(capacity=8, registry=em.registry)
    SloTracker(registry=em.registry)
    report = em.registry.audit()
    fams = [m for p in ("grapevine_trace_", "grapevine_slo_", "grapevine_round_bubble_ratio")
            for m in check_namespace(em.registry, p)]
    if len(fams) < 3:
        _fail(f"trace/slo namespace missing: registered only {[m.name for m in fams]}")
    stray = ALLOWED_SPAN_NAMES - set(PHASES) - {"device", "round"} - set(STAGE_SPANS)
    if stray:
        _fail(f"tracer span allowlist drifted outside the phase vocabulary: {sorted(stray)}")
    for bad_ledger, why in (({"op_read": (0.0, 1.0)}, "per-op span name"),
                            ({"evict": "not-a-span"}, "non-(start,dur) span value"),
                            ({"evict": (0.0, -1.0)}, "negative duration")):
        try:
            tracer.record_round(bad_ledger)
        except TelemetryLeakError:
            continue
        _fail(f"tracer ring schema has no teeth: {why} was accepted")
    report["trace_slo_families"] = len(fams)
    return report


def audit_workload_registry() -> dict:
    """The ``grapevine_load_*`` families exist, carry only ``phase``, keep
    their registration-time buckets; the flight recorder refuses an
    array-valued ``queue_depth``."""
    from ..engine.metrics import EngineMetrics
    from ..obs.flightrec import FlightRecorder
    from ..obs.registry import TelemetryLeakError
    from ..obs.workload import DEPTH_BUCKETS, FILL_BUCKETS, WorkloadTelemetry

    em = EngineMetrics()
    WorkloadTelemetry(em.registry, batch_size=256)
    report = em.registry.audit()
    fams = check_namespace(em.registry, "grapevine_load_")
    if len(fams) < 6:
        _fail(f"workload namespace missing: registered only {[m.name for m in fams]}")
    fill = em.registry.get("grapevine_load_batch_fill")
    depth = em.registry.get("grapevine_load_queue_depth")
    if fill is None or fill.buckets != tuple(FILL_BUCKETS):
        _fail("fill histogram buckets drifted from the registration-time constants")
    if depth is None or depth.buckets != tuple(DEPTH_BUCKETS):
        _fail("depth histogram buckets drifted from the registration-time constants")
    fr = FlightRecorder(capacity=2)
    fr.record({"seq": 1, "fill": 0.5, "queue_depth": 17})  # a scalar: fine
    try:
        fr.record({"seq": 2, "queue_depth": [1, 2, 3]})
    except TelemetryLeakError:
        pass
    else:
        _fail("flight recorder accepted an array-valued queue_depth — the batch-level "
              "schema has no teeth")
    report["workload_families"] = len(fams)
    return report


def audit_evict_registry() -> dict:
    """The eviction canaries exist label-free; ``flush`` is a declared
    phase; the phase histogram refuses a window-numbered phase."""
    from ..engine.metrics import EngineMetrics
    from ..obs.flightrec import ALLOWED_PHASE_KEYS
    from ..obs.phases import PHASES
    from ..obs.registry import TelemetryLeakError

    if "flush" not in PHASES:
        _fail("'flush' missing from obs.phases.PHASES")
    if "flush" not in ALLOWED_PHASE_KEYS:
        _fail("'flush' missing from the flight recorder's phase schema")
    em = EngineMetrics()
    report = em.registry.audit()
    for name in ("grapevine_evict_buffer_occupancy", "grapevine_evict_buffer_high_water"):
        m = em.registry.get(name)
        if m is None:
            _fail(f"eviction canary {name!r} not registered")
        if m.label_keys:
            _fail(f"eviction canary {name!r} carries label keys {sorted(m.label_keys)}")
    em.observe_phase("flush", 0.001)  # a declared value: fine
    try:
        em.observe_phase("flush_w3", 0.001)
    except TelemetryLeakError:
        pass
    else:
        _fail("phase histogram accepted the window-numbered phase 'flush_w3'")
    return report


def audit_fleet_registry() -> dict:
    """``shard`` is the fleet namespace's only key, its values bare
    integer indices; the uniformity exports are label-free; a member name,
    an address or a ``member`` key is refused at registration."""
    from ..obs.fleet import FleetAggregator, FleetConfig
    from ..obs.registry import TelemetryRegistry

    agg = FleetAggregator(FleetConfig(members=("h0:1", "h1:1", "h2:1")))
    report = agg.registry.audit()
    fams = check_namespace(agg.registry, "grapevine_fleet_")
    if len(fams) < 8:
        _fail(f"fleet namespace missing: registered only {[m.name for m in fams]}")
    for m in fams:
        for v in m.labels_decl.get("shard", ()):
            if not (v.isascii() and v.isdigit()):
                _fail(f"fleet metric {m.name!r} declares shard value {v!r}")
    for det in ("cadence_ratio", "fill_load_correlation", "flush_phase"):
        for kind in ("statistic", "threshold"):
            name = f"grapevine_fleet_uniformity_{det}_{kind}"
            m = agg.registry.get(name)
            if m is None:
                _fail(f"uniformity export {name!r} missing")
            if m.label_keys:
                _fail(f"uniformity export {name!r} carries label keys {list(m.label_keys)}")
    if agg.registry.get("grapevine_fleet_uniformity_suspect") is None:
        _fail("uniformity verdict gauge missing")
    r = TelemetryRegistry()
    _teeth(lambda lb: r.gauge("grapevine_fleet_teeth_probe", "probe", labels=lb),
           (({"shard": ("engine-a.internal",)}, "member-name shard value"),
            ({"shard": ("10.0.0.7:9464",)}, "address shard value"),
            ({"member": ("0",)}, "'member' label key")), "fleet")
    report["fleet_families"] = len(fams)
    return report


def audit_cost_registry() -> dict:
    """The ``grapevine_cost_*`` families exist, carry only ``phase`` with
    the model's fixed schedule names; the roofline exports are label-free;
    a geometry-shaped key is refused at registration."""
    from ..config import GrapevineConfig
    from ..engine.state import EngineConfig
    from ..obs.costmon import CostMonitor
    from ..obs.registry import TelemetryRegistry

    reg = TelemetryRegistry()
    ecfg = EngineConfig.from_config(GrapevineConfig(max_messages=1 << 10,
                                                    max_recipients=1 << 7, batch_size=8))
    CostMonitor(ecfg, reg, bandwidth_gbps=8.0)
    report = reg.audit()
    fams = check_cost_families(reg)
    if len(fams) < 9:
        _fail(f"cost namespace missing: registered only {[m.name for m in fams]}")
    r = TelemetryRegistry()
    _teeth(lambda lb: r.gauge("grapevine_cost_teeth_probe", "probe", labels=lb),
           (({"capacity": ("65536",)}, "geometry-value 'capacity' label key"),
            ({"geometry": ("h14_z4",)}, "'geometry' label key"),
            ({"leaf": ("12",)}, "'leaf' label key")), "cost")
    report["cost_families"] = len(fams)
    return report


def check_cost_families(reg) -> list:
    from .costmodel import COST_PHASES

    fams = check_namespace(reg, "grapevine_cost_")
    for m in fams:
        for v in m.labels_decl.get("phase", ()):
            if v not in COST_PHASES:
                _fail(f"cost metric {m.name!r} declares phase value {v!r} — values must "
                      f"be the fixed schedule names {COST_PHASES}")
    for name in ("grapevine_cost_roofline_residual", "grapevine_cost_roofline_floor_ms",
                 "grapevine_cost_steady_round_hbm_bytes"):
        m = reg.get(name)
        if fams and m is None:
            _fail(f"cost export {name!r} missing")
        if m is not None and m.label_keys:
            _fail(f"cost export {name!r} carries label keys {list(m.label_keys)}")
    return fams


def audit_host_registry() -> dict:
    """The serving layer's ``grapevine_host_*`` families (a real
    ``HostPipeline`` of two worker processes, an ``AdaptiveBatchPolicy``
    and a flush-windowed ``BatchScheduler`` on one registry) carry only
    ``phase`` and ``worker``, the workers the pool's indices; a
    channel-shaped worker value or a ``channel_id`` key is refused."""
    from ..obs.registry import TelemetryRegistry
    from ..server.adaptive import DECISION_KINDS, AdaptiveBatchPolicy
    from ..server.hostpipe import TASK_KINDS, HostPipeline
    from ..server.scheduler import BatchScheduler

    reg = TelemetryRegistry()
    pipe = HostPipeline(workers=2, registry=reg)
    sched = None
    try:
        AdaptiveBatchPolicy(8, 0.008, 0.002, registry=reg)

        class _Ecfg:
            batch_size = 8

        class _Metrics:
            registry = reg

        class _Engine:
            ecfg = _Ecfg()
            metrics = _Metrics()

        sched = BatchScheduler(_Engine(), flush_window_ms=4.0)
    finally:
        if sched is not None:
            sched.close()
        pipe.close()
    report = reg.audit()
    fams = check_host_families(reg)
    if len(fams) < 9:
        _fail(f"host namespace missing: registered only {[m.name for m in fams]}")
    tasks = reg.get("grapevine_host_tasks_total")
    if tasks is None or tuple(tasks.labels_decl["worker"]) != ("0", "1"):
        _fail("grapevine_host_tasks_total worker values drifted from the pool indices")
    for v in tasks.labels_decl["phase"]:
        if v not in TASK_KINDS:
            _fail(f"grapevine_host_tasks_total declares phase {v!r}")
    dec = reg.get("grapevine_host_adaptive_decisions_total")
    if dec is None:
        _fail("adaptive decision counter missing")
    for v in dec.labels_decl["phase"]:
        if v not in DECISION_KINDS:
            _fail(f"adaptive decision counter declares phase {v!r}")
    r = TelemetryRegistry()
    _teeth(lambda lb: r.counter("grapevine_host_teeth_probe", "probe", labels=lb),
           (({"worker": ("deadbeef" * 4,)}, "channel-id-shaped worker value"),
            ({"worker": ("w0",)}, "non-digit worker value"),
            ({"channel_id": ("0",)}, "'channel_id' label key")), "host")
    report["host_families"] = len(fams)
    return report


def check_host_families(reg) -> list:
    fams = check_namespace(reg, "grapevine_host_")
    for m in fams:
        for v in m.labels_decl.get("worker", ()):
            if not v.isdigit():
                _fail(f"host metric {m.name!r} declares worker value {v!r}")
    return fams


def audit_live_registry(registry) -> dict:
    """The audits' rules on a running engine's registry (as /metrics
    serves it): ``audit()``, then every namespace present holds its label
    rule, the cost and host families their value rules. Returns the audit
    report with the families seen per namespace."""
    report = registry.audit()
    seen = {}
    for prefix in NAMESPACE_KEYS:
        seen[prefix] = len(check_namespace(registry, prefix))
    check_cost_families(registry)
    check_host_families(registry)
    report["namespaces"] = {p: n for p, n in seen.items() if n}
    return report


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=PKG, help="the tree to scan (default: the port)")
    args = ap.parse_args(argv)
    violations = scan_call_sites(args.root)
    for v in violations:
        print(f"TELEMETRY POLICY VIOLATION: {v}", file=sys.stderr)
    try:
        report = audit_shipped_registry()
        lm = audit_leakmon_registry()
        ts = audit_trace_slo_registry()
        wl = audit_workload_registry()
        audit_evict_registry()
        fl = audit_fleet_registry()
        cost = audit_cost_registry()
        host = audit_host_registry()
    except PolicyViolation as exc:
        print(f"TELEMETRY POLICY VIOLATION: {exc.msg}", file=sys.stderr)
        return 1
    print(
        f"telemetry policy: static scan {'FAILED' if violations else 'clean'}; registry "
        f"audit ok ({report['metrics']} metrics, {report['series']} series); leakmon audit "
        f"ok ({lm['leakmon_families']} families, {lm['series']} series incl. engine); "
        f"trace/slo audit ok ({ts['trace_slo_families']} families, ring schema enforced); "
        f"workload audit ok ({wl['workload_families']} families, fixed buckets, depth-field "
        "teeth); evict audit ok (label-free buffer canaries, flush phase declared, teeth); "
        f"fleet audit ok ({fl['fleet_families']} families, shard-only integer labels, "
        f"teeth); cost audit ok ({cost['cost_families']} families, phase-only labels, fixed "
        f"schedule values, teeth); host audit ok ({host['host_families']} families, "
        "phase/worker-only labels, digit worker indices, teeth)")
    if violations:
        return 1
    print("[check_telemetry_policy] PASS: no forbidden label key at a call site; every "
          "namespace's registry holds its policy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
