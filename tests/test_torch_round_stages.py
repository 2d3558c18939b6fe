"""The facade's stage spans (``obs/tracer.py:STAGE_SPANS``) in a round's
ledger, on the CPU:

- a round dispatched through ``handle_queries_async`` carries exactly the
  five stages besides the spans it had, each inside its declared parent,
  in the order pack < upload < admit < launch < download, none negative,
  and ``round`` opens with ``pack``;
- the round tracer takes them and exports them on the host track, and
  still refuses an undeclared name (the policy gate's side is
  ``tests/test_torch_telemetry_policy.py``);
- the leak monitor's flight recorder and the workload telemetry see only
  their own schemas (the canonical phases and ``round``; the utilization
  spans);
- the cost monitor scores the event-timed device span when it has one and
  the host-observed ``device`` span otherwise; on the CPU a round has no
  event-timed span.

The card's side (``device_span_s`` from CUDA events, no host sync) is
``tests/test_torch_obs.py -k cuda``."""

import random

import pytest

from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.obs import attach_round_observability, costmon, registry
from grapevine_tpu_torch.obs.flightrec import ALLOWED_PHASE_KEYS
from grapevine_tpu_torch.obs.leakmon import EngineLeakMonitor, LeakMonitorConfig
from grapevine_tpu_torch.obs.tracer import STAGE_PARENTS, STAGE_SPANS
from grapevine_tpu_torch.obs.workload import UTILIZATION_SPANS
from test_torch_pipeline import NOW0, TOY, _campaign_reqs
from _torch_threads import one_torch_thread  # noqa: F401

#: the spans a direct-path round had before the stages, per engine:
#: (pipeline depth, evict_every, durable) -> names
CASES = {
    (1, 1, False): {"dispatch", "evict", "demux", "device", "round"},
    (2, 2, False): {"dispatch", "evict", "demux", "device", "round", "flush"},
    (2, 1, True): {"dispatch", "evict", "demux", "device", "round", "journal"},
}


def _engine(depth, evict_every, durable, tmp_path) -> GrapevineEngine:
    dur = DurabilityConfig(state_dir=str(tmp_path / "state")) if durable else None
    cfg = GrapevineConfig(pipeline_depth=depth, evict_every=evict_every, **TOY)
    return GrapevineEngine(cfg, seed=3, device="cpu", durability=dur)


def _rounds(eng, calls: int = 4) -> list:
    """``calls`` rounds through the async facade, resolved in order at the
    engine's depth; their handles."""
    rng = random.Random(5)
    done, pending = [], []
    for i in range(calls):
        pending.append(eng.handle_queries_async(_campaign_reqs(rng, 4), NOW0 + i))
        if len(pending) >= eng.pipeline_depth:
            p = pending.pop(0)
            p.resolve()
            done.append(p)
    for p in pending:
        p.resolve()
        done.append(p)
    return done


@pytest.mark.parametrize("depth,evict_every,durable", sorted(CASES))
def test_a_round_ledger_nests_the_five_stages(depth, evict_every, durable, tmp_path):
    eng = _engine(depth, evict_every, durable, tmp_path)
    try:
        rounds = _rounds(eng)
    finally:
        eng.close()
    before = CASES[(depth, evict_every, durable)]
    flushed = 0
    for p in rounds:
        spans = p.spans
        flushed += "flush" in spans
        assert set(spans) - {"flush"} == (before - {"flush"}) | set(STAGE_SPANS)
        assert all(d >= 0.0 for _s, d in spans.values())
        for stage, parent in STAGE_PARENTS.items():
            (s, d), (ps, pd) = spans[stage], spans[parent]
            assert ps <= s and s + d <= ps + pd, (stage, parent)
        ends = [spans[n][0] + spans[n][1] for n in STAGE_SPANS]
        starts = [spans[n][0] for n in STAGE_SPANS]
        assert all(e <= s for e, s in zip(ends, starts[1:])), "stages out of order"
        assert spans["round"][0] == spans["pack"][0]
        if "journal" in spans:  # the journal's barrier comes before the upload
            assert spans["journal"][0] + spans["journal"][1] <= spans["upload"][0]
        assert p.device_span_s is None  # no CUDA events on the CPU
    assert bool(flushed) == ("flush" in before)


def test_the_tracer_exports_the_stages_and_refuses_other_names():
    eng = GrapevineEngine(GrapevineConfig(pipeline_depth=1, **TOY), seed=3, device="cpu")
    try:
        tr, _slo, _prof = attach_round_observability(eng, eng.metrics.registry,
                                                     trace_ring_size=8)
        _rounds(eng, calls=3)
        util = eng.workload.utilization()
    finally:
        eng.close()
    events = [e for e in tr.chrome_trace()["traceEvents"] if e["ph"] == "X"]
    by_name: dict = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    for stage in STAGE_SPANS:
        evs = by_name[f"grapevine/{stage}"]
        assert len(evs) == 3 and all(e["tid"] in (1, 2) for e in evs)  # the host track
    assert len(tr.span_durations_ms("launch")) == 3
    assert set(util) == set(UTILIZATION_SPANS)
    for bad in ({"pack": (0.0, 1.0), "pack_op_read": (0.0, 1.0)}, {"launch": (0.0, -1.0)}):
        with pytest.raises(registry.TelemetryLeakError):
            tr.record_round(bad)


def test_the_flight_recorder_sees_only_its_phases():
    eng = GrapevineEngine(GrapevineConfig(pipeline_depth=2, **TOY), seed=3, device="cpu")
    lm = EngineLeakMonitor.for_engine(eng, LeakMonitorConfig(window_rounds=64,
                                                             min_pooled_leaves=64))
    eng.attach_leakmon(lm)
    try:
        _rounds(eng, calls=4)
        assert lm.flush()
        rows = lm.recorder.dump()["rounds"]
        assert lm.verdict()["rounds_observed"] == 4
    finally:
        lm.close()
        eng.close()
    assert len(rows) == 4
    for r in rows:
        assert set(r["phase_s"]) == {"dispatch", "evict", "demux", "round"}
        assert set(r["phase_s"]) <= ALLOWED_PHASE_KEYS


def test_the_cost_monitor_prefers_the_event_timed_device_span():
    ecfg = EngineConfig.from_config(GrapevineConfig(**TOY))
    reg = registry.TelemetryRegistry()
    mon = costmon.CostMonitor(ecfg, reg, device_type="cpu")
    spans = {"device": (1.0, 0.2), "round": (1.0, 0.3)}
    mon.observe_round(spans, device_span_s=0.05)
    assert reg.snapshot()["grapevine_cost_roofline_residual"] == 0.05 * 1e3 / mon.floor_ms
    mon.observe_round(spans)
    snap = reg.snapshot()
    assert snap["grapevine_cost_roofline_residual"] == 0.2 * 1e3 / mon.floor_ms
    assert snap["grapevine_cost_roofline_residual_max"] == 0.2 * 1e3 / mon.floor_ms
