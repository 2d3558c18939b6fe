"""The port's round observers held against the JAX package's, at
tolerance 0 (pure Python and numpy on the same inputs):

- ``RoundTracer`` fed the same span ledgers: the ring, the Chrome trace,
  the bubble ratio, span durations and the schema's refusals;
- ``SloTracker`` on an injected clock: burn rates and verdicts;
- ``WorkloadTelemetry`` on an injected clock: the arrival EWMA,
  utilization, saturation and backpressure counters;
- ``AdaptiveBatchPolicy.decide`` over the same depths and signals;
- ``analysis/costmodel.py:engine_cost_ledger`` at four geometries across
  the eviction cadence E, the tree-top cache depth k, the cipher and the
  mailbox choices, and ``CostMonitor``'s gauges and residual;
- each pair's registries render the same Prometheus text byte for byte
  (``grapevine_load_phase_utilization``'s HELP names the span ledgers'
  origin in its own words in each package, and is compared with that
  phrase cut out);
- the port's ``ProfilerGate``: a capture from another thread records the
  working thread's ops, a second capture is refused with ``ProfilerBusy``.

The reference modules are imported inside the tests, so the card tests
at the end run without JAX: ``python -m pytest --noconftest
tests/test_torch_obs.py -k cuda`` (a depth-2 round with the leak monitor
on under ``set_sync_debug_mode("error")``, and a profiler capture from
another thread holding the collector thread's B3 and B5 kernels).
"""

import json
import os
import random
import re
import threading

import numpy as np
import pytest
import torch

from grapevine_tpu_torch.analysis import costmodel
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.obs import costmon, exporter, registry, slo, tracer, workload
from grapevine_tpu_torch.obs.profiler import ProfilerBusy, ProfilerGate, exclusive_profile
from grapevine_tpu_torch.server import adaptive

SPAN_NAMES = ("assembly", "verify", "dispatch", "journal", "checkpoint", "evict", "demux",
              "flush", "device")


def _ref():
    from grapevine_tpu.obs import exporter as rex
    from grapevine_tpu.obs import registry as rreg
    from grapevine_tpu.obs import slo as rslo
    from grapevine_tpu.obs import tracer as rtr
    from grapevine_tpu.obs import workload as rwl

    return rex, rreg, rslo, rtr, rwl


def _renders_equal(reg, ref_reg):
    rex = _ref()[0]
    ours, theirs = exporter.render_prometheus(reg), rex.render_prometheus(ref_reg)
    cut = re.compile(r"(# HELP grapevine_load_phase_utilization .*?\(from the ).*?( span "
                     r"ledgers;)")
    assert cut.sub(r"\1\2", ours) == cut.sub(r"\1\2", theirs)
    return ours


def _ledger(rng: random.Random, t0: float) -> dict:
    spans = {}
    for name in SPAN_NAMES:
        if rng.random() < 0.8:
            spans[name] = (t0 + rng.random() * 0.01, rng.random() * 0.02)
    spans["round"] = (t0, 0.05 + rng.random() * 0.01)
    return spans


@pytest.mark.parametrize("capacity,window", [(4, 64), (16, 3)])
def test_round_tracer_equals_reference(capacity, window):
    _, rreg, _, rtr, _ = _ref()
    reg, jreg = registry.TelemetryRegistry(), rreg.TelemetryRegistry()
    ours = tracer.RoundTracer(capacity, reg, bubble_window=window)
    theirs = rtr.RoundTracer(capacity, jreg, bubble_window=window)
    rng = random.Random(capacity)
    for i in range(11):
        spans = _ledger(rng, 100.0 + i * 0.05)
        ours.record_round(spans)
        theirs.record_round(spans)
        assert ours.chrome_trace() == theirs.chrome_trace()
        assert ours.bubble_ratio() == theirs.bubble_ratio()
    assert ours.chrome_trace_json() == theirs.chrome_trace_json()
    for name in ("evict", "journal", "round"):
        assert ours.span_durations_ms(name) == theirs.span_durations_ms(name)
    _renders_equal(reg, jreg)
    for bad in ({"op_read": (0.0, 1.0)}, {"evict": "x"}, {"evict": (0.0, -1.0)}, [1]):
        with pytest.raises(registry.TelemetryLeakError) as e1:
            ours.record_round(bad)
        with pytest.raises(rreg.TelemetryLeakError) as e2:
            theirs.record_round(bad)
        assert str(e1.value) == str(e2.value)
    with pytest.raises(ValueError):
        ours.span_durations_ms("op")


@pytest.mark.parametrize("enforce", [True, False])
def test_slo_tracker_equals_reference(enforce):
    _, rreg, rslo, _, _ = _ref()
    now = [1000.0]
    kw = dict(commit_p99_ms=50.0, enforce=enforce, fast_window_s=10.0,
              slow_window_s=60.0, min_rounds=8)
    reg, jreg = registry.TelemetryRegistry(), rreg.TelemetryRegistry()
    ours = slo.SloTracker(slo.SloConfig(**kw), reg, clock=lambda: now[0])
    theirs = rslo.SloTracker(rslo.SloConfig(**kw), jreg, clock=lambda: now[0])
    rng = np.random.default_rng(4)
    for i in range(120):
        lat = float(rng.exponential(0.02 if i < 60 else 0.2))
        ours.observe(lat)
        theirs.observe(lat)
        now[0] += 0.7
        if i % 10 == 9:
            assert ours.burn_rates() == theirs.burn_rates()
            assert ours.verdict() == theirs.verdict()
    v = ours.verdict()
    assert v["alerting"] and v["ok"] is (not enforce)
    _renders_equal(reg, jreg)
    with pytest.raises(ValueError):
        slo.SloTracker(slo.SloConfig(error_budget=0.0))


def test_workload_telemetry_equals_reference():
    _, rreg, _, _, rwl = _ref()
    now = [50.0]
    reg, jreg = registry.TelemetryRegistry(), rreg.TelemetryRegistry()
    ours = workload.WorkloadTelemetry(reg, batch_size=8, clock=lambda: now[0])
    theirs = rwl.WorkloadTelemetry(jreg, batch_size=8, clock=lambda: now[0])
    rng = random.Random(9)
    for i in range(60):
        depth = rng.randrange(0, 20)
        ours.note_arrival(depth)
        theirs.note_arrival(depth)
        now[0] += rng.random() * 0.05
        if i % 5 == 4:
            n, q = rng.randrange(1, 9), rng.choice([None, rng.randrange(0, 30)])
            spans = _ledger(rng, now[0])
            ours.observe_round(n, 8, q, spans)
            theirs.observe_round(n, 8, q, spans)
            assert ours.arrival_rate() == theirs.arrival_rate()
            assert ours.utilization() == theirs.utilization()
    ours.observe_round(8, 8, 3, None)
    theirs.observe_round(8, 8, 3, None)
    _renders_equal(reg, jreg)
    with pytest.raises(ValueError):
        workload.WorkloadTelemetry(reg, batch_size=0)


def test_adaptive_policy_decide_equals_reference():
    from grapevine_tpu.server import adaptive as radaptive

    _, rreg, rslo, _, rwl = _ref()
    now = [10.0]
    reg, jreg = registry.TelemetryRegistry(), rreg.TelemetryRegistry()
    wl = workload.WorkloadTelemetry(reg, batch_size=16, clock=lambda: now[0])
    jwl = rwl.WorkloadTelemetry(jreg, batch_size=16, clock=lambda: now[0])
    scfg = dict(commit_p99_ms=20.0, fast_window_s=5.0, slow_window_s=30.0)
    tr = slo.SloTracker(slo.SloConfig(**scfg), reg, clock=lambda: now[0])
    jtr = rslo.SloTracker(rslo.SloConfig(**scfg), jreg, clock=lambda: now[0])
    ours = adaptive.AdaptiveBatchPolicy(16, 0.1, 0.001, workload=wl, slo=tr, registry=reg)
    theirs = radaptive.AdaptiveBatchPolicy(16, 0.1, 0.001, workload=jwl, slo=jtr,
                                           registry=jreg)
    rng = random.Random(2)
    for i in range(200):
        for _ in range(rng.choice([0, 1, 5, 40])):
            wl.note_arrival(3)
            jwl.note_arrival(3)
            now[0] += 0.0002
        lat = 0.001 if i < 120 else 0.5
        tr.observe(lat)
        jtr.observe(lat)
        now[0] += 0.003
        depth = rng.choice([0, 2, 9, 16, 40])
        assert ours.decide(depth) == theirs.decide(depth)
    counts = {k: int(v) for k, v in reg.snapshot().items()
              if k.startswith("grapevine_host_adaptive_decisions_total")}
    assert all(counts.values()) and len(counts) == 4, counts
    _renders_equal(reg, jreg)
    with pytest.raises(ValueError):
        adaptive.AdaptiveBatchConfig(floor_wait_ms=0)
    assert adaptive.AdaptiveBatchPolicy(4, 0.01, 0.001).decide(0)[2] == 1


#: engine geometries for the cost ledger: (E, k, cipher rounds, choices)
COST_GEOS = [
    dict(max_messages=2**10, max_recipients=64, batch_size=8, evict_every=1,
         tree_top_cache_levels=0, bucket_cipher_rounds=8),
    dict(max_messages=2**12, max_recipients=2**8, batch_size=32, evict_every=2,
         tree_top_cache_levels=2, bucket_cipher_rounds=0),
    dict(max_messages=2**14, max_recipients=2**10, batch_size=64, evict_every=4,
         tree_top_cache_levels=4, bucket_cipher_rounds=8, mailbox_choices=2),
    dict(max_messages=2**20, max_recipients=2**12, batch_size=2048, evict_every=4,
         bucket_cipher_impl="pallas_fused"),
]


@pytest.mark.parametrize("geo", COST_GEOS, ids=lambda g: f"E{g['evict_every']}-"
                         f"k{g.get('tree_top_cache_levels')}-n{g['max_messages']}")
def test_cost_ledger_and_monitor_equal_reference(geo, monkeypatch):
    from grapevine_tpu.analysis import costmodel as rcm
    from grapevine_tpu.config import GrapevineConfig as JConfig
    from grapevine_tpu.engine.state import EngineConfig as JEngineConfig
    from grapevine_tpu.obs import costmon as rcostmon

    monkeypatch.delenv("GRAPEVINE_COST_GBPS", raising=False)
    geo = dict(geo, vphases_impl="dense")
    ecfg = EngineConfig.from_config(GrapevineConfig(**geo))
    jecfg = JEngineConfig.from_config(JConfig(**geo))
    for shards in (1, 2):
        ours = costmodel.engine_cost_ledger(ecfg, shards=shards)
        theirs = rcm.engine_cost_ledger(jecfg, shards=shards)
        assert ours.evict_every == theirs.evict_every and ours.shards == shards
        for ph in costmodel.COST_PHASES:
            assert vars(ours.phases[ph]) == vars(theirs.phases[ph]), ph
            assert ours.phases[ph].per_chip_bytes(shards) == \
                theirs.phases[ph].per_chip_bytes(shards)
        for attr in ("steady_round_bytes", "steady_round_cipher_rows",
                     "steady_round_sort_keys", "per_shard_steady_round_bytes"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
        assert ours.floor_ms(8.0) == theirs.floor_ms(8.0)
    assert vars(costmodel.engine_cost_ledger(ecfg, occ_impl="scan").phases["writeback"]) \
        == vars(rcm.engine_cost_ledger(jecfg, occ_impl="scan").phases["writeback"])
    b = ecfg.batch_size
    for t, jt, nb in ((ecfg.rec, jecfg.rec, b), (ecfg.mb, jecfg.mb, b * ecfg.mb_choices)):
        assert costmodel.oram_steady_bytes(t, nb) == rcm.oram_steady_bytes(jt, nb)
        assert costmodel.oram_sharded_steady_bytes(t, nb, 4) == \
            rcm.oram_sharded_steady_bytes(jt, nb, 4)
        assert costmodel.flush_target_rows(t) == rcm.flush_target_rows(jt)
    assert {k: (v.gather_rows, v.scatter_rows) for k, v in
            costmodel.engine_round_rows(ecfg).items()} == \
        {k: (v.gather_rows, v.scatter_rows) for k, v in rcm.engine_round_rows(jecfg).items()}
    with pytest.raises(ValueError):
        costmodel.engine_cost_ledger(ecfg, shards=3)

    _, rreg, *_ = _ref()
    reg, jreg = registry.TelemetryRegistry(), rreg.TelemetryRegistry()
    mon = costmon.CostMonitor(ecfg, reg, device_type="cpu")
    jmon = rcostmon.CostMonitor(jecfg, jreg)
    assert mon.bandwidth_gbps == jmon.bandwidth_gbps == 8.0
    for dev_s in (0.01, 0.2, 0.05):
        spans = {"device": (1.0, dev_s), "round": (1.0, 0.3)}
        mon.observe_round(spans)
        jmon.observe_round(spans)
    mon.observe_round({"round": (0.0, 1.0)})
    jmon.observe_round({"round": (0.0, 1.0)})
    _renders_equal(reg, jreg)
    snap = reg.snapshot()
    assert snap["grapevine_cost_roofline_residual"] == 0.05 * 1e3 / mon.floor_ms
    assert snap["grapevine_cost_roofline_residual_max"] == 0.2 * 1e3 / mon.floor_ms


def test_bandwidth_resolution_order(monkeypatch):
    monkeypatch.delenv("GRAPEVINE_COST_GBPS", raising=False)
    assert costmon.resolve_bandwidth_gbps() == 8.0
    assert costmon.resolve_bandwidth_gbps(device_type="cuda") == costmon.DEFAULT_GBPS["cuda"]
    assert costmon.resolve_bandwidth_gbps(device_type="mps") == 8.0
    monkeypatch.setenv("GRAPEVINE_COST_GBPS", "123.5")
    assert costmon.resolve_bandwidth_gbps(device_type="cuda") == 123.5
    assert costmon.resolve_bandwidth_gbps(7.0, "cuda") == 7.0


def test_profiler_gate_captures_other_threads_and_refuses_a_second(tmp_path):
    """The gate runs on one thread (the HTTP handler's in a server) while
    another thread works: the capture holds the working thread's ranges;
    a concurrent second capture, or any other capture of the process, is
    refused with ``ProfilerBusy`` instead of ending the first."""
    gate = ProfilerGate(outdir=str(tmp_path), max_ms=400)
    stop = threading.Event()

    def work():
        while not stop.is_set():
            with torch.profiler.record_function("grapevine/evict"):
                torch.ones(256).cumsum(0)

    worker = threading.Thread(target=work, name="collector")
    worker.start()
    out, errs = {}, []

    def capture():
        try:
            out.update(gate.capture(10_000))  # clamped to max_ms
        except BaseException as exc:  # pragma: no cover - reported below
            errs.append(exc)

    t = threading.Thread(target=capture, name="http")
    try:
        t.start()
        assert gate.live.wait(30)
        with pytest.raises(ProfilerBusy):
            gate.capture(5)
        with pytest.raises(ProfilerBusy):
            with exclusive_profile():
                pass
        t.join()
    finally:
        stop.set()
        worker.join()
    assert not errs and out["ms"] == 400
    assert out["trace_dir"] == str(tmp_path / "capture-0001")
    with open(os.path.join(out["trace_dir"], "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "grapevine/evict" in names and "aten::cumsum" in names
    assert not gate.live.is_set()
    assert gate.capture(1)["trace_dir"].endswith("capture-0002")


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused round's Hopper kernels have no "
                    "CPU mode (run on the card: python -m pytest --noconftest "
                    "tests/test_torch_obs.py -k cuda)")
    return torch.device("cuda")


def _creates(rng, n: int, tag: int):
    from grapevine_tpu_torch.wire import constants as C
    from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

    return [QueryRequest(request_type=C.REQUEST_TYPE_CREATE,
                         auth_identity=bytes([rng.randrange(1, 200)]) * 32,
                         record=RequestRecord(recipient=bytes([rng.randrange(1, 60)]) * 32,
                                              payload=bytes([tag]) * C.PAYLOAD_SIZE))
            for _ in range(n)]


def test_cuda_depth2_dispatch_with_the_leak_monitor_makes_no_host_sync(cuda_device):
    """With a leak monitor attached, every round's transcript comes down by
    the round's own pinned copies and event: 8 depth-2 dispatches under
    ``set_sync_debug_mode("error")`` raise nothing, the monitor audits
    every round and passes, and the rounds equal a depth-1 engine's."""
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine
    from grapevine_tpu_torch.obs.leakmon import EngineLeakMonitor, LeakMonitorConfig

    geo = dict(max_messages=2**12, max_recipients=2**8, batch_size=32, mailbox_cap=8,
               vphases_impl="dense", bucket_cipher_impl="pallas_fused", evict_every=2)
    e1 = GrapevineEngine(GrapevineConfig(pipeline_depth=1, **geo), seed=8, device=cuda_device)
    e2 = GrapevineEngine(GrapevineConfig(pipeline_depth=2, **geo), seed=8, device=cuda_device)
    lm = EngineLeakMonitor.for_engine(e2, LeakMonitorConfig())
    e2.attach_leakmon(lm)
    rng = random.Random(3)
    calls = [_creates(rng, 32, i) for i in range(10)]
    want = [r.pack() for i, reqs in enumerate(calls) for r in e1.handle_queries(reqs, 10 + i)]
    got, pending = [], None
    try:
        for i, reqs in enumerate(calls):
            if i >= 2:
                torch.cuda.set_sync_debug_mode("error")
            try:
                nxt = e2.handle_queries_async(reqs, 10 + i)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if pending is not None:
                got += [r.pack() for r in pending.resolve()]
            pending = nxt
        got += [r.pack() for r in pending.resolve()]
        assert lm.flush()
        v = lm.verdict()
    finally:
        lm.close()
    assert got == want
    assert v["verdict"] == "PASS" and v["rounds_observed"] == 10 and v["rounds_dropped"] == 0


def test_cuda_profiler_capture_from_another_thread_sees_collector_kernels(cuda_device,
                                                                          tmp_path):
    """The scheduler's collector thread dispatches rounds while a capture
    runs on a third thread: the trace holds B3's and B5's kernels."""
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine

    geo = dict(max_messages=2**12, max_recipients=2**8, batch_size=32, mailbox_cap=8,
               vphases_impl="dense", bucket_cipher_impl="pallas_fused", evict_every=2)
    eng = GrapevineEngine(GrapevineConfig(**geo), seed=8, device=cuda_device)
    gate = ProfilerGate(outdir=str(tmp_path), device_type="cuda")
    stop = threading.Event()
    rng = random.Random(4)

    def serve():
        i = 0
        while not stop.is_set():
            eng.handle_queries(_creates(rng, 32, i % 200), 10 + i)
            i += 1

    worker = threading.Thread(target=serve, name="collector")
    worker.start()
    out = {}
    t = threading.Thread(target=lambda: out.update(gate.capture(500)), name="http")
    try:
        t.start()
        t.join()
    finally:
        stop.set()
        worker.join()
    with open(os.path.join(out["trace_dir"], "trace.json")) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    assert any("ring_kernel<128, 1, 1>" in n for n in names), "no B3 in the capture"
    assert any("ring_kernel<128, 1, 0>" in n for n in names), "no B5 in the capture"
