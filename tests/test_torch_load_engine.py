"""The port's load harness through the port's serving path on the CPU:
``ScenarioRunner`` replays schedules through a ``BatchScheduler`` over a
CPU ``GrapevineEngine`` at the reference's fixture (2^10 messages, B=4):

- workload telemetry lands at round cadence and every op settles OK;
- the probe campaign with ``ProbeCampaignInjector`` flips the port's
  leak monitor (the verdict behind ``/leakaudit``) to SUSPECT, and the
  same timing against the honest engine stays PASS with full evidence;
- ``calibrate_unloaded_round`` and a short ramp graded by
  ``analyze_ramp`` run end to end.
"""

import numpy as np
import pytest

from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.load import (
    ProbeCampaignInjector,
    ScenarioRunner,
    adversarial_probe,
    analyze_ramp,
    calibrate_unloaded_round,
    ramp_to_saturation,
    steady_poisson,
)
from grapevine_tpu_torch.load.harness import OK_STATUSES
from grapevine_tpu_torch.obs.leakmon import PASS, SUSPECT, EngineLeakMonitor
from grapevine_tpu_torch.obs.workload import WorkloadTelemetry
from grapevine_tpu_torch.server.scheduler import BatchScheduler
from _torch_threads import one_torch_thread  # noqa: F401

NOW = 1_700_000_000


@pytest.fixture(scope="module")
def loaded_engine():
    cfg = GrapevineConfig(max_messages=1 << 10, max_recipients=1 << 8, batch_size=4,
                          bucket_cipher_rounds=0)
    engine = GrapevineEngine(cfg, device="cpu")
    wl = WorkloadTelemetry(engine.metrics.registry, batch_size=4)
    engine.attach_workload(wl)
    sched = BatchScheduler(engine, clock=lambda: NOW)
    try:
        ScenarioRunner(sched, n_idents=8).run(steady_poisson(40.0, 0.2, 1, n_idents=8))
    finally:
        sched.close()
    return engine, wl


def _monitor(engine):
    return EngineLeakMonitor(mb_leaves=engine.ecfg.mb.leaves,
                             rec_leaves=engine.ecfg.rec.leaves,
                             mb_choices=engine.ecfg.mb_choices)


def _run(engine, schedule, sink):
    engine.attach_leakmon(sink)
    sched = BatchScheduler(engine, clock=lambda: NOW)
    try:
        return ScenarioRunner(sched, n_idents=16, settle_timeout_s=60.0).run(schedule)
    finally:
        sched.close()
        sink.flush(30)
        engine.attach_leakmon(None)


def test_scenario_runner_through_the_ports_scheduler(loaded_engine):
    engine, wl = loaded_engine
    mon = _monitor(engine)
    res = _run(engine, steady_poisson(120.0, 1.2, 31, n_idents=16), mon)
    s = res.summary()
    assert s["n_failed"] == 0 and s["n_ok"] == s["n_ops"] > 0
    assert set(np.unique(res.status)) <= OK_STATUSES
    assert s["p99_commit_ms"] > 0
    reg = engine.metrics.registry
    assert reg.get("grapevine_load_batch_fill").child().count > 0
    assert reg.get("grapevine_load_arrivals_total").get() >= s["n_ops"]
    assert wl.utilization()["device"] > 0.0
    assert mon.verdict()["verdict"] == PASS
    mon.close()


def test_probe_campaign_flips_leakaudit_suspect(loaded_engine):
    engine, _ = loaded_engine
    mon = _monitor(engine)
    _run(engine, adversarial_probe(0.03, 1.5, 32, n_probe_keys=4, probes_per_pulse=2),
         ProbeCampaignInjector(mon, engine.ecfg))
    v = mon.verdict()
    assert v["verdict"] == SUSPECT, v
    assert "cross_round_repeat" in {d["name"] for d in v["detectors"]
                                    if d["verdict"] == SUSPECT}
    mon.close()


def test_probe_campaign_without_leak_stays_pass(loaded_engine):
    engine, _ = loaded_engine
    mon = _monitor(engine)
    _run(engine, adversarial_probe(0.03, 1.5, 33, n_probe_keys=4, probes_per_pulse=2), mon)
    v = mon.verdict()
    assert v["verdict"] == PASS, v
    coll = next(d for d in v["detectors"]
                if d["name"] == "samekey_collision" and d["tree"] == "mb")
    assert coll["samples"] >= coll["min_samples"], coll
    mon.close()


def test_calibrated_ramp_grades_a_knee(loaded_engine):
    engine, _ = loaded_engine
    t_round, est, target_ms = calibrate_unloaded_round(engine, NOW, reps=2)
    assert t_round > 0 and est == pytest.approx(4 / t_round)
    assert target_ms == max(250.0, 8.0 * t_round * 1e3)
    schedule = ramp_to_saturation(max(10.0, 0.25 * est), 2.0, 3, 0.5, 45, n_idents=16)
    mon = _monitor(engine)
    res = _run(engine, schedule, mon)
    out = analyze_ramp(schedule, res, target_ms=target_ms)
    assert len(out["steps"]) == 3
    assert out["knee_ops_per_sec"] > 0, out
    assert not np.isnan(res.latency_s[res.ok]).any()
    mon.close()
