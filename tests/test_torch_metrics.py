"""The port's telemetry (``grapevine_tpu_torch/obs``, ``engine/metrics.py``
and the durability series of ``engine/checkpoint.py``) held against the
reference's copies; the models are ``tests/test_obs_leakcheck.py``,
``tests/test_metrics.py`` and ``tests/test_obs_endpoint.py``. No round
program runs in JAX here.

- the registry's leak policy: forbidden and unallowlisted label keys,
  undeclared label values, fixed buckets, duplicate names and the audit;
- after the same deterministic recording calls, the port's
  ``EngineMetrics`` (with the durability series on its registry) renders
  the reference's Prometheus exposition byte for byte, and snapshots
  equal;
- a ``MetricsServer`` on port 0 over a CPU port engine serves
  ``/metrics`` with every phase series (samples in each phase the engine
  ran), ``/healthz`` and 404 for an unknown path.
"""

import json
import os
import random
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from grapevine_tpu.config import DurabilityConfig as JDur
from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.checkpoint import DurabilityManager as JDurability
from grapevine_tpu.engine.metrics import EngineMetrics as JMetrics
from grapevine_tpu.engine.state import EngineConfig as JEcfg
from grapevine_tpu.obs.exporter import render_prometheus as j_render
from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
from grapevine_tpu_torch.engine.batcher import GrapevineEngine, pack_batch
from grapevine_tpu_torch.engine.checkpoint import DurabilityManager
from grapevine_tpu_torch.engine.metrics import EngineMetrics
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.obs import (
    ALLOWED_LABEL_KEYS,
    FORBIDDEN_LABEL_KEYS,
    PHASES,
    MetricsServer,
    TelemetryLeakError,
    TelemetryRegistry,
    render_prometheus,
)
from grapevine_tpu_torch.obs.registry import _CounterChild
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

NOW = 1_700_000_000
TOY = dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=4,
           stash_size=64, bucket_cipher_rounds=0)


# -- the registry's leak policy -----------------------------------------


@pytest.mark.parametrize("key", ["op_type", "client_id", "msg_id", "recipient"])
def test_forbidden_label_key_raises_at_registration(key):
    with pytest.raises(TelemetryLeakError, match="side channel|allowlist"):
        TelemetryRegistry().counter("grapevine_bad_total", "nope", labels={key: ("x",)})


def test_label_policy_teeth():
    reg = TelemetryRegistry()
    with pytest.raises(TelemetryLeakError, match="allowlist"):
        reg.gauge("grapevine_bad", "nope", labels={"color": ("red",)})
    with pytest.raises(TelemetryLeakError, match="no values"):
        reg.counter("grapevine_bad_total", "nope", labels={"phase": ()})
    with pytest.raises(TelemetryLeakError, match="bare integer"):
        reg.counter("grapevine_w_total", "w", labels={"worker": ("host-a",)})
    h = reg.histogram("grapevine_x_seconds", "x", buckets=(0.1, 1.0),
                      labels={"phase": ("verify",)})
    h.observe(0.5, phase="verify")
    with pytest.raises(TelemetryLeakError, match="not.*declared|dynamic"):
        h.observe(0.5, phase="deadbeef")
    with pytest.raises(ValueError, match="increasing"):
        reg.histogram("grapevine_h_seconds", "h", buckets=(1.0, 0.5))
    reg.counter("grapevine_a_total", "a")
    with pytest.raises(ValueError, match="duplicate"):
        reg.counter("grapevine_a_total", "again")
    assert not (ALLOWED_LABEL_KEYS & FORBIDDEN_LABEL_KEYS)


def test_audit_passes_the_engine_registry_and_catches_smuggled_series():
    m = EngineMetrics()
    report = m.registry.audit()
    assert report["ok"] and report["metrics"] >= 10
    m.registry.get("grapevine_rounds_total")._children[("deadbeef",)] = _CounterChild()
    with pytest.raises(TelemetryLeakError, match="undeclared series"):
        m.registry.audit()


# -- the same exposition as the reference --------------------------------


def _record(m) -> None:
    """One deterministic sequence through every recording entry point."""
    for i in range(20):
        m.record_round(n_real=3 if i % 4 else 4, batch_size=4, seconds=0.001 * (i + 1))
    m.record_sweep(5)
    m.record_flush()
    m.record_auth(failures=2)
    m.record_auth()
    for n in (17, 9, 0):
        m.observe_stash(n)
    m.observe_evict_buffer(12)
    m.observe_evict_buffer(3)
    for i, phase in enumerate(PHASES):
        m.observe_phase(phase, 0.0003 * (i + 1))
    m.observe_queue_depth(6)
    m.observe_queue_depth(2)
    m.record_stall()
    m.record_worker_crash()


def _durability(mgr, registry):
    """``mgr`` (on ``registry``) after an empty recovery, a round, a flush
    and a sweep record; the recovery time gauge fixed (a wall time)."""
    mgr.recover(None, lambda state, rec: state)
    mgr.append_round(pack_batch([], mgr.ecfg.batch_size, NOW), 0)
    mgr.append_flush()
    mgr.append_sweep(NOW, 0, 30)
    registry.get("grapevine_recovery_seconds").set(0.25)
    mgr.close()


def test_exposition_and_snapshot_equal_the_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(os, "urandom", lambda n: bytes(n))
    tm, jm = EngineMetrics(ring_size=8), JMetrics(ring_size=8)
    assert render_prometheus(tm.registry) == j_render(jm.registry)
    _record(tm)
    _record(jm)
    kw = dict(TOY, evict_every=2)
    _durability(DurabilityManager(
        DurabilityConfig(state_dir=str(tmp_path / "t")),
        EngineConfig.from_config(GrapevineConfig(**kw)), "cpu", registry=tm.registry),
        tm.registry)
    _durability(JDurability(JDur(state_dir=str(tmp_path / "j")),
                            JEcfg.from_config(JConfig(**kw)), registry=jm.registry),
                jm.registry)
    text = render_prometheus(tm.registry)
    assert text == j_render(jm.registry)
    assert "grapevine_journal_records_total 3" in text
    assert tm.snapshot() == jm.snapshot()
    s = tm.snapshot()
    assert s["rounds"] == 20 and s["round_ms_p99"] == 20.0 and s["round_ms_p50"] == 17.0


def test_concurrent_recording_is_lossless():
    """``record_round`` runs from ``PendingRound.resolve`` on any thread:
    the internal locks keep every total exact."""
    m = EngineMetrics(ring_size=64)
    n_threads, per = 8, 200
    barrier = threading.Barrier(n_threads)

    def hammer():
        barrier.wait()
        for i in range(per):
            m.record_round(n_real=1, batch_size=2, seconds=0.002)
            m.observe_phase("evict", 0.0005)
            m.observe_stash(i % 50)

    threads = [threading.Thread(target=hammer) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    s = m.snapshot()
    assert s["rounds"] == s["real_ops"] == n_threads * per
    assert s["grapevine_phase_seconds{phase=evict}_count"] == n_threads * per
    assert s["round_ms_p50"] == s["round_ms_p99"] == 2.0
    assert m.registry.audit()["ok"]


# -- the /metrics endpoint over a port engine ----------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_metrics_server_over_a_port_engine(tmp_path):
    """A durable E=2 engine (checkpoint every 4 records) after a
    multi-chunk call and a sweep, then recovered into a second engine:
    ``/metrics`` carries every phase series, with samples in each phase
    the engines ran, the pre-scrape hook samples the stash, ``/healthz``
    answers 200 and an unknown path 404."""
    dcfg = DurabilityConfig(state_dir=str(tmp_path / "d"), checkpoint_every_rounds=4)
    cfg = GrapevineConfig(**dict(TOY, evict_every=2))
    eng = GrapevineEngine(cfg, seed=1, device="cpu", durability=dcfg)
    rng = random.Random(2)
    reqs = [QueryRequest(request_type=C.REQUEST_TYPE_CREATE,
                         auth_identity=bytes([rng.randrange(1, 9)]) * 32,
                         record=RequestRecord(recipient=bytes([rng.randrange(1, 4)]) * 32,
                                              payload=b"\x07" * C.PAYLOAD_SIZE))
            for _ in range(10)]
    assert len(eng.handle_queries(reqs, NOW)) == 10
    eng.expire(NOW + 100, 10)
    eng.close()
    eng = GrapevineEngine(cfg, seed=1, device="cpu", durability=dcfg)

    srv = MetricsServer(eng.metrics.registry, refresh=eng.sample_stash,
                        health=lambda: (True, {"messages": eng.message_count()}), port=0)
    port = srv.start()
    try:
        status, text = _get(f"http://127.0.0.1:{port}/metrics")
        assert status == 200
        for phase in PHASES:
            assert f'grapevine_phase_seconds_bucket{{phase="{phase}",le="0.0001"}}' in text
        assert 'grapevine_phase_seconds_count{phase="replay"} 1' in text
        assert "grapevine_stash_occupancy_count 2" in text
        assert "grapevine_recovery_replayed_records" in text
        status, body = _get(f"http://127.0.0.1:{port}/healthz")
        assert status == 200 and json.loads(body) == {"healthy": True, "messages": 0}
        assert _get(f"http://127.0.0.1:{port}/nope")[0] == 404
        assert _get(f"http://127.0.0.1:{port}/trace")[0] == 404
    finally:
        srv.stop()
        eng.close()


def test_metrics_server_phase_samples_after_live_rounds(tmp_path):
    """The live engine's own registry: samples in every phase its rounds,
    flushes, sweep, journal and checkpoints touch."""
    dcfg = DurabilityConfig(state_dir=str(tmp_path / "d"), checkpoint_every_rounds=4)
    eng = GrapevineEngine(GrapevineConfig(**dict(TOY, evict_every=2)), seed=1,
                          device="cpu", durability=dcfg)
    reqs = [QueryRequest(request_type=C.REQUEST_TYPE_READ, auth_identity=bytes([i + 1]) * 32)
            for i in range(10)]
    eng.handle_queries(reqs, NOW)
    eng.expire(NOW + 100, 10)
    srv = MetricsServer(eng.metrics.registry, port=0)
    port = srv.start()
    try:
        _, text = _get(f"http://127.0.0.1:{port}/metrics")
    finally:
        srv.stop()
        eng.close()
    counts = {p: int(np.float64(text.split(f'grapevine_phase_seconds_count{{phase="{p}"}} ')[1]
                                .split("\n")[0])) for p in PHASES}
    assert {p for p, c in counts.items() if c} == {
        "dispatch", "evict", "demux", "sweep", "journal", "checkpoint", "flush", "replay"}
    assert counts["dispatch"] == counts["evict"] == counts["demux"] == 3
    assert "grapevine_rounds_total 3" in text
    assert "grapevine_evict_flushes_total 1" in text
