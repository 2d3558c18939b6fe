"""The port's leak monitor and its statistics held against the JAX
package's, at tolerance 0 (both are numpy on the same arrays):

- ``testing/leakcheck.py``: every detector on the same seeded inputs;
- ``engine/round_step.py:transcript_key_groups`` on the same batch
  columns, at three geometries (batch size, mailbox choices) and two
  seeds each;
- ``TranscriptLeakMonitor`` and ``EngineLeakMonitor`` fed the same
  transcript streams (honest, a fixed leaf, no remap): windowed stats,
  verdicts, the flight recorder's dump and the registry's Prometheus
  exposition byte for byte; the fixed-leaf and no-remap canaries turn
  SUSPECT in both; the flush-cadence and ship-cadence detectors;
- ``FleetUniformityMonitor`` on the same aligned ticks (honest and
  load-gated), and ``FlightRecorder``'s schema refusals and ring.

No JAX program is compiled here: the reference modules used are numpy.
"""

import numpy as np
import pytest

from grapevine_tpu.engine.round_step import transcript_key_groups as ref_groups
from grapevine_tpu.obs import exporter as ref_exporter
from grapevine_tpu.obs import flightrec as ref_flightrec
from grapevine_tpu.obs import leakmon as ref_leakmon
from grapevine_tpu.obs import registry as ref_registry
from grapevine_tpu.testing import leakcheck as ref_lc
from grapevine_tpu_torch.engine.round_step import transcript_key_groups
from grapevine_tpu_torch.obs import exporter, flightrec, leakmon, registry
from grapevine_tpu_torch.testing import leakcheck as lc
from grapevine_tpu_torch.wire import constants as C
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

SEEDS = (3, 11)


@pytest.mark.parametrize("seed", SEEDS)
def test_leakcheck_detectors_equal_reference(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(-1, 12, size=96)
    leaves = rng.integers(0, 64, size=96)
    assert lc.samekey_leaf_collisions(keys, leaves) == \
        ref_lc.samekey_leaf_collisions(keys, leaves)
    assert lc.samekey_collision_counts(keys, leaves) == \
        ref_lc.samekey_collision_counts(keys, leaves)
    seq = rng.integers(0, 4, size=40)
    assert lc.cross_round_repeat_rate(seq) == ref_lc.cross_round_repeat_rate(seq)
    a, b = rng.integers(0, 1024, size=500), rng.integers(0, 1024, size=700)
    assert lc.twosample_z(a, b, 1024) == ref_lc.twosample_z(a, b, 1024)
    assert lc.uniformity_z(a, 1024, 32) == ref_lc.uniformity_z(a, 1024, 32)
    assert lc.uniformity_z(np.zeros(300, np.int64), 1024) == \
        ref_lc.uniformity_z(np.zeros(300, np.int64), 1024)
    counts = rng.integers(0, 50, size=16)
    assert lc.uniformity_z_from_counts(counts) == ref_lc.uniformity_z_from_counts(counts)
    ta, tb = rng.normal(10, 1, 80), np.round(rng.normal(10.5, 1, 60), 1)
    assert lc.timing_twosample_z(ta, tb) == ref_lc.timing_twosample_z(ta, tb)
    assert lc.timing_twosample_z([], tb) == ref_lc.timing_twosample_z([], tb) == 0.0


_POOLS = np.random.default_rng(0)
#: identities/recipients and message ids every batch draws from (small
#: pools, fixed across rounds, so keys repeat within and across rounds)
POOL = _POOLS.integers(0, 2**32, size=(6, 8), dtype=np.uint64).astype(np.uint32)
IDS = _POOLS.integers(1, 2**32, size=(5, 4), dtype=np.uint64).astype(np.uint32)


def _batch(rng, b: int) -> dict:
    """Batch key columns: dummies, every op type, zero and explicit ids."""
    rt = rng.integers(0, 5, size=b).astype(np.uint32)
    msg_id = IDS[rng.integers(0, 5, size=b)]
    msg_id[rng.random(b) < 0.4] = 0
    return {
        "req_type": rt,
        "auth": POOL[rng.integers(0, 6, size=b)],
        "msg_id": msg_id,
        "recipient": POOL[rng.integers(0, 6, size=b)],
    }


@pytest.mark.parametrize("b,d", [(16, 1), (64, 2), (32, 3)])
@pytest.mark.parametrize("seed", SEEDS)
def test_transcript_key_groups_equal_reference(b, d, seed):
    rng = np.random.default_rng(seed)
    for _ in range(3):
        batch = _batch(rng, b)
        (mk, ms), (rk, rs) = transcript_key_groups(batch, d)
        (jmk, jms), (jrk, jrs) = ref_groups(batch, d)
        assert mk.dtype == jmk.dtype == np.int64
        assert np.array_equal(mk, jmk) and np.array_equal(rk, jrk)
        assert ms == jms and rs == jrs
        assert (mk >= 0).any() and (rk >= 0).any()
        assert (mk[np.repeat(batch["req_type"] == C.REQUEST_TYPE_INVALID, d)] == -1).all()


def _stream(rng, b: int, d: int, mb_leaves: int, rec_leaves: int, kind: str,
            batch: dict | None = None):
    """One round's transcript u32[B, 2D+1]: uniform leaves, or with the
    records column fixed at leaf 0 ("fixed"), or repeating the batch's
    previous leaves ("noremap": leaves a function of the keys)."""
    tr = np.empty((b, 2 * d + 1), np.uint32)
    tr[:, :d] = rng.integers(0, mb_leaves, size=(b, d))
    tr[:, d] = rng.integers(0, rec_leaves, size=b)
    tr[:, d + 1:] = rng.integers(0, mb_leaves, size=(b, d))
    if kind == "fixed":
        tr[:, d] = 0
    elif kind == "noremap":
        h = batch["msg_id"][:, 0].astype(np.uint64) * 2654435761
        tr[:, d] = (h % rec_leaves).astype(np.uint32)
    return tr


def _pair_registries():
    return registry.TelemetryRegistry(), ref_registry.TelemetryRegistry()


def _exposition_equal(reg, ref_reg) -> str:
    text = exporter.render_prometheus(reg)
    assert text == ref_exporter.render_prometheus(ref_reg)
    return text


def _dump(mon) -> dict:
    """The flight recorder's dump without its monotonic stamps (the one
    field that differs between two monitors fed the same rounds)."""
    d = mon.recorder.dump()
    d["rounds"] = [{k: v for k, v in r.items() if k != "t_mono_s"} for r in d["rounds"]]
    return d


@pytest.mark.parametrize("b,d,kind,want", [
    (32, 1, "honest", "PASS"), (64, 2, "honest", "PASS"),
    (32, 1, "fixed", "SUSPECT"), (64, 2, "noremap", "SUSPECT"),
])
@pytest.mark.parametrize("seed", SEEDS)
def test_engine_leak_monitor_equals_reference(b, d, kind, want, seed):
    """Both EngineLeakMonitors fed the same (batch, transcript) rounds and
    the same flush intervals: verdicts, stats, flight recorder dump and
    exposition equal after every few rounds; the canaries turn SUSPECT."""
    mb_leaves, rec_leaves = 2**6, 2**8
    cfg = leakmon.LeakMonitorConfig(window_rounds=64, flight_capacity=16)
    jcfg = ref_leakmon.LeakMonitorConfig(window_rounds=64, flight_capacity=16)
    reg, jreg = _pair_registries()
    mon = leakmon.EngineLeakMonitor(mb_leaves, rec_leaves, d, cfg, reg, flush_every=4)
    ref = ref_leakmon.EngineLeakMonitor(mb_leaves, rec_leaves, d, jcfg, jreg,
                                        flush_every=4)
    rng = np.random.default_rng(seed)
    try:
        for r in range(24):
            batch = _batch(rng, b)
            tr = _stream(rng, b, d, mb_leaves, rec_leaves, kind, batch)
            phases = {"dispatch": 0.001 * (r + 1), "evict": 0.002, "round": 0.01}
            n = int(rng.integers(1, b + 1))
            for m in (mon, ref):
                m.submit_round(batch, tr, n, b, phases, queue_depth=r % 5)
            if r % 4 == 3:
                for m in (mon, ref):
                    m.note_flush(4, scheduled=True)
            if r % 6 == 5:
                assert mon.flush() and ref.flush()
                assert mon.verdict() == ref.verdict()
                assert mon.last_verdict() == ref.last_verdict()
                for t in mon.monitor.streams:
                    assert mon.monitor.stats(t) == ref.monitor.stats(t)
                assert _dump(mon) == _dump(ref)
                _exposition_equal(reg, jreg)
        v = mon.verdict()
        assert v["verdict"] == want and v["rounds_observed"] == 24
        tripped = {x["name"] for x in v["detectors"] if x["verdict"] == "SUSPECT"}
        # the fixed leaf skews the histogram; the no-remap leaf repeats
        # each key's previous one (and collides within the round)
        assert {"honest": set(), "fixed": {"uniformity"},
                "noremap": {"cross_round_repeat", "samekey_collision"}}[kind] <= tripped
        assert bool(tripped) == (kind != "honest")
        assert {x["name"] for x in v["detectors"]} >= {"samekey_collision",
                                                       "cross_round_repeat", "uniformity",
                                                       "flush_cadence"}
        # a flush off the declared cadence trips the flush detector in both
        for m in (mon, ref):
            m.note_flush(3, scheduled=True)
            m.note_flush(1, scheduled=False)  # an operator flush is not judged
        assert mon.verdict() == ref.verdict()
        assert mon.verdict()["verdict"] == "SUSPECT"
        _exposition_equal(reg, jreg)
    finally:
        mon.close()
        ref.close()


class _Shipper:
    def __init__(self, ok: bool):
        self.ok = ok

    def stats(self):
        return {"frames_shipped": 5, "bytes_shipped": 500, "illegal_frames": 0 if self.ok
                else 1, "cadence_ok": self.ok}


@pytest.mark.parametrize("ok", [True, False])
def test_ship_cadence_detector_equals_reference(ok):
    mon = leakmon.EngineLeakMonitor(64, 256, 1)
    ref = ref_leakmon.EngineLeakMonitor(64, 256, 1)
    try:
        for m in (mon, ref):
            m.attach_shipper(_Shipper(ok))
        assert mon.verdict() == ref.verdict()
        assert mon.verdict()["verdict"] == ("PASS" if ok else "SUSPECT")
    finally:
        mon.close()
        ref.close()


def test_transcript_monitor_streams_and_window_equal_reference():
    """The synchronous core on a keyed stream whose window slides: stats,
    verdicts and exposition equal after every observation; undeclared
    streams raise in both."""
    reg, jreg = _pair_registries()
    cfg = leakmon.LeakMonitorConfig(window_rounds=8, min_pooled_leaves=32)
    jcfg = ref_leakmon.LeakMonitorConfig(window_rounds=8, min_pooled_leaves=32)
    mon = leakmon.TranscriptLeakMonitor({"oram": 256, "mb": 16}, cfg, reg)
    ref = ref_leakmon.TranscriptLeakMonitor({"oram": 256, "mb": 16}, jcfg, jreg)
    rng = np.random.default_rng(5)
    for r in range(20):
        keys = rng.integers(-1, 20, size=24)
        leaves = rng.integers(0, 256, size=24) if r < 12 else np.full(24, 7)
        for m in (mon, ref):
            m.observe("oram", keys, leaves)
            m.observe("mb", None, leaves % 16)
        assert mon.verdict() == ref.verdict()
        assert mon.stats("oram") == ref.stats("oram")
        _exposition_equal(reg, jreg)
    assert mon.verdict()["verdict"] == "SUSPECT"
    with pytest.raises(KeyError):
        mon.observe("rec", None, [1])
    with pytest.raises(ValueError, match="align"):
        mon.observe("oram", [1, 2], [1])


def _tick(rng, n: int, t: int, gated: bool):
    """Cumulative per-shard samples: every shard dispatches every tick
    (honest) or only while its own queue is hot (gated)."""
    out = []
    for s in range(n):
        q = float(rng.integers(0, 40))
        rounds = t + 1 if not gated else int(rng.integers(0, 2) + (q > 20) * 3) * (t + 1)
        out.append({"rounds_total": float(rounds), "flushes_total": float(rounds // 4),
                    "fill_sum": float(rounds) * 0.5, "fill_count": float(rounds),
                    "queue_depth": q})
    return out


@pytest.mark.parametrize("gated", [False, True])
def test_fleet_uniformity_monitor_equals_reference(gated):
    reg, jreg = _pair_registries()
    mon = leakmon.FleetUniformityMonitor(3, registry=reg)
    ref = ref_leakmon.FleetUniformityMonitor(3, registry=jreg)
    rng = np.random.default_rng(21)
    for t in range(40):
        tick = _tick(rng, 3, t, gated)
        if t == 17:
            tick[1] = None  # a failed scrape: no evidence this tick
        mon.observe_tick(tick)
        ref.observe_tick(tick)
        assert mon.verdict() == ref.verdict()
    _exposition_equal(reg, jreg)
    with pytest.raises(ValueError):
        mon.observe_tick([None])
    with pytest.raises(ValueError):
        leakmon.FleetUniformityMonitor(1)


@pytest.mark.parametrize("summary", [
    "not a dict",
    {"seq": 1, "client": "alice"},
    {"seq": [1, 2]},
    {"phase_s": {"per_op": 0.1}},
    {"phase_s": [0.1]},
    {"stats": {"oram": {"collision_rate": 0.0}}},
    {"stats": {"rec": {"keys": 1}}},
    {"stats": {"rec": [1]}},
])
def test_flight_recorder_refusals_equal_reference(summary):
    with pytest.raises(registry.TelemetryLeakError) as err:
        flightrec.FlightRecorder(4).record(summary)
    with pytest.raises(ref_registry.TelemetryLeakError) as ref_err:
        ref_flightrec.FlightRecorder(4).record(summary)
    assert str(err.value) == str(ref_err.value)


def test_flight_recorder_ring_equals_reference(tmp_path):
    rec, ref = flightrec.FlightRecorder(5), ref_flightrec.FlightRecorder(5)
    for i in range(13):
        s = {"seq": i, "batch_size": 8, "n_real": i % 8, "fill": (i % 8) / 8,
             "phase_s": {"evict": 0.001 * i, "round": 0.01},
             "stats": {"rec": {"collision_rate": 0.0, "pooled_leaves": i}},
             "verdict": "PASS"}
        rec.record(s)
        ref.record(s)
        assert rec.dump() == ref.dump()
    assert rec.dump()["retained"] == 5 and rec.dump()["rounds"][0]["seq"] == 8
    assert rec.dump_json() == ref.dump_json()
    path = rec.dump_to(str(tmp_path / "fr.json"))
    assert path.endswith("fr.json")
    with pytest.raises(ValueError):
        flightrec.FlightRecorder(0)
