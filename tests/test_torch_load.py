"""The port's load harness (``grapevine_tpu_torch/load/``) held against the
JAX package's ``grapevine_tpu/load/``, with no engine:

- every generator's ``Schedule`` equals the reference's for two seeds:
  arrays, ``meta`` and ``fingerprint()``; so do ``partition_schedule``,
  the identity pool and the materialized wire requests;
- ``step_stats``, ``find_knee``, ``analyze_ramp`` and ``fleet_capacity``
  equal the reference's on its synthetic replays;
- the replay is open-loop against a wedged scheduler, the sharded runner
  replays the partition, and the shard round driver's verdicts equal the
  reference's under both policies.
"""

import threading
import time
import types
from concurrent.futures import Future

import numpy as np
import pytest

from grapevine_tpu.load import capacity as jcap
from grapevine_tpu.load import generators as jgen
from grapevine_tpu.load import harness as jh
from grapevine_tpu.obs.fleet import FleetUniformityMonitor as JFleetMon
from grapevine_tpu_torch.load import capacity as tcap
from grapevine_tpu_torch.load import generators as tgen
from grapevine_tpu_torch.load import harness as th
from grapevine_tpu_torch.obs.fleet import FleetUniformityMonitor
from grapevine_tpu_torch.wire import constants as C
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

GENERATORS = {
    "steady": lambda g, seed: g.steady_poisson(200.0, 4.0, seed),
    "bursty": lambda g, seed: g.bursty_onoff(400.0, 0.25, 1.0, 4.0, seed),
    "diurnal": lambda g, seed: g.diurnal_sinusoid(200.0, 0.8, 2.0, 4.0, seed),
    "pop_heavy": lambda g, seed: g.pop_heavy_drain(200.0, 4.0, seed, n_idents=64, n_hot=4),
    "adversarial": lambda g, seed: g.adversarial_probe(0.05, 4.0, seed, n_probe_keys=4),
    "ramp": lambda g, seed: g.ramp_to_saturation(50.0, 2.0, 4, 1.0, seed),
}


def _assert_schedules_equal(t, j):
    assert t.scenario == j.scenario and t.duration_s == j.duration_s
    for f in ("t_s", "kind", "auth", "recipient"):
        a, b = getattr(t, f), getattr(j, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, f)
    assert t.meta == j.meta
    assert t.fingerprint() == j.fingerprint()
    assert t.n_ops == j.n_ops and t.offered_rate == j.offered_rate


@pytest.mark.parametrize("seed", [7, 8])
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_schedules_equal_reference(name, seed):
    t, j = GENERATORS[name](tgen, seed), GENERATORS[name](jgen, seed)
    _assert_schedules_equal(t, j)
    np.testing.assert_array_equal(t.empirical_rate(8), j.empirical_rate(8))
    for tp, jp in zip(tgen.partition_schedule(t, 3), jgen.partition_schedule(j, 3)):
        _assert_schedules_equal(tp, jp)


def test_malformed_generator_parameters_raise():
    for call in (lambda g: g.bursty_onoff(100.0, 1.5, 1.0, 4.0, 0),
                 lambda g: g.diurnal_sinusoid(100.0, 1.5, 1.0, 4.0, 0),
                 lambda g: g.ramp_to_saturation(100.0, 0.5, 4, 1.0, 0),
                 lambda g: g.pop_heavy_drain(100.0, 4.0, 0, n_idents=4, n_hot=4),
                 lambda g: g.partition_schedule(g.steady_poisson(10.0, 1.0, 0), 0)):
        for g in (tgen, jgen):
            with pytest.raises(ValueError):
                call(g)


def test_identity_pool_and_requests_equal_reference():
    assert th.identity_pool(300) == jh.identity_pool(300)
    sched = tgen.pop_heavy_drain(200.0, 1.0, 3, n_idents=16, n_hot=4)
    jsched = jgen.pop_heavy_drain(200.0, 1.0, 3, n_idents=16, n_hot=4)
    idents = th.identity_pool(16)
    payload = bytes(range(256)) * (C.PAYLOAD_SIZE // 256) + b"\x07" * (C.PAYLOAD_SIZE % 256)
    kinds = set()
    for i in range(sched.n_ops):
        t = th.materialize_request(idents, sched, i, payload)
        j = jh.materialize_request(idents, jsched, i, payload)
        assert t.pack() == j.pack()
        kinds.add(t.request_type)
    assert kinds == {C.REQUEST_TYPE_CREATE, C.REQUEST_TYPE_READ, C.REQUEST_TYPE_DELETE}
    assert th.OK_STATUSES == jh.OK_STATUSES


def _step(rate, burn, fail_frac=0.0, n=64):
    return {"offered_rate": rate, "arrival_rate": rate, "n_ops": n,
            "achieved_ops_per_sec": rate, "breach_fraction": burn * 0.01,
            "burn_rate": burn, "failure_fraction": fail_frac, "p99_commit_ms": 10.0}


KNEE_CASES = [
    [_step(100, 0.0), _step(200, 0.5), _step(400, 40.0), _step(800, 99.0)],
    [_step(100, 0.0), _step(200, 0.2)],
    [_step(100, 0.0), _step(200, 50.0), _step(400, 0.0)],
    [_step(100, 0.0), _step(200, 0.0, fail_frac=0.4)],
    [_step(100, 99.0, n=2)],
]


def test_capacity_model_equals_reference():
    for steps in KNEE_CASES:
        assert tcap.find_knee(steps) == jcap.find_knee(steps)
        assert tcap.find_knee(steps, burn_limit=0.3) == jcap.find_knee(steps, burn_limit=0.3)
    args = (100.0, 1.0, [0.001, np.nan, 0.5, 0.2], [True, False, True, True])
    assert tcap.step_stats(*args, target_ms=250.0, error_budget=0.01) == \
        jcap.step_stats(*args, target_ms=250.0, error_budget=0.01)
    for seed, split in ((23, 2.0), (24, 1.0)):
        sched = tgen.ramp_to_saturation(200.0, 2.0, 3, 1.0, seed)
        res = types.SimpleNamespace(
            time_scale=1.0, latency_s=np.where(sched.t_s < split, 0.01, 1.0),
            ok=np.ones(sched.n_ops, bool))
        jsched = jgen.ramp_to_saturation(200.0, 2.0, 3, 1.0, seed)
        out = tcap.analyze_ramp(sched, res, target_ms=250.0)
        assert out == jcap.analyze_ramp(jsched, res, target_ms=250.0)
        assert len(out["steps"]) == 3
    a = [tcap.find_knee(KNEE_CASES[0]), tcap.find_knee(KNEE_CASES[1])]
    assert tcap.fleet_capacity(a) == jcap.fleet_capacity(a)


class _WedgedScheduler:
    """Accepts every op instantly, completes none until released."""

    def __init__(self):
        self.submit_walls: list[float] = []
        self.futures: list[Future] = []
        self._lock = threading.Lock()

    def submit_nowait(self, req) -> Future:
        fut: Future = Future()
        with self._lock:
            self.submit_walls.append(time.perf_counter())
            self.futures.append(fut)
        return fut

    def release_all(self):
        for fut in self.futures:
            if not fut.done():
                fut.set_result(types.SimpleNamespace(status_code=C.STATUS_CODE_SUCCESS))


def test_replay_is_open_loop_and_schedule_immutable():
    sched = tgen.steady_poisson(150.0, 1.0, 21, n_idents=8)
    fp = sched.fingerprint()
    fake = _WedgedScheduler()
    runner = th.ScenarioRunner(fake, n_idents=8, settle_timeout_s=0.2)
    release = threading.Timer(1.6, fake.release_all)
    release.start()
    t0 = time.perf_counter()
    res = runner.run(sched)
    release.cancel()
    fake.release_all()
    assert len(fake.submit_walls) == sched.n_ops
    assert fake.submit_walls[-1] - t0 < sched.duration_s + 0.5
    skew = res.skew_s[~np.isnan(res.skew_s)]
    assert np.percentile(skew, 99) < 1.5
    assert sched.fingerprint() == fp
    with pytest.raises(ValueError):
        th.ScenarioRunner(fake, time_scale=0)


class _StubScheduler:
    def __init__(self):
        self.n = 0

    def submit_nowait(self, req):
        self.n += 1
        fut = Future()
        fut.set_result(types.SimpleNamespace(status_code=C.STATUS_CODE_SUCCESS))
        return fut


def test_sharded_runner_replays_partition_and_folds_capacity():
    sched = tgen.ramp_to_saturation(rate0=400.0, factor=2.0, n_steps=3, step_s=0.08, seed=5)
    stubs = [_StubScheduler(), _StubScheduler()]
    results = th.ShardedScenarioRunner(stubs, settle_timeout_s=5.0).run(sched)
    assert len(results) == 2 and sum(s.n for s in stubs) == sched.n_ops
    assert all(r.summary()["n_ok"] == r.schedule.n_ops for r in results)
    analyses = [tcap.analyze_ramp(r.schedule, r, target_ms=250.0) for r in results]
    fleet = tcap.fleet_capacity(analyses)
    assert fleet["shard_count"] == 2
    assert fleet["fleet_knee_ops_per_sec"] == pytest.approx(
        sum(a["knee_ops_per_sec"] for a in analyses))
    with pytest.raises(ValueError):
        th.ShardedScenarioRunner([])


@pytest.mark.parametrize("policy,stop", [("uniform", None), ("skewed", "SUSPECT")])
def test_shard_round_driver_verdicts_equal_reference(policy, stop):
    def arrivals(seed):
        rng = np.random.default_rng(seed)
        return lambda k: [12 if (k // 8) % 2 == 0 else 0] + [
            int(rng.poisson(2)) for _ in range(2)]

    t = th.ShardRoundDriver(3, FleetUniformityMonitor(3), policy=policy)
    j = jh.ShardRoundDriver(3, JFleetMon(3), policy=policy)
    vt = t.run(arrivals(11), 120, stop_on=stop)
    vj = j.run(arrivals(11), 120, stop_on=stop)
    assert vt == vj
    assert vt["verdict"] == ("PASS" if policy == "uniform" else "SUSPECT")
    assert (t.rounds, t.flushes, t.queue) == (j.rounds, j.flushes, j.queue)
    with pytest.raises(ValueError):
        th.ShardRoundDriver(1, FleetUniformityMonitor(2))
