"""Slow-tier fleet uniformity soaks on the port: the discrimination drill
of ``tests/test_torch_fleet.py`` re-run with real port engine rounds
behind every shard round (the JAX package's ``tests/test_fleet_soak.py``
is the model, case for case).

``ShardRoundDriver.round_fn`` runs a live ``engine_round_step`` on the
CPU per dispatch, so the monitor judges a fleet whose per-shard cadence
is carried by real oblivious rounds. Arrival shapes come from the
port's generators (bursty ON/OFF and the diurnal sinusoid), partitioned
by recipient across shards and binned onto the shared tick clock. Honest
uniform scheduling must PASS under both; the seeded skewed mutant must
turn SUSPECT within its tick budget.

Excluded from tier-1 (``-m slow``), as the reference's is.
"""


from __future__ import annotations

import numpy as np
import pytest

from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import batch_to_device
from grapevine_tpu_torch.engine.round_step import engine_round_step
from grapevine_tpu_torch.engine.state import (
    ID_WORDS,
    KEY_WORDS,
    PAYLOAD_WORDS,
    EngineConfig,
    init_engine,
)
from grapevine_tpu_torch.load.generators import (
    bursty_onoff,
    diurnal_sinusoid,
    partition_schedule,
)
from grapevine_tpu_torch.load.harness import ShardRoundDriver
from grapevine_tpu_torch.obs.leakmon import FleetUniformityMonitor
from _torch_threads import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.slow

N_SHARDS = 3
BATCH = 4

SMALL = GrapevineConfig(
    max_messages=64, max_recipients=8, mailbox_cap=4,
    batch_size=BATCH, stash_size=64, bucket_cipher_rounds=0,
)


@pytest.fixture(scope="module")
def fleet_engines():
    """One round step + N independent engine states on the CPU (same
    geometry, different seeds: shards share a program, never state)."""
    ecfg = EngineConfig.from_config(SMALL)

    def step(st, batch):
        return engine_round_step(ecfg, st, batch_to_device(batch, "cpu"))

    states = [init_engine(ecfg, seed=100 + i, device="cpu") for i in range(N_SHARDS)]
    # one round up front so soak timing is steady-state
    states[0], _, _ = step(states[0], _mk_batch(np.random.default_rng(0), 1, BATCH))
    return step, states


def _mk_batch(rng, n_real: int, batch_size: int) -> dict:
    """A CREATE-heavy round batch: n_real live ops + padding NOPs
    (req_type 0), the same shape the production batcher dispatches."""
    req = np.zeros((batch_size,), np.uint32)
    req[:n_real] = 1  # CREATE
    return {
        "req_type": req,
        "auth": rng.integers(
            1, 2**31, (batch_size, KEY_WORDS)).astype(np.uint32),
        "msg_id": np.zeros((batch_size, ID_WORDS), np.uint32),
        "recipient": rng.integers(
            1, 2**31, (batch_size, KEY_WORDS)).astype(np.uint32),
        "payload": rng.integers(
            0, 2**31, (batch_size, PAYLOAD_WORDS)).astype(np.uint32),
        "now": np.uint32(1_700_000_000),
        "now_hi": np.uint32(0),
    }


def _live_round_fn(step, states, seed=0):
    rng = np.random.default_rng(seed)

    def round_fn(shard: int, n_real: int) -> None:
        states[shard], _resp, _t = step(
            states[shard], _mk_batch(rng, n_real, BATCH))

    return round_fn


#: per-shard popularity skew applied on top of the recipient-mod
#: partition: a uniform partition equalizes only EXPECTED load, while
#: real recipient populations are zipf-ish — shard 0 holds the hot
#: mailboxes, shard 2 the cold tail. This asymmetry is what the mutant
#: leaks (its cadence follows it) and simultaneously the honest
#: policy's hardest false-positive case (its cadence must not).
POPULARITY_SKEW = (3.0, 1.0, 0.3)

N_BINS = 64  # tick bins per 40 s schedule (0.625 s ticks)


def _binned_arrivals(schedule):
    """Partition a generator schedule by recipient space, apply the
    popularity skew, and bin each shard's arrival instants onto the
    shared tick clock. Ticks past the schedule wrap (the traffic shape
    repeats) so soaks can outlast one generated window."""
    parts = partition_schedule(schedule, N_SHARDS)
    duration = float(schedule.duration_s)
    counts = [
        np.round(
            np.histogram(p.t_s, bins=N_BINS, range=(0.0, duration))[0] * s
        ).astype(int)
        for p, s in zip(parts, POPULARITY_SKEW)
    ]
    return lambda k: [int(c[k % N_BINS]) for c in counts]


# offered load sits BELOW per-shard drain capacity on purpose: a shard
# whose queue never goes cold dispatches every tick under either
# policy, masking the mutant (an overloaded fleet leaks nothing through
# cadence because there is no idleness to modulate)
ARRIVAL_SHAPES = {
    "bursty": lambda: bursty_onoff(
        rate_on=45.0, duty=0.2, period_s=8.0, duration_s=40.0, seed=21),
    "diurnal": lambda: diurnal_sinusoid(
        mean_rate=15.0, rel_amplitude=0.9, period_s=10.0,
        duration_s=40.0, seed=22),
}

#: bounded-detection budget per shape: the bursty mutant trips within
#: a 64-round bound (long queue-cold OFF runs give the
#: correlation detector its contrast fast); the smooth diurnal ramp
#: yields weaker per-tick evidence, so its bound is one full detector
#: window (128 aligned ticks) — still bounded, just slower, exactly
#: the degraded-evidence semantics OPERATIONS.md §20 documents
MUTANT_TICK_BUDGET = {"bursty": 64, "diurnal": 128}


@pytest.mark.parametrize("shape", sorted(ARRIVAL_SHAPES))
def test_honest_uniform_soak_with_real_engines_passes(
        fleet_engines, shape):
    """The false-positive budget: honest uniform scheduling over live
    engine rounds stays PASS for a full detector window under traffic
    shapes chosen to stress it (per-shard load is allowed to be
    anything; only the SCHEDULE must be uniform)."""
    step, states = fleet_engines
    n_ticks = 160  # > window_ticks: the verdict judges a full window
    mon = FleetUniformityMonitor(N_SHARDS)
    drv = ShardRoundDriver(
        N_SHARDS, mon, policy="uniform", batch_size=BATCH,
        round_fn=_live_round_fn(step, states, seed=31))
    v = drv.run(_binned_arrivals(ARRIVAL_SHAPES[shape]()), n_ticks)
    assert v["verdict"] == "PASS", v
    for det in v["detectors"]:
        assert det["verdict"] == "PASS", det
    # the drill really ran live rounds: every shard committed one per tick
    assert drv.rounds == [n_ticks] * N_SHARDS


@pytest.mark.parametrize("shape", sorted(ARRIVAL_SHAPES))
def test_skewed_mutant_with_real_engines_suspects(fleet_engines, shape):
    """The seeded mutant over live engines: load-gated dispatch must
    flip the fleet verdict within the per-shape tick budget (64 for
    bursty; one full window for diurnal)."""
    step, states = fleet_engines
    budget = MUTANT_TICK_BUDGET[shape]
    mon = FleetUniformityMonitor(N_SHARDS)
    drv = ShardRoundDriver(
        N_SHARDS, mon, policy="skewed", batch_size=BATCH,
        round_fn=_live_round_fn(step, states, seed=33))
    v = drv.run(_binned_arrivals(ARRIVAL_SHAPES[shape]()), budget,
                stop_on="SUSPECT")
    assert v["verdict"] == "SUSPECT", v
    assert v["ticks"] <= budget
