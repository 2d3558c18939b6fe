"""Scenario-diverse load harness (port of ``grapevine_tpu/load/``; numpy,
the port's ``wire/`` and, for the probe injector, the port's
``engine/round_step.transcript_key_groups`` — no JAX).

Deterministic, seeded, **open-loop** arrival-schedule generators plus a
replay harness that drives them through the production BatchScheduler:

- ``generators``: pre-materialized (timestamp, op-template) schedules —
  steady Poisson, bursty ON/OFF, diurnal sinusoid, pop-heavy mailbox
  drain, an adversarial probe campaign aimed at the leakmon detectors,
  and a ramp-to-saturation staircase;
- ``harness``: ``ScenarioRunner`` (open-loop replay via
  ``BatchScheduler.submit_nowait`` — overload latency is measured, not
  self-throttled) and the probe-campaign leak injector for the
  /leakaudit discrimination drill;
- ``capacity``: per-step SLO accounting over a ramp schedule and the
  saturation-knee model: the knee is the capacity number.

Fleet-shaped replay: ``partition_schedule`` splits one
schedule across N shards by recipient space, ``ShardedScenarioRunner``
replays the parts against N schedulers concurrently,
``ShardRoundDriver`` is the cross-shard schedule-uniformity
discrimination drill (uniform contract vs the seeded skewed-scheduler
mutant), and ``fleet_capacity`` folds per-shard knees into the
fleet-wide grade. The "shards" are fleet processes, each a
``BatchScheduler`` over its own engine, not a device mesh.
"""

from .generators import (  # noqa: F401
    Schedule,
    adversarial_probe,
    bursty_onoff,
    diurnal_sinusoid,
    partition_schedule,
    pop_heavy_drain,
    ramp_to_saturation,
    steady_poisson,
)
from .harness import (  # noqa: F401
    ProbeCampaignInjector,
    RunResult,
    ScenarioRunner,
    ShardedScenarioRunner,
    ShardRoundDriver,
    calibrate_unloaded_round,
    materialize_request,
)
from .capacity import analyze_ramp, find_knee, fleet_capacity  # noqa: F401
