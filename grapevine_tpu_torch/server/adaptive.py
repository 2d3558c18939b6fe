"""SLO-adaptive round-collection sizing from PUBLIC load aggregates (a copy
of ``grapevine_tpu/server/adaptive.py``).

The engine's batch geometry is compile-fixed (`ecfg.batch_size` slots,
under-full rounds dummy-padded), so "adaptive batch sizing" on this
stack means choosing how long the scheduler's collection window stays
open and how many real ops it waits for — the two knobs that trade
commit latency against round occupancy without touching the device
program. This module makes that choice each round from three signals:

- the **arrival-rate EWMA** (obs/workload.py) — ops/s, decayed;
- the **queue depth** at window open — ops already waiting;
- the **SLO burn rates** (obs/slo.py) — how fast the commit-
  latency error budget is being spent.

Every input is a batch-level public aggregate: counts, rates, and
latency quantiles the telemetry leak policy already exports on
/metrics. Nothing here may read request contents, identities, keys, or
the op-type mix — the decision must stay a function a passive observer
of /metrics could compute themselves, because the round cadence it
shapes is visible on the wire. ``decide()`` takes only the queue
*depth* (an integer), never the queue, and the reference's CI seeds a
mutant that threads op contents into the decision to prove its analyzers
catch the violation.

Policy (one decision per round, at window open):

1. **shed** — the fast burn window is spending error budget above its
   alert threshold: the SLO is in danger, so collection drops to the
   floor window and dispatches at the first quiescence gap. Smaller
   rounds cost device efficiency but cut the queue-wait term of every
   op's latency — the correct trade while the budget burns.
2. **fill** — ops already queued (depth >= batch_size): no reason to
   wait; the round leaves full regardless.
3. **sparse** — the EWMA expects less than ~one arrival inside even a
   stretched window: holding the window open buys nothing, so a lone
   client commits after the floor wait instead of the full cap.
4. **cruise** — in between: the window scales with the traffic so the
   expected fill approaches the batch size, capped at
   ``ceil_factor x`` the configured base wait. This is where adaptive
   sizing beats the static window: bursty-but-sub-saturating load gets
   fuller rounds (fewer rounds per op, more device headroom) without
   penalizing the sparse tail.
"""

from __future__ import annotations

import dataclasses
import math

#: decision-kind label values for grapevine_host_adaptive_decisions_total
DECISION_KINDS = ("shed", "fill", "sparse", "cruise")


@dataclasses.dataclass(frozen=True)
class AdaptiveBatchConfig:
    """Shape of the adaptive window policy (OPERATIONS.md §24)."""

    #: the floor collection window (ms): what "dispatch promptly" means
    #: under shed/sparse. Never 0 — a zero window would dispatch
    #: singleton rounds under concurrent load and waste whole batches.
    floor_wait_ms: float = 1.0
    #: cruise may stretch the window up to base_wait * ceil_factor when
    #: the arrival rate suggests a fuller round is one short wait away
    ceil_factor: float = 4.0
    #: fast-window burn rate above which the policy sheds latency
    #: (1.0 = spending exactly the error budget)
    shed_burn_rate: float = 1.0
    #: minimum rounds of burn-rate evidence before shed may trigger
    #: (insufficient evidence is not an overload — the SLO tracker's
    #: own min_rounds stance)
    min_burn_rounds: int = 16

    def __post_init__(self):
        if self.floor_wait_ms <= 0:
            raise ValueError("floor_wait_ms must be positive")
        if self.ceil_factor < 1.0:
            raise ValueError("ceil_factor must be >= 1")


class AdaptiveBatchPolicy:
    """Per-round window decisions; one instance per BatchScheduler.

    ``workload`` is an obs.WorkloadTelemetry (arrival EWMA) and ``slo``
    an obs.SloTracker (burn rates) — both optional so the policy
    degrades to static behavior when a signal is missing (a stub engine
    in tests, or an SLO-less deployment).
    """

    def __init__(
        self,
        batch_size: int,
        base_wait_s: float,
        idle_gap_s: float,
        cfg: AdaptiveBatchConfig | None = None,
        workload=None,
        slo=None,
        registry=None,
    ):
        if batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        self.batch_size = int(batch_size)
        self.base_wait = float(base_wait_s)
        self.idle_gap = float(idle_gap_s)
        self.cfg = cfg or AdaptiveBatchConfig()
        self.workload = workload
        self.slo = slo
        self._g_wait = self._g_target = self._c_decisions = None
        if registry is not None:
            self._g_wait = registry.gauge(
                "grapevine_host_adaptive_wait_ms",
                "collection-window cap chosen by the adaptive batch "
                "policy for the current round (ms)")
            self._g_target = registry.gauge(
                "grapevine_host_adaptive_target_fill",
                "real-op fill target chosen for the current round "
                "(<= the compiled batch size; the round is dummy-"
                "padded to geometry either way)")
            self._c_decisions = registry.counter(
                "grapevine_host_adaptive_decisions_total",
                "adaptive window decisions by kind",
                labels={"phase": DECISION_KINDS})

    # -- signal reads (each tolerates a missing provider) ---------------

    def _arrival_rate(self) -> float:
        if self.workload is None:
            return 0.0
        try:
            return float(self.workload.arrival_rate())
        except Exception:  # pragma: no cover - defensive
            return 0.0

    def _fast_burn(self) -> tuple[float, int]:
        if self.slo is None:
            return 0.0, 0
        try:
            rates = self.slo.burn_rates()
            return float(rates["fast_burn_rate"]), int(rates["fast_rounds"])
        except Exception:  # pragma: no cover - defensive
            return 0.0, 0

    # -- the per-round decision -----------------------------------------

    def decide(self, queue_depth: int) -> tuple[float, float, int]:
        """(max_wait_s, idle_gap_s, target_fill) for the round about to
        be collected. ``queue_depth`` is the scheduler queue length at
        window open — an integer aggregate, never the queue itself."""
        cfg = self.cfg
        floor = cfg.floor_wait_ms / 1000.0
        rate = self._arrival_rate()
        burn, burn_rounds = self._fast_burn()
        bs = self.batch_size
        if burn > cfg.shed_burn_rate and burn_rounds >= cfg.min_burn_rounds:
            kind, wait, target = "shed", floor, max(1, queue_depth)
        elif queue_depth >= bs:
            kind, wait, target = "fill", floor, bs
        else:
            need = bs - queue_depth
            expected = rate * self.base_wait
            if expected < 1.0:
                kind, wait, target = "sparse", floor, max(1, queue_depth)
            else:
                # stretch the window toward the time the EWMA says a
                # full round takes to accumulate, capped at the ceiling
                t_full = need / rate if rate > 0 else self.base_wait
                wait = min(self.base_wait * cfg.ceil_factor,
                           max(self.base_wait, t_full))
                kind, target = "cruise", bs
        target = min(bs, max(1, int(math.ceil(target))))
        if self._c_decisions is not None:
            self._c_decisions.inc(phase=kind)
            self._g_wait.set(wait * 1000.0)
            self._g_target.set(target)
        return wait, min(self.idle_gap, wait), target
