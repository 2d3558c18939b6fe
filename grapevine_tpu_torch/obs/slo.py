"""End-to-end commit-latency SLOs with multi-window burn-rate alerting (a
copy of ``grapevine_tpu/obs/slo.py``).

The client-visible number a serving deployment actually promises is not
device-round time but **commit latency**: the wall clock from the moment
an op is enqueued in the scheduler to the moment its round settles and
the response is delivered (the "commit latency a client observes" note
in engine/batcher.py, where the measurement lives). This module turns
that into an operable SLO:

- a fixed-bucket histogram of per-round commit latencies (batch-level:
  one observation per round — the round's *oldest* op's enqueue→settle
  wait, i.e. the worst case inside the batch, which is what a latency
  objective is about);
- a configurable latency target (``--slo-commit-p99-ms``) with an error
  budget: the SLO is "at most ``error_budget`` of rounds may exceed the
  target";
- multi-window **burn rates** (the SRE-workbook alerting shape): the
  windowed breach fraction divided by the error budget, over a fast and
  a slow window. The verdict alerts only when BOTH windows burn above
  their thresholds — the fast window makes the alert responsive, the
  slow window keeps a transient spike from paging — and the verdict is
  folded into ``/healthz`` by the serving layers so a breached SLO
  stops routing like any other serving fault.

Leak stance (the registry's contract): everything here is round-level. The
observation is one scalar per round; the histogram's buckets are fixed
at registration; the exported series carry no labels. There is no
per-op, per-client, or per-type dimension anywhere — a latency SLO keyed
by op type would be exactly the timing side channel the engine exists
to close (obs/registry.py).

Thread-safety: one lock around the breach window; ``observe()`` runs on
the collector thread (PendingRound.resolve), ``verdict()`` on the
healthz probe thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque

from .registry import TelemetryRegistry

#: fixed commit-latency histogram boundaries (seconds): spans sub-ms
#: loopback rounds up to multi-second cold-compile and recovery rounds
SLO_LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
    0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """SLO target and burn-rate alerting shape (OPERATIONS.md §12)."""

    #: commit-latency objective: rounds settling slower than this breach
    commit_p99_ms: float = 250.0
    #: gate /healthz on the burn-rate alert. False = observe-only: the
    #: histograms, burn gauges, and ``grapevine_slo_alert`` still
    #: export, but ``verdict()["ok"]`` never goes False — the CLI
    #: default until the operator sets ``--slo-commit-p99-ms``
    #: explicitly, because a fleet upgraded with a target its honest
    #: latency cannot meet would otherwise flip EVERY replica to 503 at
    #: once (the breach is config-wide, not per-instance) with no flag
    #: to restore routing
    enforce: bool = True
    #: allowed breaching fraction of rounds (the error budget): 0.01 =
    #: "99% of rounds commit within the target"
    error_budget: float = 0.01
    #: burn-rate windows (seconds) and alert thresholds. The defaults
    #: are the SRE-workbook fast/slow pair: 14.4× over 5 min spends a
    #: 30-day budget in ~2 h; 6× over 1 h spends it in ~5 days.
    fast_window_s: float = 300.0
    slow_window_s: float = 3600.0
    fast_burn_threshold: float = 14.4
    slow_burn_threshold: float = 6.0
    #: minimum rounds in a window before it may alert — insufficient
    #: evidence is not an outage (the leakmon min-samples stance); keeps
    #: a cold engine's first compile-bearing rounds from paging
    min_rounds: int = 32
    #: hard cap on tracked rounds (bounds memory at high round rates; at
    #: the cap the slow window effectively covers the last N rounds)
    max_tracked_rounds: int = 65536


class SloTracker:
    """Round-level commit-latency SLO accounting + burn-rate verdict."""

    def __init__(
        self,
        cfg: SloConfig | None = None,
        registry: TelemetryRegistry | None = None,
        clock=time.monotonic,
    ):
        self.cfg = cfg or SloConfig()
        if self.cfg.error_budget <= 0 or self.cfg.error_budget >= 1:
            raise ValueError("error budget must be in (0, 1)")
        self._clock = clock
        self._lock = threading.Lock()
        #: (t_mono, breached) per observed round, oldest first
        self._window: deque = deque(maxlen=self.cfg.max_tracked_rounds)
        self._h_latency = None
        self._c_rounds = self._c_breaches = None
        self._g_fast = self._g_slow = self._g_alert = self._g_target = None
        if registry is not None:
            self._h_latency = registry.histogram(
                "grapevine_slo_commit_latency_seconds",
                "end-to-end commit latency per round: oldest-op enqueue "
                "to round settle (batch-level; one sample per round)",
                buckets=SLO_LATENCY_BUCKETS)
            self._c_rounds = registry.counter(
                "grapevine_slo_rounds_total",
                "rounds measured against the commit-latency SLO")
            self._c_breaches = registry.counter(
                "grapevine_slo_breaches_total",
                "rounds whose commit latency exceeded the SLO target")
            self._g_fast = registry.gauge(
                "grapevine_slo_burn_rate_fast",
                "fast-window error-budget burn rate (breach fraction / "
                "budget; 1.0 = spending exactly the budget)")
            self._g_slow = registry.gauge(
                "grapevine_slo_burn_rate_slow",
                "slow-window error-budget burn rate")
            self._g_alert = registry.gauge(
                "grapevine_slo_alert",
                "1 while the multi-window burn-rate alert is firing "
                "(folded into /healthz)")
            self._g_target = registry.gauge(
                "grapevine_slo_target_ms",
                "configured commit-latency SLO target (milliseconds)")
            self._g_target.set(self.cfg.commit_p99_ms)

    # -- recording (collector thread) -----------------------------------

    def observe(self, latency_s: float) -> None:
        """Record one round's commit latency (enqueue→settle seconds)."""
        latency_s = float(latency_s)
        breached = latency_s > self.cfg.commit_p99_ms / 1e3
        now = self._clock()
        with self._lock:
            self._window.append((now, breached))
            self._prune_locked(now)
        if self._h_latency is not None:
            self._h_latency.observe(latency_s)
            self._c_rounds.inc()
            if breached:
                self._c_breaches.inc()

    def _prune_locked(self, now: float) -> None:
        horizon = now - max(self.cfg.slow_window_s, self.cfg.fast_window_s)
        w = self._window
        while w and w[0][0] < horizon:
            w.popleft()

    # -- judging (healthz probe thread) ---------------------------------

    def _window_stats_locked(self, now: float, win_s: float):
        cutoff = now - win_s
        n = breaches = 0
        for t, b in reversed(self._window):
            if t < cutoff:
                break
            n += 1
            breaches += b
        return n, breaches

    def burn_rates(self) -> dict:
        """Windowed burn rates and sample counts (no verdict)."""
        now = self._clock()
        with self._lock:
            self._prune_locked(now)
            n_fast, b_fast = self._window_stats_locked(
                now, self.cfg.fast_window_s)
            n_slow, b_slow = self._window_stats_locked(
                now, self.cfg.slow_window_s)
        budget = self.cfg.error_budget
        return {
            "fast_burn_rate": round(
                (b_fast / n_fast) / budget if n_fast else 0.0, 4),
            "slow_burn_rate": round(
                (b_slow / n_slow) / budget if n_slow else 0.0, 4),
            "fast_rounds": n_fast,
            "slow_rounds": n_slow,
        }

    def verdict(self) -> dict:
        """Machine-readable SLO verdict; ``alerting`` is True while the
        multi-window burn-rate alert fires (both windows above their
        thresholds with enough evidence), and ``ok`` goes False only
        when the config also ``enforce``\\ s (the /healthz gate).
        Updates the burn gauges so /metrics and /healthz agree."""
        cfg = self.cfg
        rates = self.burn_rates()
        alerting = (
            rates["fast_rounds"] >= cfg.min_rounds
            and rates["slow_rounds"] >= cfg.min_rounds
            and rates["fast_burn_rate"] > cfg.fast_burn_threshold
            and rates["slow_burn_rate"] > cfg.slow_burn_threshold
        )
        if self._g_fast is not None:
            self._g_fast.set(rates["fast_burn_rate"])
            self._g_slow.set(rates["slow_burn_rate"])
            self._g_alert.set(1.0 if alerting else 0.0)
        return {
            "ok": not (alerting and cfg.enforce),
            "alerting": alerting,
            "enforced": cfg.enforce,
            "target_ms": cfg.commit_p99_ms,
            "error_budget": cfg.error_budget,
            "fast_window_s": cfg.fast_window_s,
            "slow_window_s": cfg.slow_window_s,
            **rates,
        }
