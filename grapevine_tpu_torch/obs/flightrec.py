"""Round flight recorder: a fixed-size ring of per-round summaries (a copy
of ``grapevine_tpu/obs/flightrec.py``).

The black-box analog for the oblivious engine: when the leak monitor
(obs/leakmon.py) or an operator needs to reconstruct *what the engine
was doing* around a SUSPECT verdict or a healthz degradation, the
recorder holds the last N rounds' batch-level summaries — batch fill,
host phase timings, detector statistics — dumpable as JSON on demand
(the /flightrec endpoint, obs/httpd.py) or automatically on a
PASS→SUSPECT transition (OPERATIONS.md runbook).

Leak stance — enforced structurally, like the telemetry registry's
label allowlist rather than by convention: ``record()`` validates every
summary against a fixed field schema and rejects anything else with
:class:`TelemetryLeakError`. A summary can only carry batch-level
scalars (fill, phase seconds, windowed detector statistics, verdict
strings); there is no field in which a logical key, a recipient id, a
message id, or a per-op timestamp *could* travel, so the dump is safe
to hand to an operator or attach to an incident ticket. A test
(tests/test_torch_leakmon.py) asserts both the schema enforcement and the
dump's cleanliness.

Thread-safety: one lock around the ring; ``record()`` runs on the leak
monitor's worker thread, ``dump()`` on the metrics scrape thread.
"""

from __future__ import annotations

import json
import threading
import time

from .phases import PHASES
from .registry import TelemetryLeakError

#: top-level summary fields a recorded round may carry. ``phase_s`` is
#: a {phase name: seconds} dict over the canonical PHASES (+ "round"
#: for the commit latency); ``stats`` is {tree: {stat name: number}}
#: over the detector stat fields below. Everything else is a scalar.
ALLOWED_FIELDS = frozenset({
    "seq",         # monotone engine-round sequence number (recorder-local)
    "t_mono_s",    # round-level monotonic clock (batch-level; never per-op)
    "batch_size",  # configured slots per round
    "n_real",      # real (non-padding) ops in the round — an aggregate
    "fill",        # n_real / batch_size
    "queue_depth", # ops left waiting at dispatch (scheduler backlog —
                   # an aggregate of the queue, never of any op in it)
    "phase_s",     # {phase: seconds} host phase timings for this round
    "stats",       # {tree: {stat: number}} windowed detector statistics
    "verdict",     # "PASS" / "SUSPECT" at the time the round was recorded
})

ALLOWED_PHASE_KEYS = frozenset(PHASES) | {"round"}

#: detector streams: the two payload trees plus — under a recursive
#: position map (oram/posmap.py) — their internal position-ORAM streams.
#: All four are windowed batch-level statistics, never per-op.
ALLOWED_TREES = frozenset({"rec", "mb", "rec_pm", "mb_pm"})

ALLOWED_STAT_KEYS = frozenset({
    "collision_rate", "collision_pairs",
    "repeat_rate", "repeat_opportunities",
    "uniformity_z", "pooled_leaves",
})

_SCALARS = (int, float, str, bool, type(None))


def _check_scalar(field: str, value) -> None:
    if not isinstance(value, _SCALARS):
        raise TelemetryLeakError(
            f"flight recorder: field {field!r} holds a {type(value).__name__}"
            " — summaries are batch-level scalars only (an array-valued "
            "field is how per-op data would leak into a dump)"
        )


class FlightRecorder:
    """Fixed-size ring of schema-checked per-round summaries."""

    def __init__(self, capacity: int = 512):
        if capacity <= 0:
            raise ValueError("flight recorder capacity must be positive")
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: list[dict] = [None] * capacity  # type: ignore[list-item]
        self._n = 0  # total rounds ever recorded

    # -- recording ------------------------------------------------------

    def record(self, summary: dict) -> None:
        """Append one round summary; raises TelemetryLeakError unless it
        fits the batch-level schema exactly."""
        if not isinstance(summary, dict):
            raise TelemetryLeakError("flight recorder: summary must be a dict")
        unknown = set(summary) - ALLOWED_FIELDS
        if unknown:
            raise TelemetryLeakError(
                f"flight recorder: fields {sorted(unknown)} are not in the "
                f"summary schema {sorted(ALLOWED_FIELDS)} — there is no "
                "field for per-op or per-client data by design"
            )
        clean: dict = {}
        for field, value in summary.items():
            if field == "phase_s":
                if not isinstance(value, dict):
                    raise TelemetryLeakError(
                        "flight recorder: phase_s must be {phase: seconds}")
                bad = set(value) - ALLOWED_PHASE_KEYS
                if bad:
                    raise TelemetryLeakError(
                        f"flight recorder: unknown phases {sorted(bad)} "
                        f"(allowed: {sorted(ALLOWED_PHASE_KEYS)})"
                    )
                for k, v in value.items():
                    _check_scalar(f"phase_s[{k}]", v)
                clean[field] = dict(value)
            elif field == "stats":
                if not isinstance(value, dict):
                    raise TelemetryLeakError(
                        "flight recorder: stats must be {tree: {stat: num}}")
                bad = set(value) - ALLOWED_TREES
                if bad:
                    raise TelemetryLeakError(
                        f"flight recorder: unknown trees {sorted(bad)} "
                        f"(allowed: {sorted(ALLOWED_TREES)})"
                    )
                trees: dict = {}
                for tree, stats in value.items():
                    if not isinstance(stats, dict):
                        raise TelemetryLeakError(
                            "flight recorder: per-tree stats must be a dict")
                    badstat = set(stats) - ALLOWED_STAT_KEYS
                    if badstat:
                        raise TelemetryLeakError(
                            f"flight recorder: unknown stats {sorted(badstat)}"
                            f" (allowed: {sorted(ALLOWED_STAT_KEYS)})"
                        )
                    for k, v in stats.items():
                        _check_scalar(f"stats[{tree}][{k}]", v)
                    trees[tree] = dict(stats)
                clean[field] = trees
            else:
                _check_scalar(field, value)
                clean[field] = value
        with self._lock:
            self._ring[self._n % self.capacity] = clean
            self._n += 1

    # -- dumping --------------------------------------------------------

    def dump(self) -> dict:
        """JSON-able snapshot: the retained rounds, oldest first."""
        with self._lock:
            n = self._n
            if n <= self.capacity:
                rounds = [r for r in self._ring[:n]]
            else:
                cut = n % self.capacity
                rounds = self._ring[cut:] + self._ring[:cut]
        return {
            "capacity": self.capacity,
            "recorded_total": n,
            "retained": len(rounds),
            "rounds": rounds,
        }

    def dump_json(self) -> str:
        return json.dumps(self.dump())

    def dump_to(self, path: str) -> str:
        """Write the dump to ``path`` (the SUSPECT runbook artifact);
        returns the path."""
        payload = self.dump()
        payload["dumped_at_mono_s"] = round(time.monotonic(), 3)
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(payload, fh)
        return path
