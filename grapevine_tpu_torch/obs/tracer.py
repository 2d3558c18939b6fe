"""Round-trace profiler: a fixed ring of per-round span ledgers (a copy of
``grapevine_tpu/obs/tracer.py``).

The flight recorder (obs/flightrec.py) answers *what* the engine was
doing (fill, detector stats); this module answers *where the time went*
— the question that sizes ROADMAP items 1-2 (tree-top caching, pipelined
rounds) before anyone builds them. Each committed round contributes one
span ledger assembled from the phase timers the engine already runs
(assembly/verify/dispatch/journal/checkpoint/evict/demux, the facade's
stages inside and before dispatch, plus the host-observed device
window), kept in a fixed ring like the flight
recorder and exported two ways:

- ``chrome_trace()`` — Chrome trace-event JSON (the ``/trace`` endpoint,
  obs/httpd.py), loadable directly in Perfetto / chrome://tracing, with
  host spans and the device window on separate tracks so the
  host/device overlap is visible per round. Rounds alternate between
  two lanes per track (tid = lane): the pipelined scheduler keeps up to
  two rounds in flight, and the trace-event format requires complete
  (``X``) events on one tid to nest or stay disjoint — consecutive
  overlapping rounds on a single track would misrender;
- ``grapevine_round_bubble_ratio`` — a derived gauge: the windowed mean
  fraction of each round's wall clock the host spends *blocked* on the
  device (the ``evict`` wait over the whole round span). This is the
  number that sizes the pipelined-round refactor (Palermo,
  arXiv:2411.05400, motivates protocol/hardware pipelining from exactly
  this phase-overlap accounting). Read it as the host/device balance
  ``b``: with one device, double-buffered rounds take
  ``max(host, device)`` instead of today's ``host + device``, so the
  steady-state speedup is ``1 / max(b, 1-b)`` — maximal (≈2×) at
  ``b ≈ 0.5``, and ≈1× at *both* extremes: near 0 the host path is the
  bottleneck (scale frontends / host pipeline instead), near 1 the
  round is device-bound and there is no second device to overlap with
  (attack the device round itself — tree-top caching, ROADMAP item 1).

Leak stance — the registry's contract, enforced structurally: a span is a
*phase*, never an operation. ``record_round()`` validates every ledger
against the fixed span-name allowlist (the canonical phases, the
derived ``device``/``round`` windows and the facade's :data:`STAGE_SPANS`)
and rejects anything else with
:class:`TelemetryLeakError`; a span value is exactly a ``(start,
duration)`` pair of floats. There is no field in which an op type, a
client identity, or a per-op timestamp *could* travel — every span
covers the whole fixed-size round, so its timing is a function of
(capacity, batch size), never of the ops inside (obs/phases.py).

Shape stability: every recorded ledger is normalized to carry exactly
:data:`STABLE_SPANS` — configurations without durability contribute
zero-duration ``journal``/``checkpoint`` spans rather than omitting
them, so trace consumers (and the A/B tooling diffing two configs) see
the same JSON shape everywhere.

Timestamps are ``time.perf_counter`` seconds (one clock domain across
the scheduler and batcher call sites); the Chrome export converts to
microseconds as the trace-event format requires.

Span pairing: collector-side spans (assembly/verify) are stamped onto
the round's own handle (engine/batcher.py PendingRound.note_span), so a
ledger always describes exactly one round even under the pipelined
scheduler — there is no cross-round staging here.

Thread-safety: one lock around the ring; ``record_round()`` runs on the
collector thread (PendingRound.resolve), ``chrome_trace()`` on the
metrics scrape thread.
"""

from __future__ import annotations

import json
import math
import threading

from .phases import PHASES
from .registry import TelemetryLeakError, TelemetryRegistry

#: spans assembled on the host side of every round (obs/phases.py names)
HOST_SPANS = (
    "assembly", "verify", "dispatch", "journal", "checkpoint",
    "evict", "demux",
)

#: every recorded ledger carries exactly these spans (missing ones are
#: normalized to zero duration at the round start) — the stable shape
#: contract consumers rely on across durability/impl configs
STABLE_SPANS = HOST_SPANS + ("device", "round")

#: the stages of a round on the facade's direct path
#: (engine/batcher.py), each with the span it nests in: ``pack`` (validate
#: and pack the wire records, before the engine lock) opens the round, and
#: the other four split ``dispatch`` in order (the pinned upload, the
#: admission bound, the enqueue of the round's kernels, the enqueue of the
#: copies of its outputs and their event). A stage, like a phase, covers
#: the whole fixed-size round. Not in STABLE_SPANS: a ledger without them
#: keeps the reference's shape
STAGE_PARENTS = {"pack": "round", "upload": "dispatch", "admit": "dispatch",
                 "launch": "dispatch", "download": "dispatch"}
STAGE_SPANS = tuple(STAGE_PARENTS)

#: names a ledger may mention at all: the stable set, the stages, plus any
#: canonical phase (sweep/replay/sort appear in calibration or recovery
#: ledgers)
ALLOWED_SPAN_NAMES = frozenset(STABLE_SPANS) | frozenset(STAGE_SPANS) | frozenset(PHASES)


def _check_span(name: str, value) -> tuple[float, float]:
    if name not in ALLOWED_SPAN_NAMES:
        raise TelemetryLeakError(
            f"round tracer: span name {name!r} is not a round phase "
            f"(allowed: {sorted(ALLOWED_SPAN_NAMES)}) — a span is a "
            "phase, never an operation; per-op span names are how the "
            "access-pattern side channel would reopen in a trace dump"
        )
    try:
        start, dur = value
        start = float(start)
        dur = float(dur)
    except (TypeError, ValueError):
        raise TelemetryLeakError(
            f"round tracer: span {name!r} must be a (start_s, duration_s)"
            " pair of numbers — there is no field for payload data by "
            "design"
        ) from None
    if not (math.isfinite(start) and math.isfinite(dur)) or dur < 0:
        raise TelemetryLeakError(
            f"round tracer: span {name!r} has non-finite or negative "
            f"bounds ({start!r}, {dur!r})"
        )
    return start, dur


class RoundTracer:
    """Fixed-size ring of schema-checked per-round span ledgers."""

    def __init__(
        self,
        capacity: int = 512,
        registry: TelemetryRegistry | None = None,
        bubble_window: int = 64,
    ):
        if capacity <= 0:
            raise ValueError("tracer ring capacity must be positive")
        self.capacity = capacity
        self.bubble_window = max(1, bubble_window)
        self._lock = threading.Lock()
        self._ring: list[dict] = [None] * capacity  # type: ignore[list-item]
        self._n = 0  # total rounds ever recorded
        self._g_bubble = self._c_rounds = self._g_retained = None
        if registry is not None:
            self._g_bubble = registry.gauge(
                "grapevine_round_bubble_ratio",
                "windowed mean fraction of round wall clock the host is "
                "blocked waiting on the device (evict wait / round "
                "span). Double-buffered-round speedup ceiling = "
                "1/max(b, 1-b): ~2x at b~0.5, ~1x at both extremes "
                "(~0 host-bound, ~1 device-bound)")
            self._c_rounds = registry.counter(
                "grapevine_trace_rounds_total",
                "rounds recorded into the trace ring")
            self._g_retained = registry.gauge(
                "grapevine_trace_ring_rounds",
                "round ledgers currently retained in the trace ring")

    # -- recording ------------------------------------------------------

    def record_round(self, spans: dict) -> None:
        """Append one round's ledger; raises TelemetryLeakError unless
        every span fits the phase-level schema. Missing STABLE_SPANS are
        normalized to zero duration so the trace shape is identical with
        and without durability (journal/checkpoint) and across impls."""
        if not isinstance(spans, dict):
            raise TelemetryLeakError(
                "round tracer: a ledger must be a {span: (start, dur)} dict")
        merged: dict[str, tuple[float, float]] = {}
        for name, value in spans.items():
            merged[name] = _check_span(name, value)
        # anchor for normalized zero-duration spans: the round span's
        # start, else the earliest recorded start, else 0
        anchor = merged.get("round", (None, 0.0))[0]
        if anchor is None:
            anchor = min((s for s, _ in merged.values()), default=0.0)
        for name in STABLE_SPANS:
            merged.setdefault(name, (anchor, 0.0))
        with self._lock:
            self._n += 1
            self._ring[(self._n - 1) % self.capacity] = {
                "seq": self._n,
                "spans": merged,
            }
            retained = min(self._n, self.capacity)
            bubble = self._bubble_locked()
        if self._c_rounds is not None:
            self._c_rounds.inc()
            self._g_retained.set(retained)
            self._g_bubble.set(bubble)

    # -- derived signals ------------------------------------------------

    @staticmethod
    def _entry_bubble(entry: dict) -> float | None:
        spans = entry["spans"]
        _, round_dur = spans.get("round", (0.0, 0.0))
        _, evict_dur = spans.get("evict", (0.0, 0.0))
        if round_dur <= 0.0:
            return None
        return max(0.0, min(1.0, evict_dur / round_dur))

    def _recent_locked(self, k: int) -> list[dict]:
        n = min(self._n, self.capacity)
        out = []
        for i in range(max(0, n - k), n):
            out.append(self._ring[(self._n - n + i) % self.capacity])
        return out

    def _bubble_locked(self) -> float:
        ratios = [
            r for r in (
                self._entry_bubble(e)
                for e in self._recent_locked(self.bubble_window)
            )
            if r is not None
        ]
        return sum(ratios) / len(ratios) if ratios else 0.0

    def bubble_ratio(self) -> float:
        """Windowed mean host-blocked fraction (the exported gauge)."""
        with self._lock:
            return self._bubble_locked()

    def span_durations_ms(self, name: str) -> list[float]:
        """Non-zero durations (ms) of one phase span across the
        retained ledgers, oldest first — the A/B tooling's accessor,
        shared so a journal-span methodology can never diverge between
        two tools. Phase-level by
        construction: the ring holds nothing finer."""
        if name not in ALLOWED_SPAN_NAMES:
            raise ValueError(
                f"{name!r} is not a round span "
                f"(allowed: {sorted(ALLOWED_SPAN_NAMES)})"
            )
        with self._lock:
            entries = self._recent_locked(self.capacity)
        return [
            e["spans"][name][1] * 1e3
            for e in entries
            if e["spans"].get(name, (0.0, 0.0))[1] > 0.0
        ]

    # -- export ---------------------------------------------------------

    #: rounds alternate across this many lanes per track: the pipelined
    #: scheduler holds at most two rounds in flight (round k settles
    #: before round k+2 dispatches), and complete ("X") events sharing a
    #: tid must nest or stay disjoint per the trace-event format —
    #: adjacent rounds overlap, alternate rounds cannot
    _LANES = 2

    def chrome_trace(self) -> dict:
        """The retained rounds as Chrome trace-event JSON (Perfetto-
        loadable): complete ("X") events in microseconds, host spans on
        tids 1-2 and the device window on tids 3-4 of one process
        (round seq picks the lane)."""
        with self._lock:
            entries = self._recent_locked(self.capacity)
            bubble = self._bubble_locked()
            total = self._n
        events: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": 1, "tid": 0,
             "args": {"name": "grapevine-engine"}},
        ]
        for lane in range(self._LANES):
            events.append(
                {"name": "thread_name", "ph": "M", "pid": 1,
                 "tid": 1 + lane,
                 "args": {"name": f"host round phases (lane {lane})"}})
            events.append(
                {"name": "thread_name", "ph": "M", "pid": 1,
                 "tid": 1 + self._LANES + lane,
                 "args": {"name": f"device window (lane {lane})"}})
        for entry in entries:
            seq = entry["seq"]
            lane = seq % self._LANES
            for name, (start, dur) in sorted(
                entry["spans"].items(), key=lambda kv: (kv[1][0], kv[0])
            ):
                events.append({
                    "name": f"grapevine/{name}",
                    "cat": "round",
                    "ph": "X",
                    "ts": int(start * 1e6),
                    "dur": max(0, int(dur * 1e6)),
                    "pid": 1,
                    "tid": (1 + self._LANES + lane) if name == "device"
                    else 1 + lane,
                    "args": {"seq": seq},
                })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {
                "rounds_recorded_total": total,
                "rounds_retained": len(entries),
                "bubble_ratio": round(bubble, 6),
            },
        }

    def chrome_trace_json(self) -> str:
        return json.dumps(self.chrome_trace())
