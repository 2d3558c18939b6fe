"""Cost observatory: the static round-cost ledger on /metrics, plus the
runtime roofline residual (port of ``grapevine_tpu/obs/costmon.py``).

Two halves, both riding :mod:`..analysis.costmodel`:

- **startup info gauges** (``grapevine_cost_*``): the modeled per-phase
  device-memory bytes / gather-scatter rows / cipher rows / sort
  key-volume and the flush-amortized steady-state round total, set once
  at attach time. Pure functions of public geometry × knobs — the same
  numbers any observer could derive from the config — so they are
  trivially leak-free (``phase`` is the only label key, and its values
  are the fixed phase names, never geometry).
- **roofline residual** (runtime): each resolved round pairs its
  device span (timed by CUDA events on the card, the tracer's
  host-observed ``device`` span elsewhere) against the modeled floor
  (steady-state bytes ÷ achieved bandwidth). The exported ratio
  ``measured / floor`` reads as "how far off the bandwidth roofline this
  round ran": residual DRIFT is the alert signal — a regressed knob, a
  silently grown geometry, or a mispredicting model all show up here at
  round cadence.

Bandwidth constant: an explicit override, else ``GRAPEVINE_COST_GBPS``
(the operator's calibrated value), else a per-device default keyed by the
engine's device type. A default shifts the residual's LEVEL, not its
drift: triage on change, not magnitude.
"""

from __future__ import annotations

import os

from ..analysis.costmodel import COST_PHASES, engine_cost_ledger

#: achieved-bandwidth defaults (GB/s) per torch device type. ``cpu``
#: keeps the reference's placeholder. ``cuda`` is the achieved bandwidth
#: of a device-to-device copy of 2 GiB (read once, written once), best
#: of 5 by CUDA events, on an NVIDIA H100 80GB HBM3 at a 700.00 W power
#: limit: 3,024.7 GB/s (chip_smoke.py phase 13a's ``cost_calibrate``),
#: rounded down.
DEFAULT_GBPS = {"cpu": 8.0, "cuda": 3000.0}


def resolve_bandwidth_gbps(override: float | None = None,
                           device_type: str = "cpu") -> float:
    """Bandwidth resolution order: explicit override →
    ``GRAPEVINE_COST_GBPS`` → the default for ``device_type`` (the
    engine's ``device.type``; an unknown type takes the CPU's)."""
    if override is not None:
        return float(override)
    env = os.environ.get("GRAPEVINE_COST_GBPS")
    if env:
        return float(env)
    return DEFAULT_GBPS.get(device_type, DEFAULT_GBPS["cpu"])


class CostMonitor:
    """Exports the modeled cost ledger for one engine geometry and
    scores every resolved round against the roofline floor.

    Attached by :func:`..obs.attach_round_observability`; the engine
    hands each round's span ledger to :meth:`observe_round` off the
    dispatch path (engine/batcher.py ``PendingRound.resolve``, next to
    the tracer's ring append — a few float ops per ROUND)."""

    def __init__(self, ecfg, registry, *,
                 bandwidth_gbps: float | None = None,
                 device_type: str = "cpu"):
        self.ledger = engine_cost_ledger(ecfg)
        self.bandwidth_gbps = resolve_bandwidth_gbps(bandwidth_gbps,
                                                     device_type)
        self.floor_ms = self.ledger.floor_ms(self.bandwidth_gbps)

        phase_labels = {"phase": COST_PHASES}
        g_bytes = registry.gauge(
            "grapevine_cost_phase_hbm_bytes",
            "Modeled HBM bytes one execution of this phase moves "
            "(static geometry x knobs; flush/sweep are per flush/sweep "
            "call, not per round)",
            labels=phase_labels,
        )
        g_grows = registry.gauge(
            "grapevine_cost_phase_gather_rows",
            "Modeled HBM gather rows per execution of this phase",
            labels=phase_labels,
        )
        g_srows = registry.gauge(
            "grapevine_cost_phase_scatter_rows",
            "Modeled HBM scatter rows per execution of this phase",
            labels=phase_labels,
        )
        g_cipher = registry.gauge(
            "grapevine_cost_phase_cipher_rows",
            "Modeled bucket-cipher keystream rows per execution of "
            "this phase",
            labels=phase_labels,
        )
        g_sort = registry.gauge(
            "grapevine_cost_phase_sort_keys",
            "Modeled sort key-volume per execution of this phase",
            labels=phase_labels,
        )
        for phase in COST_PHASES:
            c = self.ledger.phases[phase]
            g_bytes.set(float(c.hbm_bytes), phase=phase)
            g_grows.set(float(c.gather_rows), phase=phase)
            g_srows.set(float(c.scatter_rows), phase=phase)
            g_cipher.set(float(c.cipher_rows), phase=phase)
            g_sort.set(float(c.sort_keys), phase=phase)

        registry.gauge(
            "grapevine_cost_steady_round_hbm_bytes",
            "Modeled flush-amortized HBM bytes per steady-state engine "
            "round (fetch + write-back + flush/evict_every; sweep "
            "excluded — operator-cadenced)",
        ).set(float(self.ledger.steady_round_bytes))
        registry.gauge(
            "grapevine_cost_bandwidth_gbps",
            "Achieved-bandwidth constant in use for the roofline floor "
            "(GRAPEVINE_COST_GBPS / cost_calibrate fit, else a "
            "per-backend placeholder)",
        ).set(self.bandwidth_gbps)
        registry.gauge(
            "grapevine_cost_roofline_floor_ms",
            "Modeled round-time floor: steady-state bytes / calibrated "
            "bandwidth",
        ).set(self.floor_ms)
        self._g_residual = registry.gauge(
            "grapevine_cost_roofline_residual",
            "Last round's host-observed device span / modeled roofline "
            "floor (drift, not level, is the alert signal)",
        )
        self._g_residual_max = registry.gauge(
            "grapevine_cost_roofline_residual_max",
            "Worst roofline residual observed since attach",
        )

    def observe_round(self, spans: dict, device_span_s: float | None = None) -> None:
        """Score one resolved round's device span against the floor.

        ``device_span_s`` is the round's span by the card's own clock
        (``PendingRound.device_span_s``: from the stream reaching the
        round's upload to the end of its output copies). Without it (on
        the CPU) the score falls back to ``spans``' ``device`` span, the
        host-observed upper bound the tracer records, which at depth 2
        also holds the previous round's tail and the host's lateness."""
        if device_span_s is None:
            dev = spans.get("device")
            if dev is None:
                return
            device_span_s = dev[1]
        if self.floor_ms <= 0.0:
            return
        residual = (device_span_s * 1e3) / self.floor_ms
        self._g_residual.set(residual)
        self._g_residual_max.set_max(residual)
