"""Deterministic, seeded, open-loop arrival-schedule generators (port of
``grapevine_tpu/load/generators.py``; numpy only).

Every generator here is a pure function of its parameters and a seed:
it pre-materializes the COMPLETE (timestamp, op-template) schedule
before a single op is submitted. That open-loop property is the whole
point (and a test asserts it): a closed-loop client waits for
its previous op before sending the next, so under overload it silently
self-throttles and the measured latency stays flattering — the classic
coordinated-omission trap. An open-loop schedule keeps arriving at its
declared rate no matter how the server fares, so queue growth and
latency blow-up are *measured* rather than hidden, which is what makes
the ramp stage's saturation knee (load/capacity.py) an honest capacity
number (BOLT, arXiv:2509.01742, sweeps offered load the same way).

Op templates are small integers — a request kind (the wire request
types) plus indices into ONE identity pool shared by auth and
recipient roles, so a CREATE aimed at pool slot r can later be drained
by the identity at pool slot r. Materialization into signed wire
requests happens in the harness; schedules stay cheap to generate,
hash, and compare.

Time is in *schedule seconds* from t=0; the replay harness scales it
(``time_scale``) so one schedule serves both a compressed soak and
a real-time drill.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ..wire import constants as C

#: op-kind codes — exactly the wire request types, so a schedule reads
#: like the traffic it produces
CREATE = C.REQUEST_TYPE_CREATE
READ = C.REQUEST_TYPE_READ
DELETE = C.REQUEST_TYPE_DELETE


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A pre-materialized open-loop arrival schedule.

    Parallel arrays over ops, sorted by arrival time:

    - ``t_s``       float64 — arrival offset in schedule seconds
    - ``kind``      uint8   — CREATE / READ / DELETE (wire codes)
    - ``auth``      uint32  — identity-pool index of the submitter
    - ``recipient`` uint32  — identity-pool index of the CREATE target
                              (ignored for zero-id READ/DELETE drains)

    ``meta`` carries the generator's *declared* envelope (process kind,
    rates, periods) — what the shape tests check the empirical arrivals
    against — and never anything per-op.
    """

    scenario: str
    seed: int
    duration_s: float
    t_s: np.ndarray
    kind: np.ndarray
    auth: np.ndarray
    recipient: np.ndarray
    meta: dict

    def __post_init__(self):
        n = len(self.t_s)
        if not (len(self.kind) == len(self.auth) == len(self.recipient) == n):
            raise ValueError("schedule arrays must align")
        if n and (np.any(np.diff(self.t_s) < 0) or self.t_s[0] < 0
                  or self.t_s[-1] > self.duration_s):
            raise ValueError("arrival times must be sorted within "
                             "[0, duration_s]")

    @property
    def n_ops(self) -> int:
        return int(len(self.t_s))

    @property
    def offered_rate(self) -> float:
        """Mean offered rate over the schedule (ops per schedule second)."""
        return self.n_ops / self.duration_s if self.duration_s else 0.0

    def empirical_rate(self, n_bins: int = 16) -> np.ndarray:
        """Per-bin arrival rate (ops/s) over ``n_bins`` equal time bins
        — the shape tests' view of the envelope."""
        edges = np.linspace(0.0, self.duration_s, n_bins + 1)
        counts, _ = np.histogram(self.t_s, bins=edges)
        return counts / (self.duration_s / n_bins)

    def fingerprint(self) -> str:
        """Content hash of the full schedule — determinism and
        open-loop tests compare these (a replay must never mutate or
        regenerate its schedule)."""
        h = hashlib.sha256()
        for arr in (self.t_s, self.kind, self.auth, self.recipient):
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.hexdigest()


# ----------------------------------------------------------------------
# arrival-process primitives
# ----------------------------------------------------------------------


def _poisson_arrivals(rng, rate: float, t0: float, t1: float) -> np.ndarray:
    """Homogeneous Poisson arrivals on [t0, t1): draw the count, then
    order statistics of uniforms (equivalent to exponential gaps, one
    vectorized draw)."""
    dt = t1 - t0
    if rate <= 0 or dt <= 0:
        return np.empty(0, np.float64)
    n = rng.poisson(rate * dt)
    return np.sort(rng.uniform(t0, t1, n))


def _mixed_ops(rng, n: int, n_idents: int, create_frac: float = 0.55,
               read_frac: float = 0.30) -> tuple:
    """Default CRUD mix over a uniform identity pool: CREATEs to random
    recipients, zero-id READ/DELETE drains of the submitter's inbox."""
    r = rng.random(n)
    kind = np.where(
        r < create_frac, CREATE,
        np.where(r < create_frac + read_frac, READ, DELETE),
    ).astype(np.uint8)
    auth = rng.integers(0, n_idents, n).astype(np.uint32)
    recipient = rng.integers(0, n_idents, n).astype(np.uint32)
    return kind, auth, recipient


def _finish(scenario, seed, duration_s, t, kind, auth, recipient, meta):
    order = np.argsort(t, kind="stable")
    return Schedule(
        scenario=scenario, seed=int(seed), duration_s=float(duration_s),
        t_s=np.asarray(t, np.float64)[order],
        kind=np.asarray(kind, np.uint8)[order],
        auth=np.asarray(auth, np.uint32)[order],
        recipient=np.asarray(recipient, np.uint32)[order],
        meta=meta,
    )


# ----------------------------------------------------------------------
# the scenario generators
# ----------------------------------------------------------------------


def steady_poisson(rate: float, duration_s: float, seed: int,
                   n_idents: int = 64) -> Schedule:
    """The baseline: memoryless arrivals at a constant rate — the
    closed-loop drains' opposite, and the null shape the bursty/diurnal
    envelopes are contrasted against."""
    rng = np.random.default_rng(seed)
    t = _poisson_arrivals(rng, rate, 0.0, duration_s)
    kind, auth, recipient = _mixed_ops(rng, len(t), n_idents)
    return _finish(
        "steady", seed, duration_s, t, kind, auth, recipient,
        {"process": "poisson", "rate": float(rate), "n_idents": n_idents},
    )


def bursty_onoff(rate_on: float, duty: float, period_s: float,
                 duration_s: float, seed: int,
                 n_idents: int = 64) -> Schedule:
    """ON/OFF bursts: Poisson at ``rate_on`` during the first
    ``duty``-fraction of every period, silence otherwise. Mean rate is
    ``rate_on * duty``; the peak-to-mean ratio ``1/duty`` is what the
    fixed round cadence has never been measured against."""
    if not 0.0 < duty < 1.0:
        raise ValueError("duty must be in (0, 1)")
    rng = np.random.default_rng(seed)
    parts = []
    t0 = 0.0
    while t0 < duration_s:
        on_end = min(t0 + duty * period_s, duration_s)
        parts.append(_poisson_arrivals(rng, rate_on, t0, on_end))
        t0 += period_s
    t = np.concatenate(parts) if parts else np.empty(0, np.float64)
    kind, auth, recipient = _mixed_ops(rng, len(t), n_idents)
    return _finish(
        "bursty", seed, duration_s, t, kind, auth, recipient,
        {"process": "onoff", "rate_on": float(rate_on), "duty": float(duty),
         "period_s": float(period_s), "mean_rate": float(rate_on * duty),
         "n_idents": n_idents},
    )


def diurnal_sinusoid(mean_rate: float, rel_amplitude: float,
                     period_s: float, duration_s: float, seed: int,
                     n_idents: int = 64) -> Schedule:
    """Inhomogeneous Poisson with a sinusoidal rate —
    ``λ(t) = mean·(1 + a·sin(2πt/T))`` — generated by thinning a
    homogeneous stream at the peak rate (Lewis–Shedler): the compressed
    day/night cycle a real deployment breathes with."""
    if not 0.0 <= rel_amplitude < 1.0:
        raise ValueError("rel_amplitude must be in [0, 1)")
    rng = np.random.default_rng(seed)
    peak = mean_rate * (1.0 + rel_amplitude)
    cand = _poisson_arrivals(rng, peak, 0.0, duration_s)
    lam = mean_rate * (
        1.0 + rel_amplitude * np.sin(2.0 * np.pi * cand / period_s)
    )
    keep = rng.uniform(0.0, peak, len(cand)) < lam
    t = cand[keep]
    kind, auth, recipient = _mixed_ops(rng, len(t), n_idents)
    return _finish(
        "diurnal", seed, duration_s, t, kind, auth, recipient,
        {"process": "sinusoid", "mean_rate": float(mean_rate),
         "rel_amplitude": float(rel_amplitude), "period_s": float(period_s),
         "n_idents": n_idents},
    )


def pop_heavy_drain(rate: float, duration_s: float, seed: int,
                    n_idents: int = 64, n_hot: int = 4,
                    hot_frac: float = 0.75,
                    drain_frac: float = 0.4) -> Schedule:
    """Pop-heavy mailbox drains: ``hot_frac`` of CREATEs target the
    ``n_hot`` hottest identities (a celebrity inbox), and the drain ops
    are zero-id READ/DELETEs *by* those same hot identities emptying
    their own mailboxes — the 62-cap-stressing mix from the zipf bench
    configs, now with realistic open-loop timing."""
    if not 1 <= n_hot < n_idents:
        raise ValueError("need 1 <= n_hot < n_idents")
    rng = np.random.default_rng(seed)
    t = _poisson_arrivals(rng, rate, 0.0, duration_s)
    n = len(t)
    is_drain = rng.random(n) < drain_frac
    hot = rng.integers(0, n_hot, n).astype(np.uint32)
    cold = rng.integers(n_hot, n_idents, n).astype(np.uint32)
    # drains: the hot identity pops its own inbox (READ then DELETE in
    # equal measure so the mailbox actually empties)
    drain_kind = np.where(rng.random(n) < 0.5, READ, DELETE).astype(np.uint8)
    kind = np.where(is_drain, drain_kind, np.uint8(CREATE))
    auth = np.where(is_drain, hot, cold)
    recipient = np.where(
        ~is_drain & (rng.random(n) < hot_frac), hot, cold
    ).astype(np.uint32)
    return _finish(
        "pop_heavy", seed, duration_s, t, kind, auth, recipient,
        {"process": "pop_heavy", "rate": float(rate), "n_hot": n_hot,
         "hot_frac": float(hot_frac), "drain_frac": float(drain_frac),
         "n_idents": n_idents},
    )


def adversarial_probe(pulse_period_s: float, duration_s: float, seed: int,
                      n_probe_keys: int = 4,
                      probes_per_pulse: int = 2) -> Schedule:
    """The probe campaign aimed at the leakmon detectors
    (obs/leakmon.py): a tiny set of identities fires synchronized
    pulses of zero-id READs against their own mailboxes,
    ``probes_per_pulse`` copies per key per pulse with sub-ms jitter so
    same-key ops land in the SAME round.

    The shape maximizes every detector's evidence per round — same-key
    pairs (copies of one key in one batch), cross-round repeat
    opportunities (every key re-accessed every pulse), and a pooled
    leaf histogram fed from very few keys — under maximally non-uniform
    timing. Against an honest engine every statistic stays at its
    uniform baseline (that IS the obliviousness claim, and the
    discrimination test pins it as the false-positive gate); paired
    with the harness's ``ProbeCampaignInjector`` it is the red-team
    drill that proves /leakaudit flips when a leak signature rides
    exactly this traffic."""
    rng = np.random.default_rng(seed)
    pulses = np.arange(0.0, duration_s, pulse_period_s)
    n = len(pulses) * n_probe_keys * probes_per_pulse
    t = np.repeat(pulses, n_probe_keys * probes_per_pulse)
    # sub-ms jitter keeps a pulse inside one collection window while
    # making the schedule an honest point process, not an exact comb
    t = np.minimum(t + rng.uniform(0.0, 1e-3, n), duration_s)
    auth = np.tile(
        np.repeat(np.arange(n_probe_keys, dtype=np.uint32),
                  probes_per_pulse),
        len(pulses),
    )
    kind = np.full(n, READ, np.uint8)
    recipient = np.zeros(n, np.uint32)
    return _finish(
        "adversarial", seed, duration_s, t, kind, auth, recipient,
        {"process": "probe_pulses", "pulse_period_s": float(pulse_period_s),
         "n_probe_keys": n_probe_keys, "probes_per_pulse": probes_per_pulse,
         "n_idents": n_probe_keys},
    )


def partition_schedule(schedule: Schedule, n_shards: int) -> list:
    """Split one schedule into N per-shard schedules by recipient space
    — the declared partition a recipient-sharded fleet would serve
    (each shard owns ``recipient % n_shards == i``).

    CREATEs route by their recipient; zero-id READ/DELETE drains route
    by the submitter (``auth``), since a drain empties the submitter's
    own inbox, which lives on the submitter's home shard. The split is
    a pure function of (schedule, n_shards): replaying shard i's
    sub-schedule is deterministic, and the union of the parts is the
    whole (asserted) — so a fleet replay offers exactly the same
    traffic as the monolithic replay, just partitioned.

    Each part's ``meta`` carries ``shard``/``n_shards``/``partition``
    plus the parent envelope — the fleet uniformity monitor's
    *declared* load split, against which fill-correlation beyond the
    declared partition is the leak (obs/leakmon.py
    FleetUniformityMonitor)."""
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    route = np.where(
        schedule.kind == CREATE,
        schedule.recipient % n_shards,
        schedule.auth % n_shards,
    )
    parts = []
    for i in range(n_shards):
        sel = route == i
        parts.append(Schedule(
            scenario=f"{schedule.scenario}[shard{i}/{n_shards}]",
            seed=schedule.seed,
            duration_s=schedule.duration_s,
            t_s=schedule.t_s[sel],
            kind=schedule.kind[sel],
            auth=schedule.auth[sel],
            recipient=schedule.recipient[sel],
            meta={**schedule.meta, "shard": i, "n_shards": n_shards,
                  "partition": "recipient_mod"},
        ))
    assert sum(p.n_ops for p in parts) == schedule.n_ops
    return parts


def ramp_to_saturation(rate0: float, factor: float, n_steps: int,
                       step_s: float, seed: int,
                       n_idents: int = 64) -> Schedule:
    """The capacity stage: a staircase of Poisson segments at
    geometrically increasing offered rates (``rate0 · factor^i``).
    ``meta["steps"]`` declares each step's [t0, t1) and offered rate —
    load/capacity.py groups the replay's per-op latencies by these
    declared steps and finds the saturation knee over the SLO
    burn-rate signal."""
    if factor <= 1.0 or n_steps < 2:
        raise ValueError("need factor > 1 and at least 2 steps")
    rng = np.random.default_rng(seed)
    parts, steps = [], []
    for i in range(n_steps):
        r = rate0 * factor ** i
        t0, t1 = i * step_s, (i + 1) * step_s
        parts.append(_poisson_arrivals(rng, r, t0, t1))
        steps.append({"t0": t0, "t1": t1, "offered_rate": float(r)})
    t = np.concatenate(parts)
    kind, auth, recipient = _mixed_ops(rng, len(t), n_idents)
    return _finish(
        "ramp", seed, n_steps * step_s, t, kind, auth, recipient,
        {"process": "ramp", "rate0": float(rate0), "factor": float(factor),
         "n_steps": n_steps, "step_s": float(step_s), "steps": steps,
         "n_idents": n_idents},
    )
