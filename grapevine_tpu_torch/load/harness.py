"""Open-loop scenario replay through the production scheduler (port of
``grapevine_tpu/load/harness.py``; it drives the port's
``server/scheduler.BatchScheduler``).

``ScenarioRunner`` replays a pre-materialized Schedule
(load/generators.py) against a ``BatchScheduler`` via its non-blocking
``submit_nowait`` path: ops join the queue at their scheduled times
regardless of how earlier ops are faring, completions land through
Future callbacks, and the per-op enqueue→settle latency is measured —
under overload the queue grows and the latencies stretch, which is
exactly the signal the capacity model (load/capacity.py) needs and
exactly what a closed-loop client would have hidden.

Honesty guard: a replay also records its own *dispatch skew* (how late
the dispatcher thread was against the schedule). A skewed replay is a
degraded measurement — the summary reports the skew so a capacity
number taken on an overloaded host discredits itself instead of
quietly under-offering.

``ProbeCampaignInjector`` is the red-team half of the /leakaudit
discrimination drill: against an HONEST engine no
client traffic shape can flip the leak audit — the transcript stays
uniform whatever arrives; that is the security claim itself, and the
honest scenarios pin it as the false-positive gate. So to prove the
tripwire *fires* under adversarial timing, the injector wraps the
monitor hand-off and rewrites the transcript COPY handed to the
detectors with the signature a remap/dedup bug would produce (each
probed key's mailbox slots pinned to one leaf, round after round).
Engine state and real responses are untouched; what is verified is
that leakmon + /leakaudit, wired exactly as production wires them,
flip to SUSPECT within rounds when a leak rides probe-shaped traffic.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from ..wire import constants as C
from ..wire.records import QueryRequest, RequestRecord
from .generators import CREATE, Schedule, partition_schedule

#: response statuses that mean "the engine handled the op as specified"
#: under load: drains of an empty inbox are NOT_FOUND, creates against
#: a pop-heavy mailbox may hit the reference's 62-message cap — both
#: are correct behavior, not harness failures
OK_STATUSES = frozenset({
    C.STATUS_CODE_SUCCESS,
    C.STATUS_CODE_NOT_FOUND,
    C.STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT,
})


def identity_pool(n: int) -> list[bytes]:
    """Deterministic nonzero 32-byte identities, index-stable across
    runs (slot i is always the same identity — what lets a schedule's
    pool indices mean the same principals everywhere)."""
    out = []
    for i in range(n):
        ident = bytes([1 + (i % 255)]) + i.to_bytes(8, "little")
        out.append(ident + b"\x5a" * (32 - len(ident)))
    return out


def calibrate_unloaded_round(engine, now: int, reps: int = 3) -> tuple:
    """Warm the engine and measure its unloaded full-batch round.

    Returns ``(t_round_s, est_ops_s, knee_target_ms)`` — the host
    scaling every load scenario rates itself against, and THE knee SLO
    target: ``max(250 ms, 8× the unloaded round)``. The capacity
    question is where latency departs from the intrinsic baseline, not
    whether a small host meets a production target it never could; the
    one formula lives here so every caller grades by the same method.
    Min-of-``reps`` after a warm call."""
    idents = identity_pool(8)
    batch = engine.ecfg.batch_size
    calib = [
        QueryRequest(
            request_type=CREATE, auth_identity=idents[i % 8],
            auth_signature=b"\x01" * C.SIGNATURE_SIZE,
            record=RequestRecord(
                msg_id=C.ZERO_MSG_ID, recipient=idents[(i + 1) % 8],
                payload=bytes([i & 0xFF]) * C.PAYLOAD_SIZE))
        for i in range(batch)
    ]
    engine.handle_queries(calib, now)  # compile + warm
    ts = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        engine.handle_queries(calib, now)
        ts.append(time.perf_counter() - t0)
    t_round = min(ts)
    return t_round, batch / t_round, max(250.0, 8.0 * t_round * 1e3)


def materialize_request(idents: list, schedule: Schedule, i: int,
                        payload: bytes) -> QueryRequest:
    """Op template → signed-shape wire request: CREATEs aim at the
    recipient's pool identity; zero-id READ/DELETE drains pop the
    submitter's own inbox. Module-level so the single-process runner
    and the per-shard fleet replay materialize identically from ONE
    identity pool (a shard's sub-schedule indexes the same principals
    the monolithic schedule declared)."""
    kind = int(schedule.kind[i])
    auth = idents[int(schedule.auth[i]) % len(idents)]
    if kind == CREATE:
        rcp = idents[int(schedule.recipient[i]) % len(idents)]
        rec = RequestRecord(
            msg_id=C.ZERO_MSG_ID, recipient=rcp, payload=payload
        )
    else:  # zero-id READ/DELETE: pop the submitter's own inbox
        rec = RequestRecord(
            msg_id=C.ZERO_MSG_ID, recipient=C.ZERO_PUBKEY,
            payload=payload,
        )
    return QueryRequest(
        request_type=kind, auth_identity=auth,
        auth_signature=b"\x01" * C.SIGNATURE_SIZE, record=rec,
    )


class RunResult:
    """Per-op outcome arrays plus the scenario summary."""

    def __init__(self, schedule: Schedule, time_scale: float):
        self.schedule = schedule
        self.time_scale = time_scale
        n = schedule.n_ops
        #: enqueue→settle seconds (WALL clock, unscaled); NaN = never
        #: settled / failed before dispatch
        self.latency_s = np.full(n, np.nan)
        #: dispatcher lateness vs the scaled schedule (wall seconds)
        self.skew_s = np.full(n, np.nan)
        self.status = np.zeros(n, np.int32)
        self.ok = np.zeros(n, bool)
        self.failed = np.zeros(n, bool)
        self.t_first_submit = None
        self.t_last_settle = None

    def summary(self) -> dict:
        """Batch-level scenario statistics (the bench/capture line)."""
        lat = self.latency_s[~np.isnan(self.latency_s)]
        skew = self.skew_s[~np.isnan(self.skew_s)]
        wall = (
            (self.t_last_settle - self.t_first_submit)
            if self.t_first_submit is not None
            and self.t_last_settle is not None else 0.0
        )
        n_ok = int(self.ok.sum())
        out = {
            "n_ops": self.schedule.n_ops,
            "n_ok": n_ok,
            "n_failed": int(self.failed.sum()),
            # offered rate in WALL terms (schedule rate / time_scale):
            # what the scheduler actually saw per second
            "offered_rate": round(
                self.schedule.offered_rate / self.time_scale, 1
            ) if self.time_scale else 0.0,
            "achieved_ops_per_sec": round(n_ok / wall, 1) if wall else 0.0,
        }
        if len(lat):
            out["p50_commit_ms"] = round(
                float(np.percentile(lat, 50, method="higher")) * 1e3, 2)
            out["p99_commit_ms"] = round(
                float(np.percentile(lat, 99, method="higher")) * 1e3, 2)
        if len(skew):
            out["dispatch_skew_p99_ms"] = round(
                float(np.percentile(skew, 99, method="higher")) * 1e3, 2)
        return out


class ScenarioRunner:
    """Replay schedules through a scheduler-like object.

    ``scheduler`` needs only ``submit_nowait(req) -> Future`` — the
    production BatchScheduler, or a test double. One runner holds one
    identity pool; run scenarios sequentially, never concurrently."""

    def __init__(
        self,
        scheduler,
        n_idents: int = 64,
        time_scale: float = 1.0,
        payload: bytes | None = None,
        settle_timeout_s: float = 120.0,
        clock=time.perf_counter,
    ):
        if time_scale <= 0:
            raise ValueError("time_scale must be positive")
        self.scheduler = scheduler
        self.idents = identity_pool(n_idents)
        self.time_scale = float(time_scale)
        self.payload = payload or b"\x00" * C.PAYLOAD_SIZE
        self.settle_timeout_s = float(settle_timeout_s)
        self._clock = clock

    def _materialize(self, schedule: Schedule, i: int) -> QueryRequest:
        return materialize_request(self.idents, schedule, i, self.payload)

    def run(self, schedule: Schedule) -> RunResult:
        """Replay one schedule open-loop; blocks until every dispatched
        op settles (or ``settle_timeout_s`` expires — remaining ops are
        counted as failed, never silently dropped)."""
        res = RunResult(schedule, self.time_scale)
        lock = threading.Lock()
        pending: list = []

        def on_done(i, t_sub, fut):
            t_done = self._clock()
            with lock:
                res.t_last_settle = (
                    t_done if res.t_last_settle is None
                    else max(res.t_last_settle, t_done)
                )
                exc = fut.exception()
                if exc is not None:
                    # no latency recorded: an errored future is not a
                    # commit (a scheduler crash settles queued futures
                    # near-instantly — recording those as ~0 ms commits
                    # would dilute p99 and hide breaches); NaN latency
                    # counts as a breach in the step grading
                    res.failed[i] = True
                    return
                res.latency_s[i] = t_done - t_sub
                resp = fut.result()
                res.status[i] = int(resp.status_code)
                res.ok[i] = int(resp.status_code) in OK_STATUSES
                res.failed[i] = not res.ok[i]

        t0 = self._clock()
        for i in range(schedule.n_ops):
            target = t0 + float(schedule.t_s[i]) * self.time_scale
            while True:
                now = self._clock()
                if now >= target:
                    break
                time.sleep(min(target - now, 0.002))
            req = self._materialize(schedule, i)
            t_sub = self._clock()
            res.skew_s[i] = max(0.0, t_sub - target)
            if res.t_first_submit is None:
                res.t_first_submit = t_sub
            try:
                fut = self.scheduler.submit_nowait(req)
            except Exception:
                res.failed[i] = True
                continue
            fut.add_done_callback(
                lambda f, i=i, t=t_sub: on_done(i, t, f)
            )
            pending.append((i, fut))
        deadline = self._clock() + self.settle_timeout_s
        for i, fut in pending:
            remaining = max(0.0, deadline - self._clock())
            if not self._wait(fut, remaining):
                # unsettled past the timeout: explicit failure, never a
                # silent drop (latency stays NaN — excluded from stats)
                with lock:
                    if np.isnan(res.latency_s[i]):
                        res.failed[i] = True
        return res

    @staticmethod
    def _wait(fut, timeout: float) -> bool:
        try:
            fut.exception(timeout=timeout)
            return True
        except Exception:
            return False  # TimeoutError or cancellation


class ProbeCampaignInjector:
    """Leak-signature injector for the /leakaudit discrimination drill.

    Wraps an ``EngineLeakMonitor`` behind the same ``submit_round``
    interface the engine hands transcripts to (engine.attach_leakmon
    accepts it transparently) and rewrites each round's transcript
    *copy* before delegating: every real op's mailbox fetch slots are
    pinned to one remembered leaf per (key, choice column) — the
    steady-state signature of a broken remap/dedup path. Same-key
    collision AND cross-round repeat statistics are driven toward 1 on
    the ``mb`` stream, so the monitor must flip SUSPECT within its
    min-evidence budget; the engine's actual state, responses, and
    device transcript are untouched.

    Flat position maps only (the transcript layout it rewrites); a
    recursive-posmap transcript passes through unmodified.
    """

    def __init__(self, monitor, ecfg):
        self.monitor = monitor
        self._d = int(ecfg.mb_choices)
        self._mb_leaves = int(ecfg.mb.leaves)
        self._pinned: dict = {}

    # engine-facing surface (PendingRound.resolve duck-types these)
    @property
    def recorder(self):
        return self.monitor.recorder

    def verdict(self):
        return self.monitor.verdict()

    def last_verdict(self):
        return self.monitor.last_verdict()

    def flush(self, timeout: float = 30.0):
        return self.monitor.flush(timeout)

    def close(self, timeout: float = 5.0):
        return self.monitor.close(timeout)

    def submit_round(self, batch, transcript, n_real, batch_size,
                     phases=None, queue_depth=None):
        from ..engine.round_step import transcript_key_groups

        tr = np.array(np.asarray(transcript))  # device→host, own copy
        d = self._d
        if tr.ndim != 2 or tr.shape[1] != 2 * d + 1:
            # recursive-posmap (widened) or unexpected layout: deliver
            # untouched rather than corrupt a transcript we don't parse
            return self.monitor.submit_round(
                batch, transcript, n_real, batch_size, phases, queue_depth)
        (mb_keys, mb_stable), _ = transcript_key_groups(
            {k: np.asarray(v) for k, v in batch.items()
             if k in ("req_type", "auth", "msg_id", "recipient")}, d)
        for slot in np.nonzero(mb_keys >= 0)[0]:
            j, c = divmod(int(slot), d)
            stable = mb_stable[slot]
            leaf = self._pinned.setdefault(
                stable,
                int.from_bytes(stable[:4], "little") % self._mb_leaves,
            )
            tr[j, c] = leaf           # mailbox round A column
            tr[j, d + 1 + c] = leaf   # mailbox round C column
        return self.monitor.submit_round(
            batch, tr, n_real, batch_size, phases, queue_depth)


# ----------------------------------------------------------------------
# per-shard fleet replay
# ----------------------------------------------------------------------


class ShardedScenarioRunner:
    """Replay ONE schedule across N shard schedulers, partitioned by
    recipient space (generators.partition_schedule) — the fleet-shaped
    replay the aggregator (obs/fleet.py) observes.

    Each shard's sub-schedule runs open-loop on its own thread against
    its own scheduler, all from one shared identity pool and one shared
    clock origin, so the fleet is offered exactly the traffic the
    monolithic replay would offer — just partitioned the way a
    recipient-sharded deployment declares. Returns per-shard
    ``RunResult``s in shard order; capacity grading folds them with
    ``load.capacity.fleet_capacity``."""

    def __init__(self, schedulers: list, n_idents: int = 64,
                 time_scale: float = 1.0, payload: bytes | None = None,
                 settle_timeout_s: float = 120.0, clock=time.perf_counter):
        if not schedulers:
            raise ValueError("need at least one shard scheduler")
        self.runners = [
            ScenarioRunner(
                s, n_idents=n_idents, time_scale=time_scale,
                payload=payload, settle_timeout_s=settle_timeout_s,
                clock=clock,
            )
            for s in schedulers
        ]

    @property
    def n_shards(self) -> int:
        return len(self.runners)

    def run(self, schedule: Schedule) -> list:
        parts = partition_schedule(schedule, self.n_shards)
        results: list = [None] * self.n_shards
        errors: list = []

        def _one(i):
            try:
                results[i] = self.runners[i].run(parts[i])
            except Exception as exc:  # surfaced after join, not lost
                errors.append((i, exc))

        threads = [
            threading.Thread(target=_one, args=(i,),
                             name=f"grapevine-shard-replay-{i}")
            for i in range(self.n_shards)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            i, exc = errors[0]
            raise RuntimeError(f"shard {i} replay failed") from exc
        return results


class ShardRoundDriver:
    """The cross-shard discrimination drill: N shard round loops on a
    shared tick clock feeding a ``FleetUniformityMonitor``.

    ``policy="uniform"`` is the production contract: every shard
    dispatches exactly one round per tick whether or not its queue
    holds real ops (cadence a pure function of the clock — padded
    rounds are the price of obliviousness). ``policy="skewed"`` is the
    seeded mutant: a shard dispatches a round ONLY
    when its own queue is hot (depth >= ``hot_threshold``), i.e. the
    scheduler leaks per-shard offered load into per-shard cadence —
    exactly what a traffic observer at fleet grain could read
    recipient activity from. The fleet verdict must flip SUSPECT on
    the mutant within a bounded number of ticks while the uniform
    policy stays PASS under any arrival shape.

    ``round_fn(shard, n_real)`` optionally runs a REAL engine round
    per dispatch (the slow soaks drive live engines); default is pure
    queue accounting, which is all the monitor ever sees either way —
    it consumes only the public per-shard series.
    """

    POLICIES = ("uniform", "skewed")

    def __init__(self, n_shards: int, monitor, policy: str = "uniform",
                 batch_size: int = 8, hot_threshold: int = 4,
                 flush_every: int = 4, round_fn=None):
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}")
        if n_shards < 2:
            raise ValueError("the drill needs >= 2 shards")
        self.n = int(n_shards)
        self.monitor = monitor
        self.policy = policy
        self.batch_size = int(batch_size)
        self.hot_threshold = int(hot_threshold)
        self.flush_every = max(1, int(flush_every))
        self.round_fn = round_fn
        self.queue = [0] * self.n
        self.rounds = [0] * self.n
        self.fill_sum = [0.0] * self.n
        self.flushes = [0] * self.n
        self.ticks = 0

    def tick(self, arrivals) -> None:
        """One shared tick: enqueue per-shard arrivals, apply the
        dispatch policy, hand the monitor the cumulative public
        series."""
        if len(arrivals) != self.n:
            raise ValueError("arrivals must have one entry per shard")
        for i, a in enumerate(arrivals):
            self.queue[i] += int(a)
        for i in range(self.n):
            if self.policy == "skewed" and \
                    self.queue[i] < self.hot_threshold:
                continue  # the leak: cadence follows the shard's load
            n_real = min(self.queue[i], self.batch_size)
            self.queue[i] -= n_real
            if self.round_fn is not None:
                self.round_fn(i, n_real)
            self.rounds[i] += 1
            self.fill_sum[i] += n_real / self.batch_size
            if self.rounds[i] % self.flush_every == 0:
                self.flushes[i] += 1
        self.ticks += 1
        self.monitor.observe_tick([
            {
                "rounds_total": float(self.rounds[i]),
                "fill_sum": self.fill_sum[i],
                "fill_count": float(self.rounds[i]),
                "flushes_total": float(self.flushes[i]),
                "queue_depth": float(self.queue[i]),
            }
            for i in range(self.n)
        ])

    def run(self, arrival_fn, n_ticks: int, stop_on=None) -> dict:
        """Drive ``n_ticks`` ticks with ``arrival_fn(tick) ->
        per-shard arrivals``; returns the final monitor verdict.
        ``stop_on`` (e.g. ``"SUSPECT"``) ends the drill early at the
        first matching verdict — the bounded-detection measurement."""
        verdict = self.monitor.verdict()
        for k in range(n_ticks):
            self.tick(arrival_fn(k))
            verdict = self.monitor.verdict()
            if stop_on is not None and verdict["verdict"] == stop_on:
                break
        return {**verdict, "ticks": self.ticks}
