"""Host-side batching and the engine facade (port of
``grapevine_tpu/engine/batcher.py``).

``pack_batch``/``unpack_responses`` convert between wire records and the
columnar batch arrays. :class:`GrapevineEngine` owns the device state and
serves rounds through the reference's staged pipeline: a round passes
through four stages — assemble (validate + pack, outside the lock),
journal (sealed append + fsync, under the engine lock), dispatch (the
round enqueued on the device, same lock hold), resolve (wait for the
round's own outputs + demux, outside the lock). ``handle_queries_async``
composes the first three and returns the :class:`PendingRound` whose
``resolve()`` is stage four; ``handle_queries`` keeps up to
``pipeline_depth`` rounds between dispatch and resolve, so with depth 2
round k+1's pack, journal fsync and kernel issue overlap round k on the
card. Journal order is dispatch order at every depth (both happen in one
lock hold), so a journal written at depth 2 replays on a depth-1 engine.

Dispatch makes no host synchronization on the card:

- the batch goes up through one pinned staging buffer and one
  asynchronous copy (a copy from pageable memory makes PyTorch
  synchronize the stream, which would wait for every round in flight);
- the round's outputs come down by asynchronous copies into pinned
  buffers, enqueued right behind the round and followed by a CUDA event;
  ``resolve`` waits on that event only, never on the device or the
  stream, so a later round already dispatched keeps running and
  ``resolve`` may run on another thread; that event and one recorded
  before the upload are timing events, so once the wait is over they
  give the round's device span (``PendingRound.device_span_s``) with no
  wait of their own;
- the admission branch (the reference's ``lax.cond`` on ``free_top`` and
  ``recipients``) is decided on the host from a bound (``_admission``)
  instead of a read of the state, whenever the bound decides it.

On the card the fast-branch round is replayed from one CUDA graph
(``engine/round_graph.py``), one launch where the eager round enqueues
some 3,500. Each round decides it from what the engine observes: a round
on a CUDA device, with no mesh, not op-major, whose admission took the
fast branch, replays; the first such round runs eagerly as the warm-up and
the second captures. Every other round runs ``engine_round_step`` (or the
op-major or sharded step) op by op, as does journal replay. The graph
reads and writes the state in place, so the state's tensors keep their
addresses once it exists: every write of ``state`` from outside the
graphed round goes through one setter, which copies it into them.

Under ``commit="op"`` the round program is the op-major
``engine/step.py:engine_step`` (the reference's choice, for dispatch and
journal replay alike); it has no admission branch to decide. At
``shards`` N > 1 the bucket trees shard over a mesh of N devices
(``parallel/mesh.py``) and the round, flush and replay go through the
sharded step and flush; nothing downstream (journal, checkpoint, leak
monitor, comparisons) can tell the difference.

The facade also runs the delayed-eviction flush every ``evict_every``
rounds (in the window-closing round's lock hold), the expiry sweep
(``expire``), and with a ``DurabilityConfig`` checkpoints on a cadence
and recovers on construction by replaying the journal through the same
programs (``engine/checkpoint.py``, ``engine/journal.py``). Telemetry is
``self.metrics`` (``engine/metrics.py``) on an obs registry; the
``attach_*`` hooks take the round tracer, SLO tracker, workload and cost
telemetry and the leak monitor, and ``PendingRound.resolve`` hands each
round to them. With a leak monitor attached, the round's transcript comes
down with its responses, by the same pinned asynchronous copies before
the same event: no host sync and no second event. The serving layers
call ``calibrate_sort_phase`` and ``calibrate_posmap_phase`` once at
start-up to fill the ``sort`` and ``posmap`` phase series.
"""

from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np
import torch

from ..config import DurabilityConfig, GrapevineConfig
from ..device import resolve_device
from ..obs.flightrec import ALLOWED_PHASE_KEYS
from ..parallel import (
    init_sharded_engine,
    make_mesh,
    make_sharded_flush,
    make_sharded_step,
    shard_engine_state,
)
from ..testing import faults
from ..u32 import SENTINEL, from_numpy, to_numpy
from ..wire import constants as C
from ..wire.records import QueryRequest, QueryResponse, Record
from ..wire.validate import validate_request
from .expiry import expiry_sweep
from .metrics import EngineMetrics
from .round_graph import EAGER_REASONS, RoundGraph, copy_state_
from .round_step import admission_fast_ok, engine_flush_step, engine_round_step
from .step import engine_step
from .state import (
    ID_WORDS,
    KEY_WORDS,
    PAYLOAD_WORDS,
    EngineConfig,
    EngineState,
    init_engine,
)


def pack_batch(reqs: list[QueryRequest], batch_size: int, now: int) -> dict:
    """Pack ≤batch_size validated requests into numpy u32 columns,
    dummy-padded (request type 0)."""
    n = len(reqs)
    if n > batch_size:
        raise ValueError("too many requests for one batch")
    b = batch_size

    def col(words: int, chunks) -> np.ndarray:
        arr = np.zeros((b, words), np.uint32)
        if n:
            arr[:n] = np.frombuffer(b"".join(chunks), "<u4").reshape(n, words)
        return arr

    rt = np.zeros((b,), np.uint32)
    rt[:n] = [r.request_type for r in reqs]
    return {
        "req_type": rt,
        "auth": col(KEY_WORDS, (r.auth_identity for r in reqs)),
        "msg_id": col(ID_WORDS, (r.record.msg_id for r in reqs)),
        "recipient": col(KEY_WORDS, (r.record.recipient for r in reqs)),
        "payload": col(PAYLOAD_WORDS, (r.record.payload for r in reqs)),
        "now": np.uint32(int(now) & 0xFFFFFFFF),
        "now_hi": np.uint32((int(now) >> 32) & 0xFFFFFFFF),
    }


def upload_batch(batch: dict, device, out: torch.Tensor | None = None
                 ) -> tuple[dict, torch.Tensor | None]:
    """numpy batch columns → int32 tensors on ``device``, and the host
    buffer the copy reads.

    On the card every column goes into one pinned staging buffer and up
    by one asynchronous copy; the columns are views of the one device
    buffer: ``out`` (int32, the batch's size) where given, so that every
    round's batch lands at the same addresses (the graphed round reads
    them), else a fresh one. The staging buffer is returned so the caller
    can keep it until the copy has run (the round's ``PendingRound`` holds
    it; PyTorch's pinned-memory cache also withholds a block from reuse
    until the copies that read it are done). On the CPU each column is a
    plain copy and the buffer is None."""
    dev = torch.device(device)
    arrs = {k: np.asarray(v, np.uint32) for k, v in batch.items()}
    if dev.type != "cuda":
        return {k: from_numpy(a, dev) for k, a in arrs.items()}, None
    staging = torch.empty(sum(a.size for a in arrs.values()), dtype=torch.int32,
                          pin_memory=True)
    flat = staging.numpy().view(np.uint32)
    spans, off = {}, 0
    for k, a in arrs.items():
        flat[off:off + a.size] = a.reshape(-1)
        spans[k] = (off, a.size, a.shape)
        off += a.size
    up = staging.to(dev, non_blocking=True) if out is None else out.copy_(staging,
                                                                          non_blocking=True)
    return {k: up[o:o + n].view(shape) for k, (o, n, shape) in spans.items()}, staging


def batch_to_device(batch: dict, device) -> dict:
    """numpy batch columns → int32 tensors on ``device``."""
    return upload_batch(batch, device)[0]


def unpack_responses(resp: dict, n: int) -> list[QueryResponse]:
    """Columnar response arrays (numpy u32 or tensors) → wire responses."""
    resp = {k: to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in resp.items()}
    status = resp["status"][:n].tolist()
    ts_lanes = resp["timestamp"][:n].astype(np.uint64)
    ts = (ts_lanes[:, 0] | (ts_lanes[:, 1] << np.uint64(32))).tolist()

    def rows(name: str, words: int) -> list[bytes]:
        flat = np.ascontiguousarray(resp[name][:n], dtype="<u4").tobytes()
        sz = words * 4
        return [flat[i * sz:(i + 1) * sz] for i in range(n)]

    mids = rows("msg_id", ID_WORDS)
    snds = rows("sender", KEY_WORDS)
    rcps = rows("recipient", KEY_WORDS)
    pls = rows("payload", PAYLOAD_WORDS)
    return [
        QueryResponse(
            record=Record(msg_id=mids[i], sender=snds[i], recipient=rcps[i],
                          timestamp=int(ts[i]), payload=pls[i]),
            status_code=int(status[i]),
        )
        for i in range(n)
    ]


def _timing_event(device) -> torch.cuda.Event | None:
    """A timing CUDA event recorded on the current stream now (None off
    the card): where the stream reaches it, by the device's own clock."""
    if torch.device(device).type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _stage_to_host(outs: dict):
    """Enqueue copies of a round's output tensors to the host behind the
    round; returns ``(host tensors, event or None)``. On the card each
    goes into a fresh pinned buffer by an asynchronous copy and a timing
    CUDA event is recorded after the last one: the host values are valid
    once the event has completed. On the CPU the outputs are the host
    values (fresh tensors each round, never updated in place afterwards)."""
    first = next(iter(outs.values()))
    if first.device.type != "cuda":
        return outs, None
    host = {}
    for k, v in outs.items():
        host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host[k].copy_(v, non_blocking=True)
    return host, _timing_event(first.device)


class PendingRound:
    """Handle to a dispatched-but-unresolved round; ``resolve()`` blocks
    until the round's own outputs are on the host."""

    __slots__ = ("_engine", "_host", "_done", "_start", "_device_span_s", "_staging",
                 "_tag", "_n", "_t0", "_spans", "_enq", "_qdepth", "_batch", "replayed")

    def __init__(self, engine, host, done, staging, tag, n, t0, spans=None,
                 batch=None, start=None, replayed=False):
        self._engine = engine
        #: whether the round ran as a replay of the engine's round graph
        #: (``engine/round_graph.py``), not op by op
        self.replayed = replayed
        #: the round's outputs on the host (pinned copies in flight on the
        #: card): responses, the state's free_top and recipients, and the
        #: transcript when asked for
        self._host = host
        #: leak-monitor hand-off (engine.leakmon set): the batch's key
        #: columns (numpy) the transcript's key groups derive from
        self._batch = batch
        #: timing CUDA events recorded before the batch's upload and after
        #: the output copies (None on the CPU)
        self._done = done
        self._start = start
        self._device_span_s = None
        #: the batch's pinned staging buffer, alive until the round is done
        self._staging = staging
        #: the round's dispatch number (the admission bound's clock)
        self._tag = tag
        self._n = n
        self._t0 = t0
        #: {phase: (start_s, dur_s)} on the perf_counter clock
        self._spans = spans
        #: perf_counter enqueue time of the round's oldest op (scheduler)
        self._enq = None
        #: scheduler backlog at dispatch (scheduler)
        self._qdepth = None

    def set_enqueued_at(self, t_enq: float) -> None:
        """Stamp the oldest op's enqueue time (perf_counter seconds);
        must be called before ``resolve()``."""
        self._enq = t_enq

    def set_queue_depth(self, depth: int) -> None:
        """Stamp the post-dispatch scheduler backlog (an aggregate of the
        queue, never of any op in it); before ``resolve()``."""
        self._qdepth = int(depth)

    def note_span(self, name: str, start_s: float, dur_s: float) -> None:
        """Add a collector-side span (assembly/verify) to this round's
        ledger; before ``resolve()``."""
        if self._spans is None:
            self._spans = {}
        self._spans[name] = (start_s, dur_s)

    @property
    def spans(self) -> dict:
        """The round's span ledger (complete after ``resolve()``)."""
        return dict(self._spans or {})

    @property
    def transcript(self):
        """The round's transcript (numpy u32) where its dispatch asked for
        it (a leak monitor attached, ``handle_queries_with_transcript``),
        else None; read after ``resolve()``."""
        t = self._host.get("transcript")
        return None if t is None else to_numpy(t)

    @property
    def device_span_s(self) -> float | None:
        """Seconds, by the card's own clock, from the stream reaching the
        round's upload to the end of its output copies; set once the
        round's outputs are waited for, None on the CPU. At depth 2 it
        less the round's kernel time is how long the card starved inside
        the round, waiting for launches."""
        return self._device_span_s

    def running(self) -> bool:
        """Whether the round's device work (through its output copies) is
        still running; never waits. False on the CPU."""
        return self._done is not None and not self._done.query()

    def _wait(self) -> dict:
        """Wait for this round's outputs only (its event, not the device
        or the stream), refresh the engine's admission bound from them,
        and return them as numpy u32 arrays."""
        if self._done is not None:
            self._done.synchronize()
            if self._start is not None:
                self._device_span_s = 1e-3 * self._start.elapsed_time(self._done)
        out = {k: to_numpy(v) for k, v in self._host.items()}
        self._engine._note_bound(self._tag, int(out.pop("free_top")),
                                 int(out.pop("recipients")))
        self._staging = None
        return out

    def resolve(self) -> list[QueryResponse]:
        m = self._engine.metrics
        # "evict" = the round's device work measured from the host: the
        # wait for its own event
        t_ev = time.perf_counter()
        with m.time_phase("evict"):
            host = self._wait()
        t_dm = time.perf_counter()
        with m.time_phase("demux"):
            out = unpack_responses(host, self._n)
        t_done = time.perf_counter()
        # dispatch → results delivered; under a pipelined caller this
        # includes the next round's dispatch (the commit latency a client
        # observes, not device time)
        m.record_round(self._n, self._engine.ecfg.batch_size, t_done - self._t0)
        spans = dict(self._spans or {})
        spans["evict"] = (t_ev, t_dm - t_ev)
        spans["demux"] = (t_dm, t_done - t_dm)
        # the host-observed device window (enqueue → readiness observed at
        # resolve): an upper bound on device-busy time
        spans["device"] = (self._t0, t_dm - self._t0)
        r0 = min(s for s, _ in spans.values())
        spans["round"] = (r0, t_done - r0)
        self._spans = spans
        eng = self._engine
        if eng.tracer is not None:
            eng.tracer.record_round(spans)
        if eng.slo is not None:
            # enqueue→settle commit latency, worst op in the batch: the
            # scheduler stamped the oldest op's enqueue; the direct path
            # anchors at the round's first span
            eng.slo.observe(t_done - (self._enq if self._enq is not None else r0))
        if eng.workload is not None:
            eng.workload.observe_round(self._n, eng.ecfg.batch_size, self._qdepth, spans)
        if eng.costmon is not None:
            eng.costmon.observe_round(spans, device_span_s=self._device_span_s)
        if eng.leakmon is not None and "transcript" in host:
            # one non-blocking queue put; the detectors run on the
            # monitor's own thread. "device" and the stages stay
            # tracer-only: the flight recorder's phase schema is the
            # canonical PHASES and "round"
            phases = {k: d for k, (_, d) in spans.items() if k in ALLOWED_PHASE_KEYS}
            eng.leakmon.submit_round(self._batch, host["transcript"], self._n,
                                     eng.ecfg.batch_size, phases,
                                     queue_depth=self._qdepth)
        return out


class GrapevineEngine:
    """The in-process oblivious engine on one device (``device=None`` →
    the CUDA card; raises without one), or at ``shards`` > 1 on a mesh
    of devices (``mesh_devices``). Thread-safe: dispatches are
    serialized by a lock; ``PendingRound.resolve`` runs outside it.

    With ``durability``, construction recovers whatever the state dir
    holds (newest checkpoint, then the journal tail replayed through the
    same round, flush and sweep programs, generator state included), so a
    freshly built engine already holds the pre-crash state."""

    def __init__(self, config: GrapevineConfig | None = None, seed: int = 0,
                 device=None, durability: DurabilityConfig | None = None,
                 mesh_devices=None):
        self.config = config or GrapevineConfig()
        self.device = resolve_device(device)
        self.ecfg = EngineConfig.from_config(self.config)
        #: the fast-branch round graph (``_dispatch_round``), captured on
        #: the second fast round; None until then
        self._graph: RoundGraph | None = None
        #: the state, behind the ``state`` property; and the count of
        #: writes from outside a round that replaced its free_top or
        #: recipients (the admission bound's clock, ``_admission``)
        self._state: EngineState | None = None
        self._state_version = 0
        #: bucket-axis sharding (config ``shards``; parallel/mesh.py): at
        #: shards > 1 the round, flush and replay run the sharded step and
        #: flush on a mesh, the first N CUDA cards (``device="cpu"``: a
        #: virtual mesh of N CPU shards, as the reference's tests force 8
        #: CPU devices); ``mesh_devices`` names the mesh's devices instead
        #: (a device may repeat: chip_smoke.py runs a virtual mesh on one
        #: card). The replicated state lives on the mesh's first device.
        self._mesh = None
        if mesh_devices is not None and self.config.shards == 1:
            raise ValueError("mesh_devices needs shards > 1")
        if self.config.shards > 1:
            self._mesh = make_mesh(self._mesh_devices(mesh_devices))
            self.device = self._mesh.controller
            self.state: EngineState = init_sharded_engine(self.ecfg, self._mesh, seed)
        else:
            self.state = init_engine(self.ecfg, seed, self.device)
        #: the round program (``_round_program``): the op-major step under
        #: ``commit="op"``, the phase-major round otherwise (the
        #: reference's choice); dispatch and journal replay both run it
        self._op_major = self.config.commit == "op"
        #: why no round of this engine can replay the graph (one of
        #: ``EAGER_REASONS``), or None: one CUDA device, phase-major
        self._graph_block = ("mesh" if self._mesh is not None else
                             "op_major" if self._op_major else
                             "not_cuda" if self.device.type != "cuda" else None)
        #: the device buffer every round's batch is uploaded into (where a
        #: round may replay), allocated at the first dispatch
        self._batch_buf: torch.Tensor | None = None
        #: rounds replayed from the graph, and rounds run op by op by
        #: reason (``health()["round_graph"]``)
        self._graph_counts = {"replayed": 0, "eager": dict.fromkeys(EAGER_REASONS, 0)}
        self._lock = threading.Lock()
        #: delayed eviction: the flush runs strictly every E rounds — a
        #: pure function of the round count, never of buffer contents
        self.evict_every = self.ecfg.evict_every
        self._flush_step = engine_flush_step if self.evict_every > 1 else None
        self._sharded_step = None
        if self._mesh is not None:
            sstep = make_sharded_step(self.ecfg, self._mesh)
            self._sharded_step = lambda _ecfg, state, batch, **kw: sstep(state, batch, **kw)
            if self.evict_every > 1:
                sflush = make_sharded_flush(self.ecfg, self._mesh)
                self._flush_step = lambda _ecfg, state: sflush(state)
        self._rounds_since_flush = 0
        self.flushes = 0
        #: replay-time cadence audit (``_replay_record``): rounds seen
        #: since the last flush record; None until the first record
        self._replay_since: int | None = None
        #: the most rounds kept between dispatch and resolve. Not part of
        #: EngineConfig: a journal written at depth 2 replays on a depth-1
        #: engine, so the checkpoint fingerprint must not cover it. Auto:
        #: 1 on the CPU, where the device is the host and a second round in
        #: flight overlaps nothing; 2 on the card, where the host stops
        #: waiting for the device's tail at resolve and chip_smoke.py
        #: phase 10 read higher ops/s at depth 2 in every depth-1/depth-2
        #: pair on the H100 (PERF.md §6 lists every run)
        if self.config.pipeline_depth is not None:
            self.pipeline_depth = self.config.pipeline_depth
        else:
            self.pipeline_depth = 2 if self.device.type == "cuda" else 1
        self.metrics = EngineMetrics()
        #: last sampled per-tree eviction-buffer occupancy (health view)
        self._ebuf_counts: dict = {}
        #: round observers, attached by the serving layer (``attach_*``);
        #: None = not observed. The leak monitor audits every round's
        #: transcript (obs/leakmon.py), the tracer keeps span ledgers
        #: (obs/tracer.py), the SLO tracker the commit latency
        #: (obs/slo.py), the workload telemetry fill, backlog and
        #: utilization (obs/workload.py), the cost monitor the roofline
        #: residual (obs/costmon.py)
        self.leakmon = None
        self.tracer = None
        self.slo = None
        self.workload = None
        self.costmon = None
        #: the admission bound (``_admission``): exact (free_top,
        #: recipients) after dispatch number ``_known[0]``, the CREATE
        #: count of every round dispatched since, and the state version
        #: the bound belongs to (a state set from outside with another
        #: free_top or recipients bumps ``_state_version``, and the next
        #: round reads instead). All of it runs under the engine lock; a
        #: round resolved on another thread hands its exact values over
        #: through ``_resolved`` (a deque: append and popleft are atomic),
        #: folded in at the next dispatch, so the dispatch stage takes no
        #: lock of its own.
        self._dispatched = 0
        self._known: tuple[int, int, int] | None = None
        self._inflight: deque[tuple[int, int]] = deque()
        self._resolved: deque[tuple[int, int, int]] = deque()
        self._bound_version = None
        self.durability = None
        if durability is not None:
            from .checkpoint import DurabilityManager

            self.durability = DurabilityManager(durability, self.ecfg, self.device,
                                                registry=self.metrics.registry)
            with self.metrics.time_phase("replay"):
                # a loaded checkpoint is a one-device state: the sharded
                # step places it on the mesh, and so does this (a no-op
                # once replayed rounds have)
                self.state = self._shard_state(
                    self.durability.recover(self.state, self._replay_record))
                self._read_bound_locked()  # waits for the replayed rounds
        if self.evict_every > 1:
            # the cadence counter comes FROM STATE, never from a host
            # mirror: the records tree runs one fetch round per engine
            # round, so its window counter is rounds-since-flush
            self._rounds_since_flush = int(self.state.rec.ebuf_rounds)
            if self._rounds_since_flush >= self.evict_every:
                # a crash landed between the E-th round's frame and its
                # flush frame: complete (and journal) the flush now, so
                # the journal keeps the [round E, flush] adjacency an
                # uninterrupted run writes
                with self._lock:
                    self._flush_window_locked(min_rounds=self.evict_every)

    @property
    def state(self) -> EngineState:
        """The engine's state. Once the round graph exists its tensors and
        generators keep their addresses (the graph reads and writes them)."""
        return self._state

    @state.setter
    def state(self, new: EngineState) -> None:
        """Set the state from outside a round (construction, recovery, the
        flush, the sweep, a standby's apply or install, a caller): the one
        way, besides the rounds themselves, that the state changes."""
        self._set_state(new, by_round=False)

    def _set_state(self, new: EngineState, by_round: bool) -> None:
        """Make ``new`` the state: copied into the graph's static state
        once the graph exists, else taken as it is. A write from outside
        a round (``by_round`` False) that brings another free_top or
        recipients tensor bumps the state version, so the admission bound,
        which counts only rounds, reads the state before it decides again."""
        old = self._state
        if not by_round and (old is None or new.free_top is not old.free_top
                             or new.recipients is not old.recipients):
            self._state_version += 1
        if self._graph is None:
            self._state = new
        else:
            copy_state_(old, new)

    def _replay_record(self, state: EngineState, rec) -> EngineState:
        """Apply one journal record through the programs the live path
        uses: replay IS re-execution, so the recovered state is
        bit-identical by the engine's own determinism.

        Cadence audit: journal frames validate the batch geometry but not
        the eviction cadence (a journal-only recovery has no checkpoint
        fingerprint to check), so replay cross-checks it: a flush record
        on an ``evict_every=1`` engine, or more rounds than one window
        between flush records, means the journal was written under a
        different cadence. Raise instead of corrupting the window."""
        from .journal import KIND_FLUSH, KIND_ROUND, JournalError

        if self._flush_step is not None and self._replay_since is None:
            self._replay_since = int(state.rec.ebuf_rounds)
        if rec.kind == KIND_ROUND:
            if self._flush_step is not None:
                self._replay_since += 1
                if self._replay_since > self.evict_every:
                    raise JournalError(
                        f"journal frame {rec.seq}: {self._replay_since} rounds "
                        f"since the last flush record but this engine flushes "
                        f"every {self.evict_every} — the journal was written "
                        "under a different evict_every; replay requires the "
                        "identical cadence"
                    )
            state, _resp, _transcript = self._round_program()(
                self.ecfg, state, batch_to_device(rec.batch, self.device))
            return state
        if rec.kind == KIND_FLUSH:
            if self._flush_step is None:
                raise JournalError(
                    f"journal frame {rec.seq}: delayed-eviction flush record "
                    "but this engine runs evict_every=1 — replay requires the "
                    "cadence the journal was written under"
                )
            self._replay_since = 0
            return self._flush_step(self.ecfg, state)
        return expiry_sweep(self.ecfg, state, rec.now, rec.period, rec.now_hi)

    def _round_program(self):
        """The step this engine's rounds run, looked up when called."""
        if self._sharded_step is not None:
            return self._sharded_step
        return engine_step if self._op_major else engine_round_step

    def _mesh_devices(self, mesh_devices) -> list:
        """The mesh's devices: ``mesh_devices`` if given (one per shard),
        else the first ``shards`` CUDA cards, or on the CPU ``shards``
        CPU shards; refuses when fewer cards are visible."""
        n = self.config.shards
        if mesh_devices is not None:
            devs = list(mesh_devices)
            if len(devs) != n:
                raise ValueError(f"shards={n} but {len(devs)} mesh devices were given")
            return devs
        if self.device.type == "cpu":
            return [self.device] * n
        visible = torch.cuda.device_count()
        if visible < n:
            raise ValueError(
                f"shards={n} but only {visible} CUDA device(s) are visible — "
                "the bucket trees shard one contiguous heap range per device"
            )
        return [torch.device("cuda", i) for i in range(n)]

    def _shard_state(self, state: EngineState) -> EngineState:
        """``state`` placed on this engine's mesh (as it is without one): a
        state set from outside, a loaded or installed checkpoint."""
        if self._mesh is None:
            return state
        return shard_engine_state(state, self._mesh)

    # -- the admission bound ---------------------------------------------

    def _read_bound_locked(self) -> tuple[int, int]:
        """Read the state's exact free_top and recipients (one host read,
        which waits for every round in flight) and restart the bound
        from them."""
        st = self.state
        ft, rc = torch.stack([st.free_top, st.recipients]).tolist()
        self._known = (self._dispatched, ft, rc)
        self._inflight.clear()
        self._bound_version = self._state_version
        return ft, rc

    def _admission(self, creates: int) -> bool:
        """The round's admission branch, exactly the reference's
        predicate ``free_top >= B and recipients + B <= max_recipients``
        on the state the round starts from.

        Bound: a round allocates at most one block and claims at most one
        recipient per CREATE op in it; sweeps and flushes only free (and a
        sweep restarts the bound from exact values). So from exact values
        after dispatch number k0 and the CREATE count S of the rounds
        dispatched since, ``free_top >= free_top_k0 - S`` and
        ``recipients <= recipients_k0 + S``. When those bounds already
        satisfy the predicate, the fast branch is the reference's choice
        and the round runs with no host read. Otherwise (near saturation,
        or no bound yet) the round reads the exact values, as the
        reference's ``lax.cond`` would, and takes their branch.

        What the bound reveals through timing: whether a round waited is a
        threshold of public aggregates (messages and recipients, both
        exported in ``health()``) and of the in-flight rounds' CREATE
        counts, and it can wait only within ``S + B`` of a quota, the
        regime where the reference's own branch already changes the
        round's timing. The transcript and every device address are
        unchanged."""
        b = self.ecfg.batch_size
        kn = self._known
        if kn is not None and self._bound_version == self._state_version:
            pending = [c for tag, c in self._inflight if tag > kn[0]]
            s = sum(pending)
            if not pending or admission_fast_ok(self.ecfg, kn[1] - s, kn[2] + s, b):
                # nothing dispatched since the exact values: they ARE
                # the state's, and decide either branch
                return admission_fast_ok(self.ecfg, kn[1] - s, kn[2] + s, b)
        return admission_fast_ok(self.ecfg, *self._read_bound_locked(), b)

    def _fold_resolved(self) -> None:
        """Fold in the exact values resolved rounds handed over (every
        dispatch, under the engine lock: the deque's only consumer)."""
        while self._resolved:
            tag, free_top, recipients = self._resolved.popleft()
            if self._known is None or tag > self._known[0]:
                self._known = (tag, free_top, recipients)
                while self._inflight and self._inflight[0][0] <= tag:
                    self._inflight.popleft()

    def _note_bound(self, tag: int, free_top: int, recipients: int) -> None:
        """A resolved round's own free_top and recipients outputs: exact
        values after dispatch number ``tag``, handed to the next dispatch
        (any thread; takes no lock)."""
        self._resolved.append((tag, free_top, recipients))

    # -- the staged round pipeline -------------------------------------

    def handle_queries(self, reqs: list[QueryRequest], now: int) -> list[QueryResponse]:
        """Process requests in slot order, one padded batch per round.

        Atomicity is per round: the engine lock is taken per batch_size
        chunk. Up to ``pipeline_depth`` chunks stay dispatched but
        unresolved; responses come back in request order (rounds resolve
        in dispatch order), and depth 1 is the serial program."""
        for r in reqs:  # all-or-nothing: nothing commits if any is malformed
            validate_request(r)
        out: list[QueryResponse] = []
        bs = self.ecfg.batch_size
        depth = max(1, self.pipeline_depth)
        ledger: deque[PendingRound] = deque()
        # resolve everything dispatched even when a dispatch or an earlier
        # resolve raises; the FIRST exception stays the one raised
        exc0: BaseException | None = None
        try:
            for i in range(0, len(reqs), bs):
                while len(ledger) >= depth:
                    out.extend(ledger.popleft().resolve())
                ledger.append(self.handle_queries_async(reqs[i:i + bs], now))
        except BaseException as exc:
            exc0 = exc
        while ledger:
            try:
                out.extend(ledger.popleft().resolve())
            except BaseException as exc:
                if exc0 is None:
                    exc0 = exc
        if exc0 is not None:
            raise exc0
        return out

    def _assemble_round(self, reqs: list[QueryRequest], now: int) -> dict:
        """Stage 1 — assemble: validate + pack the wire records into the
        fixed-size batch (outside the lock; the one place a round's
        requests and clock are validated)."""
        for r in reqs:
            validate_request(r)
        if int(now) <= 0:
            raise ValueError("server clock must be positive")
        bs = self.ecfg.batch_size
        if len(reqs) > bs:
            raise ValueError("async path is one round at a time")
        return pack_batch(reqs, bs, now)

    def _journal_round(self, batch: dict, n_real: int, spans: dict) -> None:
        """Stage 2 — journal: sealed append + fsync barrier (per
        ``journal_fsync_every``) BEFORE the round may dispatch, in the
        same lock hold as stage 3, so journal order is dispatch order.
        With a round already in flight (depth 2) the fsync overlaps it."""
        if self.durability is not None:
            t_j0 = time.perf_counter()
            self.durability.append_round(batch, n_real)
            j_s = time.perf_counter() - t_j0
            self.metrics.observe_phase("journal", j_s)
            spans["journal"] = (t_j0, j_s)
        if faults.active():
            # the pipelined crash window: this round is durable but not
            # dispatched, while the previous one may still be running
            faults.crash("round.pre_dispatch")

    def _dispatch_round(self, batch: dict, n_real: int, spans: dict,
                        transcript: bool = False) -> PendingRound:
        """Stage 3 — dispatch: upload the batch, enqueue the round (a
        replay of the round graph, or the round program op by op, its
        output state made ``self.state``), then enqueue the copies of the
        round's outputs to the host and the event ``resolve`` waits on.
        Returns at enqueue; the caller holds the lock. Its four stages
        (``obs/tracer.py:STAGE_SPANS``) go into ``spans`` back to back:
        ``upload``, ``admit``, ``launch`` (the replay, or the round's
        enqueue op by op) and ``download``."""
        t0 = time.perf_counter()
        start = _timing_event(self.device)
        if self._batch_buf is None and self._graph_block is None \
                and self.device.type == "cuda":
            self._batch_buf = torch.empty(sum(np.size(v) for v in batch.values()),
                                          dtype=torch.int32, device=self.device)
        dev_batch, staging = upload_batch(batch, self.device, out=self._batch_buf)
        t_admit = time.perf_counter()
        creates = int(np.count_nonzero(batch["req_type"] == C.REQUEST_TYPE_CREATE))
        self._fold_resolved()
        # the op-major step has no admission branch (each op checks its
        # own quota inside the program)
        fast_ok = None if self._op_major else self._admission(creates)
        eager = self._eager_reason(fast_ok)
        t_launch = time.perf_counter()
        if eager is None:
            if self._graph is None:
                self._graph = RoundGraph(self.ecfg, self.state, dev_batch)
            resp, tr = self._graph.replay()
            self._graph_counts["replayed"] += 1
        else:
            kw = {} if fast_ok is None else {"fast_ok": fast_ok}
            new, resp, tr = self._round_program()(self.ecfg, self.state, dev_batch, **kw)
            self._set_state(new, by_round=True)
            self._graph_counts["eager"][eager] += 1
        t_down = time.perf_counter()
        self._dispatched += 1
        self._inflight.append((self._dispatched, creates))
        outs = dict(resp, free_top=self.state.free_top, recipients=self.state.recipients)
        key_cols = None
        if transcript:
            # the transcript rides the same pinned copies and event as the
            # responses; the monitor gets only the key-material columns
            # (the payload column would sit in its queue unread)
            outs["transcript"] = tr
            key_cols = {k: batch[k] for k in ("req_type", "auth", "msg_id", "recipient")}
        host, done = _stage_to_host(outs)
        t_end = time.perf_counter()
        spans["upload"] = (t0, t_admit - t0)
        spans["admit"] = (t_admit, t_launch - t_admit)
        spans["launch"] = (t_launch, t_down - t_launch)
        spans["download"] = (t_down, t_end - t_down)
        return PendingRound(self, host, done, staging, self._dispatched, n_real, t0,
                            spans=spans, batch=key_cols, start=start,
                            replayed=eager is None)

    def _eager_reason(self, fast_ok: bool | None) -> str | None:
        """Why this round runs op by op (one of ``EAGER_REASONS``), or
        None where it replays the round graph: only the fast branch is
        captured, and the first fast round, which warms up what the
        capture needs, runs eagerly."""
        if self._graph_block is not None:
            return self._graph_block
        if not fast_ok:
            return "slow_branch"
        if self._graph is None and not self._graph_counts["eager"]["warmup"]:
            return "warmup"
        return None

    def handle_queries_async(self, reqs: list[QueryRequest], now: int) -> PendingRound:
        """Dispatch one round without waiting for the device.

        Stages 1-3 (assemble → journal + fsync → dispatch); the returned
        handle's ``resolve()`` is stage 4. The window's flush and a due
        checkpoint run in the same lock hold; their spans land on this
        (the window-closing) round. The round's ledger opens with
        ``pack``, stage 1's span."""
        t_p0 = time.perf_counter()
        batch = self._assemble_round(reqs, now)
        spans: dict = {"pack": (t_p0, time.perf_counter() - t_p0)}
        with self._lock:
            t_d0 = time.perf_counter()
            # "dispatch" spans the journal barrier (append-before-dispatch
            # is the crash-safety contract) and the round's enqueue; the
            # device round itself lands in "evict" at resolve
            with self.metrics.time_phase("dispatch"):
                self._journal_round(batch, len(reqs), spans)
                pending = self._dispatch_round(batch, len(reqs), spans,
                                               transcript=self.leakmon is not None)
            if faults.active():
                faults.crash("round.post_dispatch")
            t_f0 = time.perf_counter()
            if self._flush_window_locked(count_round=True):
                spans["flush"] = (t_f0, time.perf_counter() - t_f0)
            if self.durability is not None and self.durability.should_checkpoint():
                # a pipeline barrier: state_to_bytes waits for every
                # dispatched round, so the sealed state is exactly the
                # journal's seq
                t_c0 = time.perf_counter()
                with self.metrics.time_phase("checkpoint"):
                    self.durability.checkpoint(self.state)
                spans["checkpoint"] = (t_c0, time.perf_counter() - t_c0)
            spans["dispatch"] = (t_d0, time.perf_counter() - t_d0)
        return pending

    def handle_queries_with_transcript(self, reqs: list[QueryRequest], now: int):
        """One batch; returns (responses, transcript u32[B, 2D+1]; [B, 3]
        under ``commit="op"``).

        As the reference's test/bench variant: the requests are validated
        but not the clock, the round is journaled and dispatched and the
        window's flush follows, and it runs no checkpoint cadence and
        records no round metrics."""
        for r in reqs:
            validate_request(r)
        bs = self.ecfg.batch_size
        if len(reqs) > bs:
            raise ValueError("single batch only")
        batch = pack_batch(reqs, bs, now)
        with self._lock:
            self._journal_round(batch, len(reqs), {})
            pending = self._dispatch_round(batch, len(reqs), {}, transcript=True)
            self._flush_window_locked(count_round=True)
        host = pending._wait()
        return unpack_responses(host, len(reqs)), host["transcript"]

    # -- delayed eviction -----------------------------------------------

    def _flush_window_locked(self, count_round: bool = False, min_rounds: int = 1) -> bool:
        """Journal, then dispatch, one flush when the window is due; the
        caller holds the lock.

        ``count_round=True`` counts one round first and flushes only when
        the window closes (the steady-state cadence); ``False`` flushes
        when at least ``min_rounds`` rounds are buffered (``flush_now``
        passes 1, recovery completion ``evict_every``). The flush rides the
        device queue behind the window's last round (the ``flush`` phase
        is its enqueue; its device time lands in the next wait). Returns
        whether it flushed."""
        if self._flush_step is None:
            return False
        if count_round:
            self._rounds_since_flush += 1
        due = self.evict_every if count_round else max(1, min_rounds)
        if self._rounds_since_flush < due:
            return False
        if self.durability is not None:
            with self.metrics.time_phase("journal"):
                self.durability.append_flush()
        if faults.active():
            faults.crash("flush.pre_dispatch")
        with self.metrics.time_phase("flush"):
            self.state = self._flush_step(self.ecfg, self.state)
        self.metrics.record_flush()
        if faults.active():
            faults.crash("flush.post_dispatch")
        if self.leakmon is not None:
            # flush-cadence audit (obs/leakmon.py note_flush): the
            # observed interval before the counter resets; only the
            # automatic cadence is judged
            self.leakmon.note_flush(self._rounds_since_flush, scheduled=count_round)
        self.flushes += 1
        self._rounds_since_flush = 0
        return True

    def flush_now(self) -> bool:
        """Flush a partial window now (operator/test hook, outside the
        steady-state cadence). False when delayed eviction is off or the
        window is empty."""
        with self._lock:
            return self._flush_window_locked()

    def flush_bubble_pending(self) -> bool:
        """True between a flush dispatch and the next round dispatch (and
        at engine start): the next collection window overlaps the flush's
        device time. A pure function of the cadence counter, itself a pure
        function of the round count. Benign unlocked int read."""
        return self._flush_step is not None and self._rounds_since_flush == 0

    # -- round observers and phase calibrations ------------------------

    def attach_leakmon(self, monitor) -> None:
        """Attach an EngineLeakMonitor; subsequent rounds bring their
        transcripts down with their responses and hand them to it
        (PendingRound.resolve)."""
        self.leakmon = monitor

    def attach_tracer(self, tracer) -> None:
        """Attach a RoundTracer; subsequent rounds append their span
        ledgers to its ring (PendingRound.resolve)."""
        self.tracer = tracer

    def attach_slo(self, slo) -> None:
        """Attach an SloTracker; subsequent rounds observe their
        enqueue→settle commit latency against it."""
        self.slo = slo

    def attach_workload(self, workload) -> None:
        """Attach a WorkloadTelemetry; subsequent rounds observe their
        fill/backlog/utilization and the scheduler notes arrivals."""
        self.workload = workload

    def attach_costmon(self, costmon) -> None:
        """Attach a CostMonitor; subsequent rounds score their device
        span against the modeled roofline floor."""
        self.costmon = costmon

    def _calibrate(self, phase: str, setup, run, reps: int) -> float:
        """Time ``run(setup())`` ``reps`` times after one warm-up call (CUDA
        events on the card, ``perf_counter`` on the CPU), record the
        minimum under ``phase`` and return it in seconds. Runs on fresh
        tensors at the round's shapes and never takes the engine lock:
        the workload is shape-static and data-independent, so it prices
        the live round without touching its state."""
        inputs = setup()
        run(inputs)  # warm-up: allocator, kernel caches
        cuda = self.device.type == "cuda"
        best = None
        for _ in range(max(1, reps)):
            if cuda:
                t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
                    enable_timing=True)
                t0.record()
                run(inputs)
                t1.record()
                t1.synchronize()
                dt = t0.elapsed_time(t1) / 1e3
            else:
                w0 = time.perf_counter()
                run(inputs)
                dt = time.perf_counter() - w0
            best = dt if best is None else min(best, dt)
        self.metrics.observe_phase(phase, best)
        return best

    def calibrate_sort_phase(self, reps: int = 5) -> float:
        """Measure the round's sort workload standalone and record it
        under the ``sort`` phase (the reference's ``calibrate_sort_phase``).

        The host cannot time inside the round, but every sort it runs is
        shape-static and data-independent (oblivious), so the same sort
        machinery at the same shapes IS the per-round sort cost: the three
        eviction leaf sorts at their working-set sizes (W = stash +
        nb·path_len·Z + nb per ORAM round: mailbox A, records B, mailbox C;
        ``oram/round.py:_assign_evictions``) and the admission walk's slot
        grouping (``segmented.group_sort``), each under the engine's
        ``sort_impl``; under ``vphases_impl="scan"`` also each round's
        dedup group sort, its bucket / record-block group sort and the
        10-word recipient grouping (always the comparison sort). Returns
        the min-of-``reps`` seconds."""
        from ..oblivious.radix import radix_group_sort, radix_rank
        from ..oblivious.segmented import group_sort, multiword_group_sort
        from ..oram.path_oram import random_below, random_u32
        from ..u32 import widen

        ecfg, dev = self.ecfg, self.device
        b, d = ecfg.batch_size, ecfg.mb_choices
        slot_bits = max(1, (b - 1).bit_length())
        trees = ((ecfg.mb, b * d), (ecfg.rec, b), (ecfg.mb, b * d))
        # per-round index group bounds (vphases._index_groups): bucket
        # groups in rounds A/C, record-block groups in round B
        g_bits = [max(1, (n + 1 + b - 1).bit_length()) for n in
                  (ecfg.mb_table_buckets, ecfg.rec.blocks, ecfg.mb_table_buckets)]
        radix = ecfg.sort_impl == "radix"
        scan = ecfg.vphases_impl == "scan"

        def setup():
            gen = torch.Generator(device=dev).manual_seed(0)
            leaves = [random_below(gen, 1 << cfg.height,
                                   (cfg.stash_size + nb * cfg.path_len * cfg.bucket_slots
                                    + nb,), dev)
                      for cfg, nb in trees]
            groups = []
            if scan:
                for (cfg, nb), gb in zip(trees, g_bits):
                    kb = max(1, cfg.dummy_index.bit_length())
                    groups.append((kb, random_below(gen, 1 << kb, (nb,), dev),
                                   gb, random_below(gen, 1 << gb, (b,), dev)))
                kcols = list(random_u32(gen, (10, b), dev))
            else:
                kcols = None
            return leaves, groups, kcols, random_below(gen, 1 << slot_bits, (b,), dev)

        def run(inputs):
            leaves, groups, kcols, rslot = inputs
            for cfg, leaf in zip((ecfg.mb, ecfg.rec, ecfg.mb), leaves):
                if radix:
                    radix_rank(leaf, cfg.height + 1)
                else:
                    torch.sort(widen(leaf), stable=True)
            for kb, idxs, gb, gi in groups:
                if radix:
                    radix_group_sort([idxs], kb)
                else:
                    multiword_group_sort([idxs])
                group_sort(gi, sort_impl=ecfg.sort_impl, key_bits=gb)
            group_sort(rslot, sort_impl=ecfg.sort_impl, key_bits=slot_bits)
            if kcols is not None:
                multiword_group_sort(kcols)

        return self._calibrate("sort", setup, run, reps)

    def calibrate_posmap_phase(self, reps: int = 5) -> float:
        """Measure the round's position-resolution workload standalone and
        record it under the ``posmap`` phase (the reference's
        ``calibrate_posmap_phase``): for each ORAM round (mailbox A,
        records B, mailbox C) the duplicate masks and the flat map's
        lookup and remap (``oram/round.py:occurrence_masks``, or
        ``occurrence_masks_sorted`` under ``vphases_impl="scan"``;
        ``oram/posmap.py:lookup_remap_round``) at the round's batch, on a
        fresh map of the engine's geometry: under ``"recursive"`` that is
        the internal ORAM's full round. Returns the min-of-``reps``
        seconds."""
        from ..oram.path_oram import random_below
        from ..oram.posmap import init_posmap, lookup_remap_round
        from ..oram.round import occurrence

        ecfg, dev = self.ecfg, self.device
        b, d = ecfg.batch_size, ecfg.mb_choices
        jobs = ((ecfg.mb, b * d), (ecfg.rec, b), (ecfg.mb, b * d))
        occ, simpl = ecfg.vphases_impl, ecfg.sort_impl

        def setup():
            gen = torch.Generator(device=dev).manual_seed(17)
            out = []
            for cfg, nb in jobs:
                pm = random_below(gen, cfg.leaves, (cfg.blocks + 1,), dev)
                il = None
                if cfg.posmap is not None:
                    pm = init_posmap(cfg, pm, gen, dev)
                    il = cfg.posmap.inner_leaves
                out.append([cfg, pm,
                            random_below(gen, cfg.blocks + 1, (nb,), dev),
                            random_below(gen, cfg.leaves, (nb,), dev),
                            random_below(gen, cfg.leaves, (nb,), dev),
                            *((random_below(gen, il, (nb,), dev),
                               random_below(gen, il, (nb,), dev)) if il else ())])
            return out

        def run(inputs):
            for job in inputs:
                cfg, pm, idxs, nl, dl, *pml = job
                fo, lo, _ = occurrence(cfg, idxs, occ, simpl)
                # the internal round consumes its state: carry it on
                job[1] = lookup_remap_round(cfg, pm, idxs, nl, dl, fo, lo, *pml,
                                            sort_impl=simpl, occ_impl=occ)[0]

        return self._calibrate("posmap", setup, run, reps)

    # -- sweep, checkpoints, close ---------------------------------------

    def expire(self, now: int, period: int | None = None) -> int:
        """Run the expiry sweep (journaled first); returns the number of
        records evicted. ``period`` defaults to the config's
        ``expiry_period``; 0 or less disables; 2^32 or more raises
        ``OverflowError`` before anything changes (the reference's u32
        conversion raises)."""
        period = self.config.expiry_period if period is None else int(period)
        if period <= 0:
            return 0
        if period >= 1 << 32:
            raise OverflowError(f"expiry period {period} does not fit in a u32 lane")
        lo, hi = int(now) & 0xFFFFFFFF, (int(now) >> 32) & 0xFFFFFFFF
        with self._lock:
            before = int(self.state.free_top)
            if self.durability is not None:
                # journal before mutate, as rounds: a crash between the
                # append and the sweep replays the sweep
                self.durability.append_sweep(lo, hi, period)
            with self.metrics.time_phase("sweep"):
                self.state = expiry_sweep(self.ecfg, self.state, lo, period, hi)
                free_top, _ = self._read_bound_locked()
            evicted = free_top - before
            self.metrics.record_sweep(evicted)
            if self.durability is not None and self.durability.should_checkpoint():
                # sweeps count toward the checkpoint cadence like rounds
                with self.metrics.time_phase("checkpoint"):
                    self.durability.checkpoint(self.state)
            return evicted

    def checkpoint_now(self) -> int | None:
        """Force a sealed checkpoint of the current state (the drain
        path); None without durability."""
        if self.durability is None:
            return None
        with self._lock:
            with self.metrics.time_phase("checkpoint"):
                return self.durability.checkpoint(self.state)

    def close(self) -> None:
        """Sync and close the durability store (if any)."""
        if self.durability is not None:
            with self._lock:
                self.durability.close()

    # -- metrics (never keyed by client identity) ------------------------

    def message_count(self) -> int:
        return self.ecfg.max_messages - int(self.state.free_top)

    def recipient_count(self) -> int:
        return int(self.state.recipients)

    def sample_stash(self) -> dict:
        """Sample both trees' stash occupancy into the metrics gauges (and,
        under delayed eviction, the eviction buffers'); returns the
        per-tree stash counts. Scrape cadence, not per round: a device
        reduction every round would serialize the pipeline for a gauge
        read only between scrapes (``MetricsServer``'s pre-scrape hook)."""
        with self._lock:
            trees = {"rec": self.state.rec, "mb": self.state.mb}
            counts = {n: int((t.stash_idx != SENTINEL).sum()) for n, t in trees.items()}
            ebuf = ({n: int((t.ebuf_idx != SENTINEL).sum()) for n, t in trees.items()}
                    if self.evict_every > 1 else {})
            self._ebuf_counts = ebuf
        for n in counts.values():
            self.metrics.observe_stash(n)
        if ebuf:
            self.metrics.observe_evict_buffer(sum(ebuf.values()))
        return counts

    def health(self) -> dict:
        """Aggregate state + batch-level counters (never per-client): the
        reference's keys, ``durability`` (the durability manager's status)
        when a state dir is configured, and ``round_graph``: the rounds
        replayed from the round graph and those run op by op, by reason
        (``EAGER_REASONS``)."""
        occupancy = self.sample_stash()
        with self._lock:
            st = self.state
            out = {
                "messages": self.ecfg.max_messages - int(st.free_top),
                "recipients": int(st.recipients),
                "stash_overflow": int(st.rec.overflow) + int(st.mb.overflow),
                "stash_occupancy": occupancy,
                **self.metrics.snapshot(),
            }
            if self.evict_every > 1:
                out["evict_buffer_occupancy"] = dict(self._ebuf_counts)
                out["evict_buffer_slots"] = {
                    "rec": self.ecfg.rec.evict_buffer_slots,
                    "mb": self.ecfg.mb.evict_buffer_slots,
                }
                out["evict_rounds_since_flush"] = self._rounds_since_flush
            if self.durability is not None:
                out["durability"] = self.durability.status()
            out["round_graph"] = {"replayed": self._graph_counts["replayed"],
                                  "eager": dict(self._graph_counts["eager"])}
            return out
