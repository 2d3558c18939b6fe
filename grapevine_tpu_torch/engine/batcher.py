"""Host-side batching and the engine facade (port of the core of
``grapevine_tpu/engine/batcher.py``).

``pack_batch``/``unpack_responses`` convert between wire records and the
columnar batch arrays; :class:`GrapevineEngine` owns the device state and
serves ``handle_queries`` one padded batch per engine round, serially,
with the delayed-eviction flush every ``evict_every`` rounds, runs the
expiry sweep (``expire``), and with a ``DurabilityConfig`` journals every
round, flush and sweep (sealed) before the state changes, checkpoints the
whole state on a cadence, and recovers on construction by replaying
through the same programs (``engine/checkpoint.py``, ``engine/journal.py``).
The async pipeline and the ``attach_*`` telemetry hooks belong to later
slices (ROADMAP.md queue A).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..config import DurabilityConfig, GrapevineConfig
from ..device import resolve_device
from ..testing import faults
from ..u32 import SENTINEL, from_numpy, to_numpy
from ..wire.records import QueryRequest, QueryResponse, Record
from ..wire.validate import validate_request
from .expiry import expiry_sweep
from .round_step import engine_flush_step, engine_round_step
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


def batch_to_device(batch: dict, device) -> dict:
    """numpy batch columns → int32 tensors on ``device``."""
    return {k: from_numpy(np.asarray(v, np.uint32), device) for k, v in batch.items()}


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


class GrapevineEngine:
    """The in-process oblivious engine on one device (``device=None`` →
    the CUDA card; raises without one). Thread-safe: rounds are
    serialized by a lock.

    With ``durability``, construction recovers whatever the state dir
    holds (newest checkpoint, then the journal tail replayed through the
    same round, flush and sweep programs, generator state included), so a
    freshly built engine already holds the pre-crash state."""

    def __init__(self, config: GrapevineConfig | None = None, seed: int = 0,
                 device=None, durability: DurabilityConfig | None = None):
        self.config = config or GrapevineConfig()
        self.device = resolve_device(device)
        self.ecfg = EngineConfig.from_config(self.config)
        self.state: EngineState = init_engine(self.ecfg, seed, self.device)
        self._lock = threading.Lock()
        self.rounds = 0
        #: delayed eviction: the flush runs strictly every E rounds — a
        #: pure function of the round count, never of buffer contents
        self.evict_every = self.ecfg.evict_every
        self._flush_step = engine_flush_step if self.evict_every > 1 else None
        self._rounds_since_flush = 0
        self.flushes = 0
        #: replay-time cadence audit (``_replay_record``): rounds seen
        #: since the last flush record; None until the first record
        self._replay_since: int | None = None
        self.durability = None
        if durability is not None:
            from .checkpoint import DurabilityManager

            self.durability = DurabilityManager(durability, self.ecfg, self.device)
            self.state = self.durability.recover(self.state, self._replay_record)
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
            state, _resp, _transcript = engine_round_step(
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

    def handle_queries(self, reqs: list[QueryRequest], now: int) -> list[QueryResponse]:
        """Process requests in slot order, one padded batch per round."""
        self._validate(reqs, now)
        out: list[QueryResponse] = []
        bs = self.ecfg.batch_size
        for i in range(0, len(reqs), bs):
            out.extend(self._round(reqs[i:i + bs], now)[0])
        return out

    def handle_queries_with_transcript(self, reqs: list[QueryRequest], now: int):
        """One batch; returns (responses, transcript u32[B, 2D+1])."""
        self._validate(reqs, now)
        if len(reqs) > self.ecfg.batch_size:
            raise ValueError("single batch only")
        return self._round(reqs, now)

    @staticmethod
    def _validate(reqs, now) -> None:
        for r in reqs:  # all-or-nothing: nothing commits if any is malformed
            validate_request(r)
        if int(now) <= 0:
            raise ValueError("server clock must be positive")

    def _round(self, chunk, now):
        """One engine round over ≤B validated requests, journaled before
        it dispatches; the window's flush follows the E-th round once its
        responses are unpacked, then a checkpoint when one is due."""
        host_batch = pack_batch(chunk, self.ecfg.batch_size, now)
        batch = batch_to_device(host_batch, self.device)
        with self._lock:
            if self.durability is not None:
                self.durability.append_round(host_batch, len(chunk))
            if faults.active():
                faults.crash("round.pre_dispatch")
            self.state, resp, transcript = engine_round_step(self.ecfg, self.state, batch)
            if faults.active():
                faults.crash("round.post_dispatch")
            self.rounds += 1
            out = unpack_responses(resp, len(chunk)), to_numpy(transcript)
            self._flush_window_locked(count_round=True)
            self._checkpoint_if_due_locked()
        return out

    def _checkpoint_if_due_locked(self) -> None:
        if self.durability is not None and self.durability.should_checkpoint():
            self.durability.checkpoint(self.state)

    def _flush_window_locked(self, count_round: bool = False, min_rounds: int = 1) -> bool:
        """Journal, then run, one flush when the window is due; the caller
        holds the lock.

        ``count_round=True`` counts one round first and flushes only when
        the window closes (the steady-state cadence); ``False`` flushes
        when at least ``min_rounds`` rounds are buffered (``flush_now``
        passes 1, recovery completion ``evict_every``). Returns whether
        it flushed."""
        if self._flush_step is None:
            return False
        if count_round:
            self._rounds_since_flush += 1
        due = self.evict_every if count_round else max(1, min_rounds)
        if self._rounds_since_flush < due:
            return False
        if self.durability is not None:
            self.durability.append_flush()
        if faults.active():
            faults.crash("flush.pre_dispatch")
        self.state = self._flush_step(self.ecfg, self.state)
        if faults.active():
            faults.crash("flush.post_dispatch")
        self.flushes += 1
        self._rounds_since_flush = 0
        return True

    def flush_now(self) -> bool:
        """Flush a partial window now (operator/test hook, outside the
        steady-state cadence). False when delayed eviction is off or the
        window is empty."""
        with self._lock:
            return self._flush_window_locked()

    def expire(self, now: int, period: int | None = None) -> int:
        """Run the expiry sweep (journaled first); returns the number of
        records evicted. ``period`` defaults to the config's
        ``expiry_period``; 0 disables."""
        period = self.config.expiry_period if period is None else int(period)
        if period <= 0:
            return 0
        lo, hi = int(now) & 0xFFFFFFFF, (int(now) >> 32) & 0xFFFFFFFF
        with self._lock:
            before = int(self.state.free_top)
            if self.durability is not None:
                # journal before mutate, as rounds: a crash between the
                # append and the sweep replays the sweep
                self.durability.append_sweep(lo, hi, period)
            self.state = expiry_sweep(self.ecfg, self.state, lo, period, hi)
            evicted = int(self.state.free_top) - before
            # sweeps count toward the checkpoint cadence like rounds
            self._checkpoint_if_due_locked()
            return evicted

    def checkpoint_now(self) -> int | None:
        """Force a sealed checkpoint of the current state (the drain
        path); None without durability."""
        if self.durability is None:
            return None
        with self._lock:
            return self.durability.checkpoint(self.state)

    def close(self) -> None:
        """Sync and close the durability store (if any)."""
        if self.durability is not None:
            with self._lock:
                self.durability.close()

    def message_count(self) -> int:
        return self.ecfg.max_messages - int(self.state.free_top)

    def recipient_count(self) -> int:
        return int(self.state.recipients)

    def health(self) -> dict:
        """Aggregate state counters (never per-client). Under delayed
        eviction also each tree's buffer occupancy against its capacity
        (buffer overflow rides ``stash_overflow``) and the window
        position."""
        with self._lock:
            st = self.state
            out = {
                "messages": self.ecfg.max_messages - int(st.free_top),
                "recipients": int(st.recipients),
                "stash_overflow": int(st.rec.overflow) + int(st.mb.overflow),
                "stash_occupancy": {
                    "rec": int((st.rec.stash_idx != SENTINEL).sum()),
                    "mb": int((st.mb.stash_idx != SENTINEL).sum()),
                },
                "rounds": self.rounds,
                "device": str(self.device),
            }
            if self.evict_every > 1:
                out["evict_buffer_occupancy"] = {
                    "rec": int((st.rec.ebuf_idx != SENTINEL).sum()),
                    "mb": int((st.mb.ebuf_idx != SENTINEL).sum()),
                }
                out["evict_buffer_slots"] = {
                    "rec": self.ecfg.rec.evict_buffer_slots,
                    "mb": self.ecfg.mb.evict_buffer_slots,
                }
                out["evict_rounds_since_flush"] = self._rounds_since_flush
                out["evict_flushes"] = self.flushes
            if self.durability is not None:
                out["durability"] = self.durability.status()
            return out
