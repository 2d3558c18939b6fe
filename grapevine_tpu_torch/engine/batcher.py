"""Host-side batching and the engine facade (port of the core of
``grapevine_tpu/engine/batcher.py``).

``pack_batch``/``unpack_responses`` convert between wire records and the
columnar batch arrays; :class:`GrapevineEngine` owns the device state and
serves ``handle_queries`` one padded batch per engine round, serially,
with the delayed-eviction flush every ``evict_every`` rounds. Durability,
the async pipeline, expiry and the ``attach_*`` telemetry hooks belong to
later slices (ROADMAP.md queue A).
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..config import GrapevineConfig
from ..device import resolve_device
from ..u32 import SENTINEL, from_numpy, to_numpy
from ..wire.records import QueryRequest, QueryResponse, Record
from ..wire.validate import validate_request
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
    serialized by a lock."""

    def __init__(self, config: GrapevineConfig | None = None, seed: int = 0,
                 device=None):
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
        """One engine round over ≤B validated requests; the window's
        flush follows the E-th round once its responses are unpacked."""
        batch = batch_to_device(pack_batch(chunk, self.ecfg.batch_size, now), self.device)
        with self._lock:
            self.state, resp, transcript = engine_round_step(self.ecfg, self.state, batch)
            self.rounds += 1
            out = unpack_responses(resp, len(chunk)), to_numpy(transcript)
            self._flush_window_locked(count_round=True)
        return out

    def _flush_window_locked(self, count_round: bool = False) -> bool:
        """Flush when the window is due; the caller holds the lock.

        ``count_round=True`` counts one round first and flushes only when
        the window closes (the steady-state cadence); ``False`` flushes
        any non-empty window (``flush_now``). Returns whether it
        flushed."""
        if self._flush_step is None:
            return False
        if count_round:
            self._rounds_since_flush += 1
        due = self.evict_every if count_round else 1
        if self._rounds_since_flush < due:
            return False
        self.state = self._flush_step(self.ecfg, self.state)
        self.flushes += 1
        self._rounds_since_flush = 0
        return True

    def flush_now(self) -> bool:
        """Flush a partial window now (operator/test hook, outside the
        steady-state cadence). False when delayed eviction is off or the
        window is empty."""
        with self._lock:
            return self._flush_window_locked()

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
            return out
