"""Plain-dict CPU reference engine: the CRUD semantics oracle (the port's
own copy of ``grapevine_tpu/testing/reference.py``, on the port's
``config`` and ``wire``; no JAX, so ``chip_smoke.py`` uses it on the card).

Implements the complete documented behavior of the reference's query engine
(reference grapevine.proto:57-122, README.md:162-175) with ordinary Python
data structures and no obliviousness. The device engine is tested for
result-equality against this model on random operation sequences — the
analog of upstream mc-oblivious testing ORAM against a plain HashMap
(SURVEY.md §4).

Semantics implemented (each cited to the reference spec):

- CREATE (grapevine.proto:66-79): client msg_id and timestamp ignored;
  server assigns a random nonzero id and its own clock. Statuses:
  INVALID_RECIPIENT for a zero recipient; TOO_MANY_MESSAGES_FOR_RECIPIENT
  at the 62-message mailbox cap (README.md:78-80); TOO_MANY_RECIPIENTS /
  TOO_MANY_MESSAGES at table capacity; MESSAGE_ID_ALREADY_IN_USE on id
  collision.
- READ (grapevine.proto:81-91): nonzero id → record iff auth_identity is
  its sender or recipient, else NOT_FOUND (absence and permission failure
  are deliberately the same error — no existence oracle). Zero id → the
  next (oldest) message addressed to auth_identity.
- UPDATE (grapevine.proto:92-103): zero id is a hard protocol error;
  NOT_FOUND under the read rule; INVALID_RECIPIENT if the supplied
  recipient differs from the stored one; otherwise payload replaced and
  timestamp refreshed.
- DELETE (grapevine.proto:104-118): nonzero id → same checks as UPDATE,
  then record and its mailbox entry are removed together (README.md:173-175).
  Zero id → pop the next message for auth_identity.
- Expiry (README.md:86-98): records older than the expiry period are
  removed, including their mailbox entries (the reference MVP left hashmap
  eviction unimplemented, README.md:98-99; this build completes it).

Failure responses carry a zero record but a real (nonzero) server
timestamp so that even protobuf-encoded responses stay constant-size.

Status precedence when multiple CREATE failures apply simultaneously
(the reference never specifies this; pinned here and mirrored by the
device engine): INVALID_RECIPIENT, then TOO_MANY_MESSAGES (bus full),
then TOO_MANY_RECIPIENTS, then TOO_MANY_MESSAGES_FOR_RECIPIENT.
"""

from __future__ import annotations

import copy
import random
from dataclasses import dataclass, field

from ..config import GrapevineConfig
from ..wire import constants as C
from ..wire.records import QueryRequest, QueryResponse, Record


class HardProtocolError(Exception):
    """API misuse that fails fast at the transport layer, not via status code.

    Mirrors the reference's hard gRPC errors: zero auth identity
    (grapevine.proto:60-64), UPDATE with a zero msg_id (grapevine.proto:95).
    """


def _zero_response(now: int, status: int) -> QueryResponse:
    return QueryResponse(
        record=Record(timestamp=max(1, now)),  # nonzero ts: constant-size invariant
        status_code=status,
    )


@dataclass
class ReferenceEngine:
    """The oracle. Not oblivious, not fast — just exactly correct."""

    config: GrapevineConfig = field(default_factory=GrapevineConfig)
    rng: random.Random = field(default_factory=lambda: random.Random(0))

    def __post_init__(self):
        self.records: dict[bytes, Record] = {}
        # recipient -> msg_ids in insertion order; "next message" = index 0
        self.mailboxes: dict[bytes, list[bytes]] = {}

    # -- helpers --------------------------------------------------------

    def _assign_msg_id(self) -> bytes:
        while True:
            mid = self.rng.getrandbits(128).to_bytes(16, "little")
            if mid != C.ZERO_MSG_ID:
                return mid

    def _next_msg_id(self, identity: bytes) -> bytes | None:
        box = self.mailboxes.get(identity)
        return box[0] if box else None

    def _remove_mailbox_entry(self, recipient: bytes, msg_id: bytes) -> None:
        box = self.mailboxes.get(recipient)
        if box is None:
            return
        box[:] = [m for m in box if m != msg_id]
        # sticky slots: a drained mailbox keeps its recipient slot until
        # the expiry sweep reclaims it (engine/vphases.py docstring)

    @staticmethod
    def _ok(rec: Record) -> QueryResponse:
        # responses carry a snapshot, never an alias of live engine state
        return QueryResponse(record=copy.deepcopy(rec), status_code=C.STATUS_CODE_SUCCESS)

    # -- the CRUD API ---------------------------------------------------

    def handle_query(
        self, req: QueryRequest, now: int, forced_msg_id: bytes | None = None
    ) -> QueryResponse:
        """Handle one (already authenticated) query.

        ``forced_msg_id`` lets equality tests replay the device engine's id
        assignment; production callers leave it None.
        """
        req.validate()
        if req.auth_identity == C.ZERO_PUBKEY:
            raise HardProtocolError("auth identity must be nonzero")
        now = int(now)
        if now <= 0:
            raise ValueError("server clock must be positive")

        rt = req.request_type
        if rt == C.REQUEST_TYPE_CREATE:
            return self._create(req, now, forced_msg_id)
        if rt == C.REQUEST_TYPE_READ:
            return self._read(req, now)
        if rt == C.REQUEST_TYPE_UPDATE:
            return self._update(req, now)
        if rt == C.REQUEST_TYPE_DELETE:
            return self._delete(req, now)
        raise HardProtocolError(f"invalid request type {rt}")

    def _create(
        self, req: QueryRequest, now: int, forced_msg_id: bytes | None
    ) -> QueryResponse:
        recipient = req.record.recipient
        if recipient == C.ZERO_PUBKEY:
            return _zero_response(now, C.STATUS_CODE_INVALID_RECIPIENT)
        if len(self.records) >= self.config.max_messages:
            return _zero_response(now, C.STATUS_CODE_TOO_MANY_MESSAGES)
        box = self.mailboxes.get(recipient)
        if box is None and len(self.mailboxes) >= self.config.max_recipients:
            return _zero_response(now, C.STATUS_CODE_TOO_MANY_RECIPIENTS)
        if box is not None and len(box) >= self.config.mailbox_cap:
            return _zero_response(now, C.STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT)

        msg_id = forced_msg_id if forced_msg_id is not None else self._assign_msg_id()
        if msg_id in self.records:
            return _zero_response(now, C.STATUS_CODE_MESSAGE_ID_ALREADY_IN_USE)

        record = Record(
            msg_id=msg_id,
            sender=req.auth_identity,
            recipient=recipient,
            timestamp=now,
            payload=req.record.payload,
        )
        self.records[msg_id] = record
        self.mailboxes.setdefault(recipient, []).append(msg_id)
        return self._ok(record)

    def _lookup_authorized(self, msg_id: bytes, auth: bytes) -> Record | None:
        """Shared READ-rule lookup: absence ≡ permission failure (no oracle)."""
        rec = self.records.get(msg_id)
        if rec is None or auth not in (rec.sender, rec.recipient):
            return None
        return rec

    def _read(self, req: QueryRequest, now: int) -> QueryResponse:
        msg_id = req.record.msg_id
        if msg_id == C.ZERO_MSG_ID:
            next_id = self._next_msg_id(req.auth_identity)
            if next_id is None:
                return _zero_response(now, C.STATUS_CODE_NOT_FOUND)
            return self._ok(self.records[next_id])
        rec = self._lookup_authorized(msg_id, req.auth_identity)
        if rec is None:
            return _zero_response(now, C.STATUS_CODE_NOT_FOUND)
        return self._ok(rec)

    def _update(self, req: QueryRequest, now: int) -> QueryResponse:
        msg_id = req.record.msg_id
        if msg_id == C.ZERO_MSG_ID:
            raise HardProtocolError("UPDATE with zero msg_id")  # grapevine.proto:95
        rec = self._lookup_authorized(msg_id, req.auth_identity)
        if rec is None:
            return _zero_response(now, C.STATUS_CODE_NOT_FOUND)
        if req.record.recipient != rec.recipient:
            return _zero_response(now, C.STATUS_CODE_INVALID_RECIPIENT)
        rec.payload = req.record.payload
        rec.timestamp = now
        return self._ok(rec)

    def _delete(self, req: QueryRequest, now: int) -> QueryResponse:
        msg_id = req.record.msg_id
        if msg_id == C.ZERO_MSG_ID:
            next_id = self._next_msg_id(req.auth_identity)
            if next_id is None:
                return _zero_response(now, C.STATUS_CODE_NOT_FOUND)
            rec = self.records.pop(next_id)
            self._remove_mailbox_entry(rec.recipient, rec.msg_id)
            return self._ok(rec)
        rec = self._lookup_authorized(msg_id, req.auth_identity)
        if rec is None:
            return _zero_response(now, C.STATUS_CODE_NOT_FOUND)
        if req.record.recipient != rec.recipient:
            return _zero_response(now, C.STATUS_CODE_INVALID_RECIPIENT)
        del self.records[msg_id]
        self._remove_mailbox_entry(rec.recipient, msg_id)
        return self._ok(rec)

    # -- phase-major batch mode (mirrors engine/round_step.py) ----------

    def handle_batch(
        self,
        reqs: list[QueryRequest],
        now: int,
        forced_msg_ids: list[bytes | None] | None = None,
    ) -> list[QueryResponse]:
        """Handle one batch under **phase-major commit semantics**.

        The batched device engine (engine/round_step.py) commits each of
        its three phases for the whole batch before the next phase:
        mailbox effects (A), record effects (B), mailbox finalization (C).
        This oracle method replays exactly that schedule with plain dicts;
        see round_step.py's module docstring for the semantics and their
        consequences. For single-op batches it coincides with
        ``handle_query``.
        """
        n = len(reqs)
        forced = forced_msg_ids or [None] * n
        for req in reqs:
            req.validate()
            if req.auth_identity == C.ZERO_PUBKEY:
                raise HardProtocolError("auth identity must be nonzero")
            if not (1 <= req.request_type <= 4):
                raise HardProtocolError(f"invalid request type {req.request_type}")
            if (
                req.request_type == C.REQUEST_TYPE_UPDATE
                and req.record.msg_id == C.ZERO_MSG_ID
            ):
                raise HardProtocolError("UPDATE with zero msg_id")
        now = int(now)
        if now <= 0:
            raise ValueError("server clock must be positive")

        # ---- phase A: mailbox decisions and effects, slot order --------
        # statuses decided here stay final for CREATE; zero-id ops record
        # their selected message id
        status_a: list[int | None] = [None] * n
        selected: list[bytes | None] = [None] * n
        create_ok = [False] * n
        msg_ids: list[bytes | None] = [None] * n
        free_at_start = self.config.max_messages - len(self.records)
        creates_so_far = 0
        for i, req in enumerate(reqs):
            rt = req.request_type
            if rt == C.REQUEST_TYPE_CREATE:
                recipient = req.record.recipient
                box = self.mailboxes.get(recipient)
                if recipient == C.ZERO_PUBKEY:
                    status_a[i] = C.STATUS_CODE_INVALID_RECIPIENT
                elif free_at_start - creates_so_far <= 0:
                    # record slots freed by same-batch deletes are not
                    # reusable until the next batch (phase-major rule)
                    status_a[i] = C.STATUS_CODE_TOO_MANY_MESSAGES
                elif box is None and len(self.mailboxes) >= self.config.max_recipients:
                    status_a[i] = C.STATUS_CODE_TOO_MANY_RECIPIENTS
                elif box is not None and len(box) >= self.config.mailbox_cap:
                    status_a[i] = C.STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT
                else:
                    mid = forced[i] if forced[i] is not None else self._assign_msg_id()
                    create_ok[i] = True
                    creates_so_far += 1
                    msg_ids[i] = mid
                    self.mailboxes.setdefault(recipient, []).append(mid)
                    status_a[i] = C.STATUS_CODE_SUCCESS
            elif req.record.msg_id == C.ZERO_MSG_ID:
                selected[i] = self._next_msg_id(req.auth_identity)
                if rt == C.REQUEST_TYPE_DELETE and selected[i] is not None:
                    # zero-id pop removes the mailbox entry in phase A
                    self._remove_mailbox_entry(req.auth_identity, selected[i])

        # ---- phase B: record effects, slot order -----------------------
        out: list[QueryResponse | None] = [None] * n
        deferred_c: list[tuple[int, bytes, bytes]] = []  # (slot, recipient, msg_id)
        for i, req in enumerate(reqs):
            rt = req.request_type
            if rt == C.REQUEST_TYPE_CREATE:
                if not create_ok[i]:
                    out[i] = _zero_response(now, status_a[i])
                    continue
                record = Record(
                    msg_id=msg_ids[i],
                    sender=req.auth_identity,
                    recipient=req.record.recipient,
                    timestamp=now,
                    payload=req.record.payload,
                )
                self.records[msg_ids[i]] = record
                out[i] = self._ok(record)
                continue

            mid = (
                selected[i] if req.record.msg_id == C.ZERO_MSG_ID else req.record.msg_id
            )
            rec = (
                self._lookup_authorized(mid, req.auth_identity)
                if mid is not None
                else None
            )
            if rec is None:
                out[i] = _zero_response(now, C.STATUS_CODE_NOT_FOUND)
                continue
            if rt == C.REQUEST_TYPE_READ:
                out[i] = self._ok(rec)
            elif rt == C.REQUEST_TYPE_UPDATE:
                if req.record.recipient != rec.recipient:
                    out[i] = _zero_response(now, C.STATUS_CODE_INVALID_RECIPIENT)
                else:
                    rec.payload = req.record.payload
                    rec.timestamp = now
                    out[i] = self._ok(rec)
            else:  # DELETE
                if req.record.msg_id == C.ZERO_MSG_ID:
                    del self.records[mid]  # mailbox entry already popped in A
                    out[i] = self._ok(rec)
                elif req.record.recipient != rec.recipient:
                    out[i] = _zero_response(now, C.STATUS_CODE_INVALID_RECIPIENT)
                else:
                    del self.records[mid]
                    deferred_c.append((i, rec.recipient, mid))
                    out[i] = self._ok(rec)

        # ---- phase C: mailbox finalization, slot order -----------------
        for _i, recipient, mid in deferred_c:
            self._remove_mailbox_entry(recipient, mid)

        return out  # type: ignore[return-value]

    # -- expiry sweep (README.md:86-98) ---------------------------------

    def expire(self, now: int, period: int | None = None) -> int:
        """Remove every record older than the expiry period. Returns count."""
        period = self.config.expiry_period if period is None else period
        if period <= 0:
            return 0
        dead = [mid for mid, rec in self.records.items() if now - rec.timestamp > period]
        for mid in dead:
            rec = self.records.pop(mid)
            self._remove_mailbox_entry(rec.recipient, mid)
        # the sweep is the one place drained mailboxes release their slot
        self.mailboxes = {r: box for r, box in self.mailboxes.items() if box}
        return len(dead)

    # -- introspection for tests ---------------------------------------

    def message_count(self) -> int:
        return len(self.records)

    def recipient_count(self) -> int:
        return len(self.mailboxes)
