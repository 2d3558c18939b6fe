"""The plain reference of the message bus: what every round must answer.

A dict model of the bus's documented semantics, written here in plain
Python with no obliviousness and no device, and importing nothing of the
program. A round is a batch of operations that commits phase-major, in
slot order:

- phase A: each CREATE's checks and its mailbox append (bus full, then
  too many recipients, then the mailbox cap), each zero-id READ's and
  DELETE's choice of the oldest message addressed to its auth identity,
  and each zero-id DELETE's pop of that message from the mailbox; all
  visible to later ops' phase A;
- phase B: each record insert, read, update and removal, visible to later
  ops' phase B;
- phase C: each by-id DELETE's mailbox removal, visible only to the next
  round; record slots freed by any DELETE are reusable only in the next
  round.

So a zero-id op whose chosen message an earlier slot deleted by id answers
NOT_FOUND, and a CREATE cannot take capacity that a DELETE of the same
round frees. A mailbox keeps its recipient's slot in the recipient table
after it drains (only an expiry sweep would free it; the benchmark runs
none). Failure answers carry an all-zero record stamped with the round's
clock.

Message ids are the server's to choose: where the model answers a CREATE
with SUCCESS, it takes the id the program returned (``issued``) and the
judge (:mod:`gvbench.judge`) holds that id to being nonzero and not live.
"""

from __future__ import annotations

from collections import deque

CREATE, READ, UPDATE, DELETE = 1, 2, 3, 4
SUCCESS = 1
NOT_FOUND = 2
INVALID_RECIPIENT = 4
TOO_MANY_MESSAGES_FOR_RECIPIENT = 5
TOO_MANY_RECIPIENTS = 6
TOO_MANY_MESSAGES = 7

ZERO_ID = bytes(16)
ZERO_KEY = bytes(32)


class Bus:
    """The bus's state: records by id and one FIFO mailbox a recipient."""

    def __init__(self, max_messages: int, max_recipients: int, mailbox_cap: int,
                 payload_size: int):
        self.max_messages = max_messages
        self.max_recipients = max_recipients
        self.mailbox_cap = mailbox_cap
        self.zero_payload = bytes(payload_size)
        #: msg_id -> [sender, recipient, timestamp, payload]
        self.records: dict[bytes, list] = {}
        #: recipient -> ids addressed to it, oldest first
        self.boxes: dict[bytes, deque] = {}

    def failure(self, status: int, now: int) -> tuple:
        return (status, ZERO_ID, ZERO_KEY, ZERO_KEY, now, self.zero_payload)

    @staticmethod
    def answer(mid: bytes, rec: list) -> tuple:
        return (SUCCESS, mid, rec[0], rec[1], rec[2], rec[3])

    @staticmethod
    def head(box: deque) -> bytes:
        """The message a zero-id READ chooses: the oldest."""
        return box[0]

    @staticmethod
    def pop(box: deque) -> bytes:
        """The message a zero-id DELETE takes out: the oldest."""
        return box.popleft()

    def round(self, ops: list, now: int, issued: list) -> list:
        """Answer one round. ``ops[j]`` is ``(kind, auth, msg_id, recipient,
        payload)``; ``issued[j]`` is the id the server gave slot ``j``'s
        CREATE (used only where this model answers SUCCESS). Returns one
        ``(status, msg_id, sender, recipient, timestamp, payload)`` a slot."""
        n = len(ops)
        out: list = [None] * n
        chosen: list = [None] * n
        created: list = [None] * n
        free_at_start = self.max_messages - len(self.records)
        creates = 0
        # phase A
        for j, (kind, auth, mid, rcp, _pl) in enumerate(ops):
            if kind == CREATE:
                box = self.boxes.get(rcp)
                if rcp == ZERO_KEY:
                    out[j] = self.failure(INVALID_RECIPIENT, now)
                elif free_at_start - creates <= 0:
                    out[j] = self.failure(TOO_MANY_MESSAGES, now)
                elif box is None and len(self.boxes) >= self.max_recipients:
                    out[j] = self.failure(TOO_MANY_RECIPIENTS, now)
                elif box is not None and len(box) >= self.mailbox_cap:
                    out[j] = self.failure(TOO_MANY_MESSAGES_FOR_RECIPIENT, now)
                else:
                    creates += 1
                    created[j] = issued[j]
                    self.boxes.setdefault(rcp, deque()).append(issued[j])
            elif mid == ZERO_ID:
                box = self.boxes.get(auth)
                if box:
                    chosen[j] = self.pop(box) if kind == DELETE else self.head(box)
        # phase B
        deferred = []
        for j, (kind, auth, mid, rcp, pl) in enumerate(ops):
            if out[j] is not None:
                continue
            if kind == CREATE:
                rec = [auth, rcp, now, pl]
                self.records[created[j]] = rec
                out[j] = self.answer(created[j], rec)
                continue
            zero = mid == ZERO_ID
            key = chosen[j] if zero else mid
            rec = self.records.get(key) if key is not None else None
            if rec is None or auth not in (rec[0], rec[1]):
                out[j] = self.failure(NOT_FOUND, now)
            elif kind == READ:
                out[j] = self.answer(key, rec)
            elif not zero and rcp != rec[1]:
                out[j] = self.failure(INVALID_RECIPIENT, now)
            elif kind == UPDATE:
                rec[2], rec[3] = now, pl
                out[j] = self.answer(key, rec)
            else:
                del self.records[key]
                out[j] = self.answer(key, rec)
                if not zero:
                    deferred.append((rec[1], key))
        # phase C
        for rcp, key in deferred:
            box = self.boxes.get(rcp)
            if box is not None and key in box:
                box.remove(key)
        return out
