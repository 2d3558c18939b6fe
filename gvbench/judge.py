"""The comparison that decides ``correct``: every answer the program gave,
held against :class:`gvbench.reference.Bus` replaying the same rounds.

A round's answers are kept as :class:`Answers`, each field of every slot
packed into one byte string. The reference takes from them only the ids
the server chose for CREATEs it answers with SUCCESS, and an id counts as
wrong where it is zero, already live, or given twice in one round.
"""

from __future__ import annotations

from array import array

from .reference import CREATE, SUCCESS, ZERO_ID, Bus

FIELDS = ("status", "msg_id", "sender", "recipient", "timestamp", "payload")


class Answers:
    """One round's answers, one byte string a field: a run keeps hundreds
    of rounds of them, which hold nothing the garbage collector walks."""

    __slots__ = ("n", "payload_size", "status", "msg_id", "sender", "recipient",
                 "timestamp", "payload")

    def __init__(self, status, msg_id, sender, recipient, timestamp, payload):
        self.n = len(status)
        self.payload_size = len(payload[0]) if payload else 0
        self.status = array("I", status).tobytes()
        self.msg_id = b"".join(msg_id)
        self.sender = b"".join(sender)
        self.recipient = b"".join(recipient)
        self.timestamp = array("Q", timestamp).tobytes()
        self.payload = b"".join(payload)

    @classmethod
    def of_rows(cls, rows: list) -> "Answers":
        return cls(*(list(col) for col in zip(*rows)))

    def status_at(self, j: int) -> int:
        return int.from_bytes(self.status[4 * j:4 * j + 4], "little")

    def msg_id_at(self, j: int) -> bytes:
        return self.msg_id[16 * j:16 * j + 16]

    def row(self, j: int) -> tuple:
        p = self.payload_size
        return (self.status_at(j), self.msg_id_at(j), self.sender[32 * j:32 * j + 32],
                self.recipient[32 * j:32 * j + 32],
                int.from_bytes(self.timestamp[8 * j:8 * j + 8], "little"),
                self.payload[p * j:p * j + p])

    def same(self, other: "Answers") -> bool:
        return all(getattr(self, f) == getattr(other, f) for f in FIELDS)


class Judge:
    def __init__(self, bus: Bus):
        self.bus = bus
        self.wrong = 0
        self.judged = 0
        self.examples: list[str] = []
        self._fresh = 0

    def _fresh_id(self) -> bytes:
        """An id no server can have issued, so a model that could not take
        the program's id keeps going."""
        self._fresh += 1
        return b"\xff" * 8 + self._fresh.to_bytes(8, "little")

    def round(self, label: str, ops: list, now: int, got: Answers) -> int:
        """Judge one round; returns the count of wrong answers in it."""
        issued: list = [None] * len(ops)
        seen = set()
        bad_ids = set()
        for j, op in enumerate(ops):
            if op[0] != CREATE:
                continue
            mid = got.msg_id_at(j)
            if mid == ZERO_ID or mid in self.bus.records or mid in seen:
                bad_ids.add(j)
                mid = self._fresh_id()
            seen.add(mid)
            issued[j] = mid
        want = self.bus.round(ops, now, issued)
        self.judged += len(ops)
        bad_ids = {j for j in bad_ids if want[j][0] == SUCCESS}
        if not bad_ids and got.n == len(want) and got.same(Answers.of_rows(want)):
            return 0
        wrong = 0
        for j, w in enumerate(want):
            g = got.row(j) if j < got.n else (None,) * len(FIELDS)
            if g != w or j in bad_ids:
                wrong += 1
                if len(self.examples) < 5:
                    diff = [f for f, a, b in zip(FIELDS, g, w) if a != b] or ["msg_id reuse"]
                    self.examples.append(f"{label} slot {j} kind {ops[j][0]}: {','.join(diff)} "
                                         f"got status {g[0]} want {w[0]}")
        self.wrong += wrong
        return wrong
