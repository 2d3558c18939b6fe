"""Typed message records and the fixed-layout channel codec.

Mirrors the reference's enclave-compatible type stack
(``mc-grapevine-types``, reference types/src/lib.rs:27-120): ``QueryRequest``
carries an auth identity + challenge signature + a ``RequestRecord``;
``QueryResponse`` carries a full ``Record`` + status code. Every byte field
has a mandatory fixed length — a *constant wire size* is a security
requirement, because the encrypted channel otherwise leaks request/response
content through ciphertext length (reference grapevine.proto:40-43 and
api/tests/grapevine_types.rs:21-31).

Unlike the reference, which keeps protobuf (prost) encoding inside the
encrypted channel, this framework uses a raw fixed layout for the inner
codec (constant size by construction, and directly memcpy-able into the
device batch arrays). A protobuf-wire codec compatible with the reference's
field numbering lives in :mod:`grapevine_tpu.wire.protowire`; conformance
tests assert the two stacks round-trip and both encode at constant size,
the direct analog of the reference's two-type-stack tests.

Fixed layouts (little-endian scalars):

- ``RequestRecord``: msg_id(16) | recipient(32) | payload — sizes derive
  from wire/constants.py (984 bytes at the default 1024-byte record;
  GRAPEVINE_RECORD_SIZE=2048 selects the reference's 2 KB option)
- ``Record``:        msg_id(16) | sender(32) | recipient(32) |
  timestamp(8) | payload(C.PAYLOAD_SIZE)                 = C.RECORD_SIZE
  (field order matches the reference's table, README.md:132-136)
- ``QueryRequest``:  request_type(4) | auth_identity(32) |
  auth_signature(64) | record(984)                                      = 1084
- ``QueryResponse``: record(1024) | status_code(4)                      = 1028
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from . import constants as C


def _check_len(name: str, value: bytes, expected: int) -> bytes:
    if not isinstance(value, (bytes, bytearray, memoryview)):
        raise TypeError(f"{name} must be bytes, got {type(value).__name__}")
    value = bytes(value)
    if len(value) != expected:
        raise ValueError(f"{name} must be exactly {expected} bytes, got {len(value)}")
    return value


@dataclass
class RequestRecord:
    """The client-suppliable subset of a record (reference types/src/lib.rs:63-78).

    Sender and timestamp are always server-assigned, so they do not appear
    here. All fields must be fully populated (full length) even for request
    types that ignore them — constant wire size is mandatory.
    """

    msg_id: bytes = C.ZERO_MSG_ID
    recipient: bytes = C.ZERO_PUBKEY
    payload: bytes = b"\x00" * C.PAYLOAD_SIZE

    def validate(self) -> "RequestRecord":
        self.msg_id = _check_len("msg_id", self.msg_id, C.MSG_ID_SIZE)
        self.recipient = _check_len("recipient", self.recipient, C.PUBKEY_SIZE)
        self.payload = _check_len("payload", self.payload, C.PAYLOAD_SIZE)
        return self

    def pack(self) -> bytes:
        self.validate()
        return self.msg_id + self.recipient + self.payload

    @classmethod
    def unpack(cls, data: bytes) -> "RequestRecord":
        data = _check_len("RequestRecord", data, C.REQUEST_RECORD_WIRE_SIZE)
        return cls(
            msg_id=data[:16],
            recipient=data[16:48],
            payload=data[48:],
        ).validate()


@dataclass
class Record:
    """A message in the bus: the unit that moves in and out of ORAM.

    Exactly C.RECORD_SIZE bytes packed (reference README.md:132-139); the payload is
    opaque to the service (reference README.md:146-157).
    """

    msg_id: bytes = C.ZERO_MSG_ID
    sender: bytes = C.ZERO_PUBKEY
    recipient: bytes = C.ZERO_PUBKEY
    timestamp: int = 0
    payload: bytes = b"\x00" * C.PAYLOAD_SIZE

    def validate(self) -> "Record":
        self.msg_id = _check_len("msg_id", self.msg_id, C.MSG_ID_SIZE)
        self.sender = _check_len("sender", self.sender, C.PUBKEY_SIZE)
        self.recipient = _check_len("recipient", self.recipient, C.PUBKEY_SIZE)
        self.payload = _check_len("payload", self.payload, C.PAYLOAD_SIZE)
        if not (0 <= int(self.timestamp) < 1 << 64):
            raise ValueError("timestamp must fit in u64")
        self.timestamp = int(self.timestamp)
        return self

    def pack(self) -> bytes:
        self.validate()
        return (
            self.msg_id
            + self.sender
            + self.recipient
            + struct.pack("<Q", self.timestamp)
            + self.payload
        )

    @classmethod
    def unpack(cls, data: bytes) -> "Record":
        data = _check_len("Record", data, C.RECORD_SIZE)
        return cls(
            msg_id=data[:16],
            sender=data[16:48],
            recipient=data[48:80],
            timestamp=struct.unpack("<Q", data[80:88])[0],
            payload=data[88:],
        ).validate()


@dataclass
class QueryRequest:
    """An (inner, to-be-encrypted) CRUD request (reference types/src/lib.rs:27-59)."""

    request_type: int = C.REQUEST_TYPE_INVALID
    auth_identity: bytes = C.ZERO_PUBKEY
    auth_signature: bytes = b"\x00" * C.SIGNATURE_SIZE
    record: RequestRecord = field(default_factory=RequestRecord)

    def validate(self) -> "QueryRequest":
        if not (0 <= int(self.request_type) < 1 << 32):
            raise ValueError("request_type must fit in u32")
        self.request_type = int(self.request_type)
        self.auth_identity = _check_len("auth_identity", self.auth_identity, C.PUBKEY_SIZE)
        self.auth_signature = _check_len(
            "auth_signature", self.auth_signature, C.SIGNATURE_SIZE
        )
        self.record.validate()
        return self

    def pack(self) -> bytes:
        self.validate()
        return (
            struct.pack("<I", self.request_type)
            + self.auth_identity
            + self.auth_signature
            + self.record.pack()
        )

    @classmethod
    def unpack(cls, data: bytes) -> "QueryRequest":
        data = _check_len("QueryRequest", data, C.QUERY_REQUEST_WIRE_SIZE)
        return cls(
            request_type=struct.unpack("<I", data[:4])[0],
            auth_identity=data[4:36],
            auth_signature=data[36:100],
            record=RequestRecord.unpack(data[100:]),
        ).validate()


@dataclass
class QueryResponse:
    """An (inner, to-be-encrypted) response (reference types/src/lib.rs:111-120).

    Always carries one full Record + a status code regardless of the
    operation or its outcome (reference grapevine.proto:170-176); on
    failure the record is zero-filled but full length, and the engine still
    stamps a real timestamp so that even the protobuf-wire encoding stays
    constant-size (a zero fixed64 would be elided by prost rules).
    """

    record: Record = field(default_factory=Record)
    status_code: int = C.STATUS_CODE_INVALID

    def validate(self) -> "QueryResponse":
        if not (0 <= int(self.status_code) < 1 << 32):
            raise ValueError("status_code must fit in u32")
        self.status_code = int(self.status_code)
        self.record.validate()
        return self

    def pack(self) -> bytes:
        self.validate()
        return self.record.pack() + struct.pack("<I", self.status_code)

    @classmethod
    def unpack(cls, data: bytes) -> "QueryResponse":
        data = _check_len("QueryResponse", data, C.QUERY_RESPONSE_WIRE_SIZE)
        return cls(
            record=Record.unpack(data[: C.RECORD_SIZE]),
            status_code=struct.unpack("<I", data[C.RECORD_SIZE :])[0],
        ).validate()
