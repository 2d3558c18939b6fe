"""Minimal protobuf wire codec for the grapevine message set (a copy of
``grapevine_tpu/wire/protowire.py``: the same bytes for the same message).

The reference keeps two parallel type stacks — prost structs
(types/src/lib.rs) and protobuf-codegen structs (api/ crate) — and tests
that they agree byte-for-byte (reference api/tests/grapevine_types.rs).
This module is our second stack: a hand-rolled encoder/decoder emitting
protobuf wire format with the reference's exact field numbers and types
(reference grapevine.proto:123-176), kept deliberately tiny so there is no
protoc build dependency. Conformance tests assert it round-trips against
the fixed-layout codec in :mod:`grapevine_tpu_torch.wire.records` and that valid
messages encode at constant size.

Encoding follows prost emission rules:
- scalar fields are omitted when zero; bytes fields are omitted when empty
  (valid grapevine messages always carry full-length bytes and the engine
  guarantees a nonzero response timestamp, so sizes stay constant);
- ``request_type`` / ``status_code`` are fixed32, not varint enums — the
  reference does this explicitly "to avoid information leakage from
  protobuf compression" (reference grapevine.proto:40-43);
- ``timestamp`` is fixed64 for the same reason;
- fields are written in ascending field-number order.

Also defines the outer transport messages carried on the (unencrypted)
gRPC surface, mirroring the attest message shapes the reference imports
from mc-attest-api (reference grapevine.proto:8,10-36): ``AuthMessage``,
``Message`` (aad / channel_id / data) and ``AuthMessageWithChallengeSeed``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import records as R

_WT_VARINT = 0
_WT_FIXED64 = 1
_WT_LEN = 2
_WT_FIXED32 = 5


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if shift >= 64:
            raise ValueError("varint too long")
        if pos >= len(data):
            raise ValueError("truncated varint")
        byte = data[pos]
        pos += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            if result >= 1 << 64:
                raise ValueError("varint exceeds u64")
            return result, pos
        shift += 7


def _tag(field_no: int, wire_type: int) -> bytes:
    return _varint((field_no << 3) | wire_type)


def _emit_bytes(field_no: int, value: bytes) -> bytes:
    if not value:
        return b""
    return _tag(field_no, _WT_LEN) + _varint(len(value)) + value


def _emit_fixed32(field_no: int, value: int) -> bytes:
    if value == 0:
        return b""
    return _tag(field_no, _WT_FIXED32) + int(value).to_bytes(4, "little")


def _emit_fixed64(field_no: int, value: int) -> bytes:
    if value == 0:
        return b""
    return _tag(field_no, _WT_FIXED64) + int(value).to_bytes(8, "little")


def _emit_message(field_no: int, payload: bytes) -> bytes:
    # required submessages are always emitted, even when empty
    return _tag(field_no, _WT_LEN) + _varint(len(payload)) + payload


def _parse_fields(data: bytes) -> dict[int, tuple[int, object]]:
    """Parse a message into {field_no: (wire_type, last value)}.

    Unknown field numbers are tolerated (skipped over but retained), matching
    prost; wire-type checking against the schema happens in the typed
    getters below, so a type-confused field is rejected rather than coerced.
    """
    fields: dict[int, tuple[int, object]] = {}
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        field_no, wire_type = key >> 3, key & 7
        if field_no == 0:
            raise ValueError("field number 0 is invalid")
        if wire_type == _WT_VARINT:
            value, pos = _read_varint(data, pos)
        elif wire_type == _WT_FIXED64:
            if pos + 8 > len(data):
                raise ValueError("truncated fixed64")
            value = int.from_bytes(data[pos : pos + 8], "little")
            pos += 8
        elif wire_type == _WT_FIXED32:
            if pos + 4 > len(data):
                raise ValueError("truncated fixed32")
            value = int.from_bytes(data[pos : pos + 4], "little")
            pos += 4
        elif wire_type == _WT_LEN:
            length, pos = _read_varint(data, pos)
            if pos + length > len(data):
                raise ValueError("truncated length-delimited field")
            value = data[pos : pos + length]
            pos += length
        else:
            raise ValueError(f"unsupported wire type {wire_type}")
        fields[field_no] = (wire_type, value)
    return fields


def _get_typed(
    fields: dict[int, tuple[int, object]], field_no: int, wire_type: int, default
):
    if field_no not in fields:
        return default
    got_type, value = fields[field_no]
    if got_type != wire_type:
        raise ValueError(
            f"field {field_no}: expected wire type {wire_type}, got {got_type}"
        )
    return value


def _get_bytes(fields, field_no: int) -> bytes:
    return bytes(_get_typed(fields, field_no, _WT_LEN, b""))


def _get_fixed32(fields, field_no: int) -> int:
    return int(_get_typed(fields, field_no, _WT_FIXED32, 0))


def _get_fixed64(fields, field_no: int) -> int:
    return int(_get_typed(fields, field_no, _WT_FIXED64, 0))


# --- grapevine.QueryRequest / RequestRecord / Record / QueryResponse -----


def encode_request_record(r: R.RequestRecord) -> bytes:
    r.validate()
    return (
        _emit_bytes(1, r.msg_id) + _emit_bytes(2, r.recipient) + _emit_bytes(3, r.payload)
    )


def decode_request_record(data: bytes) -> R.RequestRecord:
    f = _parse_fields(data)
    return R.RequestRecord(
        msg_id=_get_bytes(f, 1),
        recipient=_get_bytes(f, 2),
        payload=_get_bytes(f, 3),
    ).validate()


def encode_record(r: R.Record) -> bytes:
    r.validate()
    return (
        _emit_bytes(1, r.msg_id)
        + _emit_bytes(2, r.sender)
        + _emit_bytes(3, r.recipient)
        + _emit_fixed64(4, r.timestamp)
        + _emit_bytes(5, r.payload)
    )


def decode_record(data: bytes) -> R.Record:
    f = _parse_fields(data)
    return R.Record(
        msg_id=_get_bytes(f, 1),
        sender=_get_bytes(f, 2),
        recipient=_get_bytes(f, 3),
        timestamp=_get_fixed64(f, 4),
        payload=_get_bytes(f, 5),
    ).validate()


# Constant encoded sizes for fully-populated messages; enforced at encode
# time because ciphertext length leaks whatever plaintext length leaks
# (reference grapevine.proto:40-43). Derivation: every bytes field at full
# length + fixed scalars emitted (nonzero).
QUERY_REQUEST_PROTO_SIZE = 1099
QUERY_RESPONSE_PROTO_SIZE = 1042


def encode_query_request(q: R.QueryRequest) -> bytes:
    q.validate()
    if q.request_type == 0:
        raise ValueError("request_type must be nonzero (constant-size invariant)")
    out = (
        _emit_fixed32(1, q.request_type)
        + _emit_bytes(2, q.auth_identity)
        + _emit_bytes(3, q.auth_signature)
        + _emit_message(4, encode_request_record(q.record))
    )
    if len(out) != QUERY_REQUEST_PROTO_SIZE:
        raise AssertionError("QueryRequest proto encoding is not constant-size")
    return out


def decode_query_request(data: bytes) -> R.QueryRequest:
    f = _parse_fields(data)
    if 4 not in f:
        raise ValueError("QueryRequest.record is required")
    return R.QueryRequest(
        request_type=_get_fixed32(f, 1),
        auth_identity=_get_bytes(f, 2),
        auth_signature=_get_bytes(f, 3),
        record=decode_request_record(_get_bytes(f, 4)),
    ).validate()


def encode_query_response(q: R.QueryResponse) -> bytes:
    q.validate()
    if q.record.timestamp == 0:
        raise ValueError("response timestamp must be nonzero (constant-size invariant)")
    if q.status_code == 0:
        raise ValueError("status_code must be nonzero (constant-size invariant)")
    out = _emit_message(1, encode_record(q.record)) + _emit_fixed32(2, q.status_code)
    if len(out) != QUERY_RESPONSE_PROTO_SIZE:
        raise AssertionError("QueryResponse proto encoding is not constant-size")
    return out


def decode_query_response(data: bytes) -> R.QueryResponse:
    f = _parse_fields(data)
    if 1 not in f:
        raise ValueError("QueryResponse.record is required")
    return R.QueryResponse(
        record=decode_record(_get_bytes(f, 1)),
        status_code=_get_fixed32(f, 2),
    ).validate()


# --- outer transport messages (attest-shaped) ----------------------------


@dataclass
class AuthMessage:
    """Attested key-exchange handshake blob (shape of attest.AuthMessage)."""

    data: bytes = b""


@dataclass
class EnvelopeMessage:
    """An encrypted envelope on an established channel (shape of attest.Message)."""

    aad: bytes = b""
    channel_id: bytes = b""
    data: bytes = b""


@dataclass
class AuthMessageWithChallengeSeed:
    """Auth response: handshake blob + encrypted 32-byte challenge-RNG seed.

    Mirrors reference grapevine.proto:26-36; ``encrypted_challenge_seed`` is
    only the ciphertext (the channel id is implied by the connection and the
    aad is empty).
    """

    auth_message: AuthMessage = field(default_factory=AuthMessage)
    encrypted_challenge_seed: bytes = b""


def encode_auth_message(m: AuthMessage) -> bytes:
    return _emit_bytes(1, m.data)


def decode_auth_message(data: bytes) -> AuthMessage:
    f = _parse_fields(data)
    return AuthMessage(data=_get_bytes(f, 1))


def encode_envelope(m: EnvelopeMessage) -> bytes:
    return _emit_bytes(1, m.aad) + _emit_bytes(2, m.channel_id) + _emit_bytes(3, m.data)


def decode_envelope(data: bytes) -> EnvelopeMessage:
    f = _parse_fields(data)
    return EnvelopeMessage(
        aad=_get_bytes(f, 1),
        channel_id=_get_bytes(f, 2),
        data=_get_bytes(f, 3),
    )


def encode_auth_with_seed(m: AuthMessageWithChallengeSeed) -> bytes:
    return _emit_message(1, encode_auth_message(m.auth_message)) + _emit_bytes(
        2, m.encrypted_challenge_seed
    )


def decode_auth_with_seed(data: bytes) -> AuthMessageWithChallengeSeed:
    f = _parse_fields(data)
    return AuthMessageWithChallengeSeed(
        auth_message=decode_auth_message(_get_bytes(f, 1)),
        encrypted_challenge_seed=_get_bytes(f, 2),
    )
