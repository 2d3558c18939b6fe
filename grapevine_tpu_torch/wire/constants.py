"""Protocol constants for the grapevine wire format.

These pin the byte-level contract of the reference implementation:

- record geometry: 1024 bytes = id 16 | sender 32 | recipient 32 |
  timestamp 8 | payload 936  (reference README.md:132-136, types/src/lib.rs:150)
- request/status enums (reference grapevine.proto:44-55,178-197 and
  types/src/lib.rs:16-22,123-137)
- the challenge-signature signing context (reference types/src/lib.rs:13)
- per-recipient in-flight cap of 62 messages (reference README.md:78-80) —
  a compile-time constant in the reference; here a module constant that the
  engine config must honor.
"""

# --- Record geometry (bytes) ---------------------------------------------
import os as _os

MSG_ID_SIZE = 16
PUBKEY_SIZE = 32  # compressed ristretto point
TIMESTAMP_SIZE = 8  # u64 LE seconds since unix epoch
#: the reference's compile-time record-size option: 1024 (default) or
#: 2048 bytes (reference README.md:138-139 — "a compile time option to
#: configure this to 2048"). Same mechanism here: a process-wide
#: constant fixed before import (env GRAPEVINE_RECORD_SIZE); every
#: layout below derives from it, and mixed-size processes are
#: impossible by construction, exactly like the reference's rebuild.
RECORD_SIZE = int(_os.environ.get("GRAPEVINE_RECORD_SIZE", "1024"))
if RECORD_SIZE not in (1024, 2048):
    raise ValueError(
        f"GRAPEVINE_RECORD_SIZE must be 1024 or 2048, got {RECORD_SIZE}"
    )
PAYLOAD_SIZE = RECORD_SIZE - (MSG_ID_SIZE + 2 * PUBKEY_SIZE + TIMESTAMP_SIZE)
assert PAYLOAD_SIZE in (936, 1960)

SIGNATURE_SIZE = 64  # ristretto Schnorr signature (reference types/src/lib.rs:44-52)
CHALLENGE_SIZE = 32  # bytes drawn from the challenge RNG per request
CHALLENGE_SEED_SIZE = 32  # ChaCha20 seed returned by Auth (grapevine.proto:20-25)

# --- Signing context (reference types/src/lib.rs:13) ---------------------
GRAPEVINE_CHALLENGE_SIGNING_CONTEXT = b"grapevine-challenge"

# --- RequestType enum (reference grapevine.proto:44-55) ------------------
REQUEST_TYPE_INVALID = 0  # unused; proto requires a zero value
REQUEST_TYPE_CREATE = 1
REQUEST_TYPE_READ = 2
REQUEST_TYPE_UPDATE = 3
REQUEST_TYPE_DELETE = 4

# --- StatusCode enum (reference grapevine.proto:178-197) -----------------
STATUS_CODE_INVALID = 0  # unused; proto requires a zero value
STATUS_CODE_SUCCESS = 1
STATUS_CODE_NOT_FOUND = 2
STATUS_CODE_MESSAGE_ID_ALREADY_IN_USE = 3
STATUS_CODE_INVALID_RECIPIENT = 4
STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT = 5
STATUS_CODE_TOO_MANY_RECIPIENTS = 6
STATUS_CODE_TOO_MANY_MESSAGES = 7
STATUS_CODE_INTERNAL_ERROR = 8

# --- Capacity invariants (reference README.md:78-80) ---------------------
MAILBOX_CAP = 62  # max in-flight messages per recipient

# --- Fixed-layout (non-protobuf) encoded sizes ---------------------------
# The inner, channel-encrypted codec used by this framework is a raw fixed
# layout (see wire/records.py). Sizes are constant by construction.
REQUEST_RECORD_WIRE_SIZE = MSG_ID_SIZE + PUBKEY_SIZE + PAYLOAD_SIZE  # 984 @1KB
QUERY_REQUEST_WIRE_SIZE = 4 + PUBKEY_SIZE + SIGNATURE_SIZE + REQUEST_RECORD_WIRE_SIZE  # 1084 @1KB
QUERY_RESPONSE_WIRE_SIZE = RECORD_SIZE + 4  # 1028 @1KB

ZERO_MSG_ID = b"\x00" * MSG_ID_SIZE
ZERO_PUBKEY = b"\x00" * PUBKEY_SIZE
