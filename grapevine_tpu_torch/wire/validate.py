"""Wire-level request validation (copy of ``grapevine_tpu/wire/validate.py``).

The reference's fail-fast gRPC errors (grapevine.proto:57-64,95) are
raised on the host before anything reaches the device.
"""

from __future__ import annotations

from . import constants as C
from .records import QueryRequest


class HardProtocolError(Exception):
    """API misuse that fails fast at the transport layer, not via status code.

    Mirrors the reference's hard gRPC errors: zero auth identity
    (grapevine.proto:60-64), UPDATE with a zero msg_id (grapevine.proto:95).
    """


def validate_request(req: QueryRequest) -> None:
    """Fail-fast checks (reference grapevine.proto:57-64,95)."""
    req.validate()
    if req.auth_identity == C.ZERO_PUBKEY:
        raise HardProtocolError("auth identity must be nonzero")
    if not (1 <= req.request_type <= 4):
        raise HardProtocolError(f"invalid request type {req.request_type}")
    if req.request_type == C.REQUEST_TYPE_UPDATE and req.record.msg_id == C.ZERO_MSG_ID:
        raise HardProtocolError("UPDATE with zero msg_id")
