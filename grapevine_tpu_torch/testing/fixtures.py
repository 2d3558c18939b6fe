"""Seeded random fixtures for wire types (the port's own copy of
``grapevine_tpu/testing/fixtures.py``, on the port's ``wire``).

Analog of the reference's ``from-random`` feature
(reference types/src/lib.rs:140-186): deterministic random instances of
every message type, with the same draw conventions (payload fixed at 936
bytes, request_type in 1..=4, status_code in 1..=9) and of the reference's
seeded-RNG test helpers (``get_seeded_rng`` / ``run_with_several_seeds``,
reference api/tests/grapevine_types.rs:8-9).
"""

from __future__ import annotations

import random
from typing import Callable

from ..wire import constants as C
from ..wire.records import QueryRequest, QueryResponse, Record, RequestRecord

DEFAULT_SEED = 7


def get_seeded_rng(seed: int = DEFAULT_SEED) -> random.Random:
    return random.Random(seed)


def run_with_several_seeds(func: Callable[[random.Random], None], n_seeds: int = 8) -> None:
    for seed in range(n_seeds):
        func(random.Random(seed))


def random_request_record(rng: random.Random) -> RequestRecord:
    return RequestRecord(
        msg_id=rng.randbytes(C.MSG_ID_SIZE),
        recipient=rng.randbytes(C.PUBKEY_SIZE),
        payload=rng.randbytes(C.PAYLOAD_SIZE),
    )


def random_record(rng: random.Random) -> Record:
    return Record(
        msg_id=rng.randbytes(C.MSG_ID_SIZE),
        sender=rng.randbytes(C.PUBKEY_SIZE),
        recipient=rng.randbytes(C.PUBKEY_SIZE),
        timestamp=rng.getrandbits(64) | 1,  # engine guarantees nonzero timestamps
        payload=rng.randbytes(C.PAYLOAD_SIZE),
    )


def random_query_request(rng: random.Random) -> QueryRequest:
    return QueryRequest(
        request_type=rng.randrange(4) + 1,
        auth_identity=rng.randbytes(C.PUBKEY_SIZE),
        auth_signature=rng.randbytes(C.SIGNATURE_SIZE),
        record=random_request_record(rng),
    )


def random_query_response(rng: random.Random) -> QueryResponse:
    return QueryResponse(
        record=random_record(rng),
        status_code=rng.randrange(9) + 1,
    )
