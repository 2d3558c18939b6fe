"""Directed same-key op orderings in the port's phase-major engine (the
JAX package's ``tests/test_same_key_ordering.py`` is the model, case for
case, with its seeds and geometry).

The reference's round-2 verdict found a silent message loss: in one
batch, a zero-id op by recipient X *before* the first CREATE to X (X's
mailbox block absent) made the create return SUCCESS and insert the
record but never append the mailbox entry, because the claimed key slot
was gathered from the group's first op instead of its first CREATE
(``engine/vphases.py``). The randomized suites rarely draw that
ordering, so this file enumerates same-key orderings of zero-id READ,
zero-id DELETE and CREATE on an absent mailbox and on one holding 1-2
messages, and holds every response of the port's engine (on the CPU)
against the port's ``testing/reference.py:ReferenceEngine`` with the
engine's msg_ids forced into it (``testing/soak.py:run_pair``, shared
with the soaks and ``chip_smoke.py`` phase 23b), then drains. The port's oracle is
itself held against the JAX package's in ``tests/test_torch_oracle.py``.
"""


import random

import pytest

from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import GrapevineEngine as _Engine
from grapevine_tpu_torch.testing.reference import ReferenceEngine
from grapevine_tpu_torch.testing.soak import HAZARD_PERMS, NOW, key, req, run_pair
from grapevine_tpu_torch.wire import constants as C
from _torch_threads import one_torch_thread  # noqa: F401


def GrapevineEngine(cfg, seed=0):
    """The port's facade on the CPU."""
    return _Engine(cfg, seed=seed, device="cpu")


CFG = GrapevineConfig(bucket_cipher_rounds=0,
    max_messages=64,
    max_recipients=8,
    mailbox_cap=4,
    batch_size=8,
    stash_size=96,
)


def test_zero_read_before_create_on_absent_mailbox():
    """The round-2 verdict reproduction: batch [zero-id READ by X,
    CREATE→X] on a fresh engine, then a follow-up zero-id READ by X must
    return SUCCESS with the created record (not NOT_FOUND)."""
    engine = GrapevineEngine(CFG, seed=3)
    oracle = ReferenceEngine(config=CFG, rng=random.Random(99))
    x, s = key(1), key(2)

    batch = [
        req(C.REQUEST_TYPE_READ, x),  # zero-id: "next message for X"
        req(C.REQUEST_TYPE_CREATE, s, recipient=x, tag=7),
    ]
    dev = run_pair(engine, oracle, batch, NOW)
    assert dev[1].status_code == C.STATUS_CODE_SUCCESS

    follow = run_pair(engine, oracle, [req(C.REQUEST_TYPE_READ, x)], NOW + 1)
    assert follow[0].status_code == C.STATUS_CODE_SUCCESS
    assert follow[0].record.msg_id == dev[1].record.msg_id
    assert follow[0].record.payload == bytes([7]) * C.PAYLOAD_SIZE


def _ops_for(kind, x, s, tag):
    """An op on recipient-X's mailbox group, by kind tag."""
    if kind == "create":
        return req(C.REQUEST_TYPE_CREATE, s, recipient=x, tag=tag)
    if kind == "zread":
        return req(C.REQUEST_TYPE_READ, x)
    if kind == "zdel":
        return req(C.REQUEST_TYPE_DELETE, x)
    raise ValueError(kind)


@pytest.mark.parametrize("preexisting", [0, 1, 2])
@pytest.mark.parametrize("perm", HAZARD_PERMS)
def test_same_key_order_permutations(perm, preexisting):
    """Every ordering of {zero-id read, zero-id delete, create} on one
    recipient within a batch must match the oracle, with the mailbox
    absent (preexisting=0) or present with 1-2 messages, and must leave
    a drainable state (follow-up zero-id reads agree too)."""
    engine = GrapevineEngine(CFG, seed=11)
    oracle = ReferenceEngine(config=CFG, rng=random.Random(42))
    x, s = key(1), key(2)

    t = NOW
    if preexisting:
        setup = [
            req(C.REQUEST_TYPE_CREATE, s, recipient=x, tag=100 + i)
            for i in range(preexisting)
        ]
        run_pair(engine, oracle, setup, t)
        t += 1

    batch = [_ops_for(kind, x, s, 10 + i) for i, kind in enumerate(perm)]
    run_pair(engine, oracle, batch, t)

    # drain: the mailbox contents after the hazard batch must agree
    for i in range(preexisting + len(perm) + 1):
        t += 1
        run_pair(engine, oracle, [req(C.REQUEST_TYPE_READ, x)], t)
        run_pair(engine, oracle, [req(C.REQUEST_TYPE_DELETE, x)], t)


def test_zero_ops_by_two_recipients_interleaved():
    """Two recipient groups sharing a batch, each with a zero-id op
    before its first create; neither group's claim may be lost."""
    engine = GrapevineEngine(CFG, seed=5)
    oracle = ReferenceEngine(config=CFG, rng=random.Random(7))
    x, y, s = key(1), key(3), key(2)
    batch = [
        req(C.REQUEST_TYPE_READ, x),
        req(C.REQUEST_TYPE_DELETE, y),
        req(C.REQUEST_TYPE_CREATE, s, recipient=y, tag=1),
        req(C.REQUEST_TYPE_CREATE, s, recipient=x, tag=2),
    ]
    run_pair(engine, oracle, batch, NOW)
    for ident, tag in ((x, 2), (y, 1)):
        resp = run_pair(engine, oracle, [req(C.REQUEST_TYPE_READ, ident)], NOW + 1)
        assert resp[0].status_code == C.STATUS_CODE_SUCCESS
        assert resp[0].record.payload == bytes([tag]) * C.PAYLOAD_SIZE
