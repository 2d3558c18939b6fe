"""The port's op-major engine (``GrapevineConfig(commit="op")``) vs the
port's own CPU oracle (``grapevine_tpu_torch/testing/reference.py``):
result equality on random op sequences, R/U/D transcript
indistinguishability, expiry, and capacity reuse — the seven cases of the
JAX package's ``tests/test_engine.py``, on the CPU. Then one durable
facade: its journal replays through ``engine_step`` (never the
phase-major ``engine_round_step``) to the live engine's exact state and
generator state.
"""

import random
import shutil

import numpy as np
import torch

from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
from grapevine_tpu_torch.engine import batcher
from grapevine_tpu_torch.engine.batcher import GrapevineEngine as _Engine
from grapevine_tpu_torch.engine.convert import first_difference, to_numpy
from grapevine_tpu_torch.engine.step import engine_step
from grapevine_tpu_torch.testing.reference import ReferenceEngine
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

NOW = 1_700_000_000


def GrapevineEngine(cfg, seed=0, **kw):
    """The port's facade on the CPU."""
    return _Engine(cfg, seed=seed, device="cpu", **kw)


SMALL = GrapevineConfig(bucket_cipher_rounds=0,
    max_messages=64,
    max_recipients=8,
    mailbox_cap=4,
    batch_size=8,
    stash_size=64,
    commit="op",
)


def key(n: int) -> bytes:
    return bytes([n, n ^ 0x5A]) + b"\x01" * 30


def req(rt, auth, msg_id=C.ZERO_MSG_ID, recipient=C.ZERO_PUBKEY, pl=None, tag=0):
    return QueryRequest(
        request_type=rt,
        auth_identity=auth,
        auth_signature=b"\x01" * C.SIGNATURE_SIZE,
        record=RequestRecord(
            msg_id=msg_id,
            recipient=recipient,
            payload=pl if pl is not None else bytes([tag & 0xFF]) * C.PAYLOAD_SIZE,
        ),
    )


def assert_responses_equal(dev, ora, ctx=""):
    assert dev.status_code == ora.status_code, f"{ctx}: status {dev.status_code} != {ora.status_code}"
    assert dev.record.msg_id == ora.record.msg_id, f"{ctx}: id"
    assert dev.record.sender == ora.record.sender, f"{ctx}: sender"
    assert dev.record.recipient == ora.record.recipient, f"{ctx}: recipient"
    assert dev.record.payload == ora.record.payload, f"{ctx}: payload"
    assert dev.record.timestamp == ora.record.timestamp, f"{ctx}: ts"


def test_engine_matches_oracle_random_ops():
    """~200 random CRUD ops, engine and oracle must agree on everything."""
    engine = GrapevineEngine(SMALL, seed=1)
    oracle = ReferenceEngine(config=SMALL, rng=random.Random(99))
    rng = random.Random(42)
    idents = [key(i + 1) for i in range(6)]
    live_ids: list[tuple[bytes, bytes, bytes]] = []  # (msg_id, sender, recipient)

    t = NOW
    for step_no in range(40):
        t += rng.randrange(3)
        n_ops = rng.randrange(1, SMALL.batch_size + 1)
        reqs = []
        for _ in range(n_ops):
            c = rng.random()
            if c < 0.4 or not live_ids:
                sender, recip = rng.choice(idents), rng.choice(idents)
                reqs.append(req(C.REQUEST_TYPE_CREATE, sender, recipient=recip, tag=rng.randrange(256)))
            elif c < 0.6:
                mid, snd, rcp = rng.choice(live_ids)
                auth = rng.choice([snd, rcp, rng.choice(idents)])
                mid_q = mid if rng.random() < 0.8 else rng.randbytes(16)
                reqs.append(req(C.REQUEST_TYPE_READ, auth, msg_id=mid_q))
            elif c < 0.7:
                auth = rng.choice(idents)
                reqs.append(req(C.REQUEST_TYPE_READ, auth))  # zero id: next message
            elif c < 0.8:
                mid, snd, rcp = rng.choice(live_ids)
                auth = rng.choice([snd, rcp])
                recip_q = rcp if rng.random() < 0.8 else rng.choice(idents)
                reqs.append(req(C.REQUEST_TYPE_UPDATE, auth, msg_id=mid, recipient=recip_q, tag=rng.randrange(256)))
            elif c < 0.9:
                mid, snd, rcp = rng.choice(live_ids)
                auth = rng.choice([snd, rcp, rng.choice(idents)])
                reqs.append(req(C.REQUEST_TYPE_DELETE, auth, msg_id=mid, recipient=rcp))
            else:
                auth = rng.choice(idents)
                reqs.append(req(C.REQUEST_TYPE_DELETE, auth))  # pop next

        dev_resps = engine.handle_queries(reqs, t)
        for r, dev in zip(reqs, dev_resps):
            forced = (
                dev.record.msg_id
                if r.request_type == C.REQUEST_TYPE_CREATE
                and dev.status_code == C.STATUS_CODE_SUCCESS
                else None
            )
            ora = oracle.handle_query(r, t, forced_msg_id=forced)
            assert_responses_equal(dev, ora, f"step {step_no} op {r.request_type}")
            # maintain the live-id pool from oracle state
            if ora.status_code == C.STATUS_CODE_SUCCESS:
                if r.request_type == C.REQUEST_TYPE_CREATE:
                    live_ids.append(
                        (ora.record.msg_id, ora.record.sender, ora.record.recipient)
                    )
                elif r.request_type == C.REQUEST_TYPE_DELETE:
                    live_ids = [e for e in live_ids if e[0] != ora.record.msg_id]

        assert engine.message_count() == oracle.message_count()
        assert engine.recipient_count() == oracle.recipient_count()
    assert engine.health()["stash_overflow"] == 0


def test_mailbox_cap_and_capacity_reuse():
    cfg = GrapevineConfig(bucket_cipher_rounds=0,
        max_messages=8, max_recipients=4, mailbox_cap=3, batch_size=4, stash_size=64, commit="op"
    )
    engine = GrapevineEngine(cfg, seed=5)
    a, b = key(1), key(2)
    # fill b's mailbox to the cap
    for i in range(3):
        (r,) = engine.handle_queries([req(C.REQUEST_TYPE_CREATE, a, recipient=b)], NOW)
        assert r.status_code == C.STATUS_CODE_SUCCESS
    (r,) = engine.handle_queries([req(C.REQUEST_TYPE_CREATE, a, recipient=b)], NOW)
    assert r.status_code == C.STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT
    # pop one, slot frees up
    (r,) = engine.handle_queries([req(C.REQUEST_TYPE_DELETE, b)], NOW)
    assert r.status_code == C.STATUS_CODE_SUCCESS
    (r,) = engine.handle_queries([req(C.REQUEST_TYPE_CREATE, a, recipient=b)], NOW)
    assert r.status_code == C.STATUS_CODE_SUCCESS

    # fill the whole bus (8 messages): 3 live for b, then 3 to key(3) (its
    # cap), then the per-recipient cap kicks in
    fills = [
        engine.handle_queries([req(C.REQUEST_TYPE_CREATE, a, recipient=key(3))], NOW)[
            0
        ].status_code
        for _ in range(5)
    ]
    assert fills == [C.STATUS_CODE_SUCCESS] * 3 + [
        C.STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT
    ] * 2
    # 6 live; two more to fresh recipients fill the bus
    for peer in (key(4), key(5)):
        (r,) = engine.handle_queries([req(C.REQUEST_TYPE_CREATE, a, recipient=peer)], NOW)
        assert r.status_code == C.STATUS_CODE_SUCCESS
    # bus now full: 8 live messages
    (r,) = engine.handle_queries([req(C.REQUEST_TYPE_CREATE, a, recipient=key(6))], NOW)
    assert r.status_code == C.STATUS_CODE_TOO_MANY_MESSAGES
    # deleting one frees a block for reuse
    (r,) = engine.handle_queries([req(C.REQUEST_TYPE_DELETE, b)], NOW)
    assert r.status_code == C.STATUS_CODE_SUCCESS
    (r,) = engine.handle_queries([req(C.REQUEST_TYPE_CREATE, a, recipient=key(4))], NOW)
    assert r.status_code == C.STATUS_CODE_SUCCESS


def test_rud_transcripts_bit_identical():
    """READ, UPDATE, DELETE of the same message from identically-seeded
    engines produce bit-identical public transcripts — the reference's
    core obliviousness invariant (grapevine.proto:120-122), checked at
    its strongest: not just same distribution, the same bits."""
    a, b = key(7), key(8)

    def fresh():
        e = GrapevineEngine(SMALL, seed=11)
        (r,) = e.handle_queries([req(C.REQUEST_TYPE_CREATE, a, recipient=b)], NOW)
        assert r.status_code == C.STATUS_CODE_SUCCESS
        return e, r.record.msg_id

    transcripts = {}
    for rt in (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_UPDATE, C.REQUEST_TYPE_DELETE):
        e, mid = fresh()
        _, tr = e.handle_queries_with_transcript(
            [req(rt, b, msg_id=mid, recipient=b)], NOW + 1
        )
        transcripts[rt] = tr
    assert np.array_equal(transcripts[C.REQUEST_TYPE_READ], transcripts[C.REQUEST_TYPE_UPDATE])
    assert np.array_equal(transcripts[C.REQUEST_TYPE_READ], transcripts[C.REQUEST_TYPE_DELETE])

    # failed ops are indistinguishable from successful ones too
    e, mid = fresh()
    _, tr_wrong_auth = e.handle_queries_with_transcript(
        [req(C.REQUEST_TYPE_DELETE, key(9), msg_id=mid, recipient=b)], NOW + 1
    )
    assert np.array_equal(transcripts[C.REQUEST_TYPE_DELETE], tr_wrong_auth)


def test_delete_with_half_guessed_id_mutates_nothing():
    """Regression: a DELETE whose msg_id matches on words 0-1 but not 2-3
    must not touch the mailbox (the oracle mutates nothing on mismatch)."""
    engine = GrapevineEngine(SMALL, seed=21)
    a, b = key(1), key(2)
    (r,) = engine.handle_queries([req(C.REQUEST_TYPE_CREATE, a, recipient=b)], NOW)
    assert r.status_code == C.STATUS_CODE_SUCCESS
    mid = r.record.msg_id
    half = mid[:8] + bytes(x ^ 0xFF for x in mid[8:])  # words 0-1 right, 2-3 wrong
    (d,) = engine.handle_queries(
        [req(C.REQUEST_TYPE_DELETE, b, msg_id=half, recipient=b)], NOW + 1
    )
    assert d.status_code == C.STATUS_CODE_NOT_FOUND
    # the message is still fully readable via the mailbox
    (rr,) = engine.handle_queries([req(C.REQUEST_TYPE_READ, b)], NOW + 2)
    assert rr.status_code == C.STATUS_CODE_SUCCESS
    assert rr.record.msg_id == mid
    assert engine.message_count() == 1


def test_expiry_sweep_engine_vs_oracle():
    cfg = GrapevineConfig(bucket_cipher_rounds=0,
        max_messages=32, max_recipients=8, mailbox_cap=4, batch_size=4,
        stash_size=64, expiry_period=100, commit="op",
    )
    engine = GrapevineEngine(cfg, seed=6)
    oracle = ReferenceEngine(config=cfg, rng=random.Random(1))
    a, b, c = key(1), key(2), key(3)

    for auth, recip, t in [(a, b, NOW), (a, c, NOW + 60), (c, b, NOW + 120)]:
        (r,) = engine.handle_queries([req(C.REQUEST_TYPE_CREATE, auth, recipient=recip)], t)
        assert r.status_code == C.STATUS_CODE_SUCCESS
        oracle.handle_query(
            req(C.REQUEST_TYPE_CREATE, auth, recipient=recip), t,
            forced_msg_id=r.record.msg_id,
        )

    n_dev = engine.expire(NOW + 151)
    n_ora = oracle.expire(NOW + 151)
    assert n_dev == n_ora == 1  # only the NOW message is older than 100
    assert engine.message_count() == oracle.message_count() == 2
    assert engine.recipient_count() == oracle.recipient_count()

    # the expired message is gone from reads; survivors intact
    for auth in (b, c):
        dev = engine.handle_queries([req(C.REQUEST_TYPE_READ, auth)], NOW + 152)[0]
        ora = oracle.handle_query(req(C.REQUEST_TYPE_READ, auth), NOW + 152)
        assert_responses_equal(dev, ora, "post-expiry read")

    # freed capacity is reusable
    (r,) = engine.handle_queries([req(C.REQUEST_TYPE_CREATE, a, recipient=b)], NOW + 160)
    assert r.status_code == C.STATUS_CODE_SUCCESS


def test_expiry_clock_regression_keeps_future_records():
    """Regression: a sweep clock behind a record's timestamp must not
    mass-evict via u32 wraparound (oracle uses signed comparison)."""
    cfg = GrapevineConfig(bucket_cipher_rounds=0,
        max_messages=16, max_recipients=4, mailbox_cap=4, batch_size=2,
        stash_size=64, expiry_period=100, commit="op",
    )
    engine = GrapevineEngine(cfg, seed=8)
    (r,) = engine.handle_queries([req(C.REQUEST_TYPE_CREATE, key(1), recipient=key(2))], NOW)
    assert r.status_code == C.STATUS_CODE_SUCCESS
    assert engine.expire(NOW - 10) == 0  # clock stepped back: keep everything
    assert engine.message_count() == 1
    (rr,) = engine.handle_queries([req(C.REQUEST_TYPE_READ, key(2))], NOW)
    assert rr.status_code == C.STATUS_CODE_SUCCESS


def test_default_mailbox_cap_62_enforced_and_drains():
    """The production default cap (62, the reference's compile-time
    constant, README.md:78-80) enforced at the exact boundary: 62
    creates to one recipient succeed, the 63rd fails, and the mailbox
    drains in creation order — against the oracle throughout."""
    import random as _random

    cfg = GrapevineConfig(
        bucket_cipher_rounds=0,
        max_messages=128,
        max_recipients=8,
        batch_size=16,
        stash_size=128,
    )
    assert cfg.mailbox_cap == 62
    engine = GrapevineEngine(cfg, seed=4)
    oracle = ReferenceEngine(config=cfg, rng=_random.Random(5))
    a, b = key(1), key(2)
    statuses = []
    t = NOW
    for start in range(0, 64, 16):
        reqs = [
            req(C.REQUEST_TYPE_CREATE, a, recipient=b, tag=start + j)
            for j in range(16)
        ]
        dev = engine.handle_queries(reqs, t)
        forced = [
            d.record.msg_id if d.status_code == C.STATUS_CODE_SUCCESS else None
            for d in dev
        ]
        ora = oracle.handle_batch(reqs, t, forced)
        for d, o in zip(dev, ora):
            assert d.status_code == o.status_code
            statuses.append(d.status_code)
    assert statuses.count(C.STATUS_CODE_SUCCESS) == 62
    assert statuses[:62] == [C.STATUS_CODE_SUCCESS] * 62
    assert set(statuses[62:]) == {C.STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT}
    assert engine.message_count() == oracle.message_count() == 62
    # drain in creation order (zero-id pop = oldest first)
    for start in range(0, 62, 16):
        n = min(16, 62 - start)
        reqs = [req(C.REQUEST_TYPE_DELETE, b) for _ in range(n)]
        dev = engine.handle_queries(reqs, t + 1)
        ora = oracle.handle_batch(reqs, t + 1)
        for j, (d, o) in enumerate(zip(dev, ora)):
            assert d.status_code == o.status_code == C.STATUS_CODE_SUCCESS
            assert d.record.payload == o.record.payload
            assert d.record.payload[0] == start + j  # oldest-first order
    assert engine.message_count() == oracle.message_count() == 0


def test_durable_op_journal_replays_through_engine_step(tmp_path, monkeypatch):
    """An op-major journal (rounds and a sweep) recovers to the live
    engine's exact state and generator state, replayed through
    ``engine_step``: the phase-major round would silently diverge, so it
    is made to raise. The next round then agrees on both engines."""
    cfg = GrapevineConfig(bucket_cipher_rounds=8, max_messages=32, max_recipients=8,
                          mailbox_cap=4, batch_size=4, stash_size=64, expiry_period=100,
                          commit="op")
    live_dir = tmp_path / "live"
    live = GrapevineEngine(cfg, seed=3, durability=DurabilityConfig(state_dir=str(live_dir)))
    rng = random.Random(5)
    idents = [key(i + 1) for i in range(4)]
    for rnd in range(5):
        reqs = [req(C.REQUEST_TYPE_CREATE, rng.choice(idents), recipient=rng.choice(idents),
                    tag=rnd * 8 + j) for j in range(3)]
        reqs.append(req(C.REQUEST_TYPE_DELETE if rnd % 2 else C.REQUEST_TYPE_READ,
                        rng.choice(idents)))
        live.handle_queries(reqs, NOW + 40 * rnd)
        if rnd == 3:
            assert live.expire(NOW + 40 * rnd + 1) > 0
    shutil.copytree(live_dir, tmp_path / "copy")

    def phase_round(*a, **k):
        raise AssertionError("an op-major journal replayed through engine_round_step")

    steps = []

    def counted_step(*a, **k):
        steps.append(1)
        return engine_step(*a, **k)

    monkeypatch.setattr(batcher, "engine_round_step", phase_round)
    monkeypatch.setattr(batcher, "engine_step", counted_step)
    back = GrapevineEngine(cfg, seed=3,
                           durability=DurabilityConfig(state_dir=str(tmp_path / "copy")))
    assert back.durability.replayed == 6 and len(steps) == 5
    assert first_difference(to_numpy(back.state), to_numpy(live.state), mask_junk=False) is None
    assert torch.equal(back.state.rng.get_state(), live.state.rng.get_state())
    nxt = [req(C.REQUEST_TYPE_READ, i) for i in idents]
    a, ta = live.handle_queries_with_transcript(nxt, NOW + 300)
    b, tb = back.handle_queries_with_transcript(nxt, NOW + 300)
    assert [x.pack() for x in a] == [x.pack() for x in b]
    assert ta.shape == (4, 3) and np.array_equal(ta, tb)
    assert any(x.status_code == C.STATUS_CODE_SUCCESS for x in a)
    live.close()
    back.close()
