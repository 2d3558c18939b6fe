"""Seeded soak workloads for the port: randomized engine ≡ oracle
campaigns and a concurrent stress of the serving tier (the workloads of
the JAX package's ``tests/test_soak.py`` and ``tests/test_server_stress.py``,
on the port's engine, oracle, server and client).

``campaign`` runs one seeded CRUD session of 25 batches with same-key
hazards against the port's ``testing/reference.py:ReferenceEngine``
(forced ids, ``run_pair``), then a drain to empty through the expiry
sweep. ``HAZARD_PERMS`` are the reference's directed same-key orderings.
``VARIANTS`` cycles tree density, cipher rounds, batch size and cipher
impl as the reference's does; its ``"pallas"`` entries take each of the
port's three kernel impls in turn (``variant_config``). ``stress`` runs
client threads against a live server: mixed CRUD, mid-traffic re-auths
and hand-rolled queries with a bad signature, which must be refused with
UNAUTHENTICATED. Both are used by the gated port tests
(``GRAPEVINE_SOAK``, ``GRAPEVINE_STRESS``) and by ``chip_smoke.py``
phase 23f on the card.
"""

from __future__ import annotations

import dataclasses
import itertools
import random
import threading

from ..config import GrapevineConfig
from ..device import resolve_device
from ..wire import constants as C
from ..wire.records import QueryRequest, RequestRecord
from .reference import ReferenceEngine

NOW = 1_700_000_000
#: random batches in a campaign before its drain, the reference's
N_STEPS = 25
#: client threads of the stress workload, the reference's
STRESS_THREADS = 6

#: the reference soak's base geometry (``tests/test_round.py:SMALL``)
SMALL = GrapevineConfig(bucket_cipher_rounds=0, max_messages=64, max_recipients=8,
                        mailbox_cap=4, batch_size=8, stash_size=96)

#: (tree density, cipher rounds, batch size, cipher impl), the reference's
VARIANTS = [
    (2, 8, 8, "jnp"),
    (4, 0, 16, "jnp"),
    (2, 0, 12, "pallas"),
    (4, 8, 6, "pallas"),
]
#: the port's kernel impls, which the reference's ``"pallas"`` maps to
KERNEL_IMPLS = ("pallas", "pallas_fused", "pallas_fused_tiled")


def variant_config(i: int) -> GrapevineConfig:
    """Campaign ``i``'s configuration: ``VARIANTS[i % 4]`` over ``SMALL``,
    the n-th ``"pallas"`` campaign on ``KERNEL_IMPLS[n % 3]``."""
    density, cipher, bs, impl = VARIANTS[i % len(VARIANTS)]
    if impl == "pallas":
        n = sum(VARIANTS[j % len(VARIANTS)][3] == "pallas" for j in range(i))
        impl = KERNEL_IMPLS[n % len(KERNEL_IMPLS)]
    return dataclasses.replace(SMALL, tree_density=density, bucket_cipher_rounds=cipher,
                               batch_size=bs, bucket_cipher_impl=impl)


#: same-key orderings of zero-id READ, zero-id DELETE and CREATE on one
#: recipient within a batch (the reference's ``tests/test_same_key_ordering.py``)
HAZARD_PERMS = list(itertools.permutations(["zread", "create", "zdel"])) + [
    ("zread", "create"),
    ("zdel", "create"),
    ("zread", "zdel", "create", "create"),
    ("zdel", "zread", "create", "zread"),
    ("create", "zdel", "zread", "create"),
]


def key(n: int) -> bytes:
    return bytes([n, n ^ 0x5A]) + b"\x01" * 30


def req(rt, auth, msg_id=C.ZERO_MSG_ID, recipient=C.ZERO_PUBKEY, tag=0) -> QueryRequest:
    return QueryRequest(
        request_type=rt,
        auth_identity=auth,
        auth_signature=b"\x01" * C.SIGNATURE_SIZE,
        record=RequestRecord(msg_id=msg_id, recipient=recipient,
                             payload=bytes([tag & 0xFF]) * C.PAYLOAD_SIZE),
    )


def assert_responses_equal(dev, ora, ctx: str = "") -> None:
    if dev.status_code != ora.status_code:
        raise AssertionError(f"{ctx}: status {dev.status_code} != {ora.status_code}")
    for field in ("msg_id", "sender", "recipient", "payload", "timestamp"):
        if getattr(dev.record, field) != getattr(ora.record, field):
            raise AssertionError(f"{ctx}: {field}")


def run_pair(engine, oracle, reqs, t: int, ctx: str = "") -> list:
    """One batch through the port's engine and the oracle, the engine's
    msg_ids forced into the oracle's CREATEs. Raises at the first response
    or count that differs; returns the engine's responses."""
    dev = engine.handle_queries(reqs, t)
    forced = [d.record.msg_id
              if r.request_type == C.REQUEST_TYPE_CREATE
              and d.status_code == C.STATUS_CODE_SUCCESS else None
              for r, d in zip(reqs, dev)]
    ora = oracle.handle_batch(reqs, t, forced)
    for j, (r, d, o) in enumerate(zip(reqs, dev, ora)):
        assert_responses_equal(d, o, f"{ctx} slot {j} rt {r.request_type}")
    for what in ("message_count", "recipient_count"):
        if getattr(engine, what)() != getattr(oracle, what)():
            raise AssertionError(f"{ctx}: {what}")
    return dev


def campaign(cfg: GrapevineConfig, seed: int, device=None) -> dict:
    """One seeded session of ``N_STEPS`` random batches through the port's
    engine on ``device`` (``None``: the card) and the oracle, then a sweep
    that drains both to empty. Raises at the first divergence; returns the
    op and round counts."""
    from ..engine.batcher import GrapevineEngine

    engine = GrapevineEngine(cfg, seed=seed, device=resolve_device(device))
    oracle = ReferenceEngine(config=cfg, rng=random.Random(seed + 1))
    rng = random.Random(seed + 2)
    idents = [key(i + 1) for i in range(6)]
    live: list = []
    t = NOW
    ops = 0
    for step_no in range(N_STEPS):
        t += rng.randrange(3)
        reqs = []
        for _ in range(rng.randrange(1, cfg.batch_size + 1)):
            c = rng.random()
            if c < 0.35 or not live:
                reqs.append(req(C.REQUEST_TYPE_CREATE, rng.choice(idents),
                                recipient=rng.choice(idents), tag=rng.randrange(256)))
            elif c < 0.55:
                mid, snd, rcp = rng.choice(live)
                reqs.append(req(C.REQUEST_TYPE_READ, rng.choice([snd, rcp, rng.choice(idents)]),
                                msg_id=mid))
            elif c < 0.7:
                reqs.append(req(C.REQUEST_TYPE_READ, rng.choice(idents)))
            elif c < 0.8:
                mid, snd, rcp = rng.choice(live)
                reqs.append(req(C.REQUEST_TYPE_UPDATE, rng.choice([snd, rcp]),
                                msg_id=mid, recipient=rcp, tag=rng.randrange(256)))
            elif c < 0.9:
                mid, snd, rcp = rng.choice(live)
                reqs.append(req(C.REQUEST_TYPE_DELETE, rng.choice([snd, rcp, rng.choice(idents)]),
                                msg_id=mid, recipient=rcp))
            else:
                reqs.append(req(C.REQUEST_TYPE_DELETE, rng.choice(idents)))
        dev = run_pair(engine, oracle, reqs, t, f"seed {seed} step {step_no}")
        ops += len(reqs)
        for r, d in zip(reqs, dev):
            if d.status_code == C.STATUS_CODE_SUCCESS:
                if r.request_type == C.REQUEST_TYPE_CREATE:
                    live.append((d.record.msg_id, d.record.sender, d.record.recipient))
                elif r.request_type == C.REQUEST_TYPE_DELETE:
                    live = [e for e in live if e[0] != d.record.msg_id]
    if engine.health()["stash_overflow"] != 0:
        raise AssertionError(f"seed {seed}: stash overflow")
    expired = engine.expire(t + 10_000, period=5)
    if expired != oracle.expire(t + 10_000, period=5):
        raise AssertionError(f"seed {seed}: the drain's evicted counts differ")
    if not engine.message_count() == oracle.message_count() == 0:
        raise AssertionError(f"seed {seed}: not drained to empty")
    return {"ops": ops, "rounds": engine.health()["rounds"], "expired": expired}


def _payload(b: int) -> bytes:
    return bytes([b]) * C.PAYLOAD_SIZE


def stress(uri: str, seconds: float) -> dict:
    """``STRESS_THREADS`` clients against the server at ``uri`` for ``seconds``:
    creates to a peer, zero-id reads and deletes, re-auths (5%) and
    queries signed with an all-zero signature (5%, each refused with
    UNAUTHENTICATED and followed by a re-auth). Raises the first error of
    any thread, or if a thread does not finish within 60 s of the stop;
    returns the tallies."""
    import grpc

    from ..server.client import GrapevineClient
    from ..session import ristretto
    from ..wire import protowire as pw

    stop = threading.Event()
    errs: list[Exception] = []
    tallies = {"ops": 0, "created": 0, "bad_sig": 0, "reauth": 0}
    lock = threading.Lock()

    def worker(tid: int) -> None:
        rng = random.Random(tid)
        try:
            c = GrapevineClient(uri, identity_seed=bytes([tid + 1]) * 32)
            c.auth()
            peer_key = ristretto.keygen(bytes([((tid + 1) % STRESS_THREADS) + 1]) * 32)[1]
            n = {"ops": 0, "created": 0, "bad_sig": 0, "reauth": 0}
            while not stop.is_set():
                roll = rng.random()
                if roll < 0.05:
                    c.auth()  # mid-traffic re-auth: fresh channel and challenge stream
                    n["reauth"] += 1
                elif roll < 0.10:
                    # a query with a corrupted signature: drawing the
                    # challenge keeps the client's stream aligned with the
                    # server's, which consumes one for this request
                    _ = c._challenge.next_challenge()
                    bad = QueryRequest(request_type=C.REQUEST_TYPE_READ,
                                       auth_identity=c.public_key, auth_signature=bytes(64),
                                       record=RequestRecord(payload=_payload(0)))
                    raw = pw.encode_envelope(pw.EnvelopeMessage(
                        channel_id=c._channel_id, data=c._channel.encrypt(bad.pack())))
                    try:
                        c._query_rpc(raw)
                        raise AssertionError("bad signature accepted")
                    except grpc.RpcError as e:
                        if e.code() != grpc.StatusCode.UNAUTHENTICATED:
                            raise
                    c.auth()  # the reply never came: re-sync the channel
                    n["bad_sig"] += 1
                elif roll < 0.55:
                    r = c.create(recipient=peer_key, payload=_payload(rng.randrange(256)))
                    if r.status_code not in (C.STATUS_CODE_SUCCESS,
                                             C.STATUS_CODE_TOO_MANY_MESSAGES,
                                             C.STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT,
                                             C.STATUS_CODE_TOO_MANY_RECIPIENTS):
                        raise AssertionError(f"create status {r.status_code}")
                    n["created"] += r.status_code == C.STATUS_CODE_SUCCESS
                    n["ops"] += 1
                else:
                    r = c.read() if rng.random() < 0.5 else c.delete()
                    if r.status_code not in (C.STATUS_CODE_SUCCESS, C.STATUS_CODE_NOT_FOUND):
                        raise AssertionError(f"read/delete status {r.status_code}")
                    n["ops"] += 1
            c.close()
            with lock:
                for k, v in n.items():
                    tallies[k] += v
        except Exception as e:  # noqa: BLE001 -- handed to the caller, raised there
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(t,), daemon=True)
               for t in range(STRESS_THREADS)]
    for t in threads:
        t.start()
    stop.wait(seconds)
    stop.set()
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            raise AssertionError("a stress worker deadlocked")
    if errs:
        raise errs[0]
    return tallies
