"""The port's two-choice mailbox table under load (the JAX package's
``tests/test_mailbox_load.py`` is the model, case for case, with its
geometries and seeds).

The mailbox tier is a keyed two-choice hash table of K-mailbox buckets
(``engine/state.py:mb_bucket_hash`` with a salt per choice; a claim takes
the emptier candidate at round start). A recipient gets
TOO_MANY_RECIPIENTS early, before ``max_recipients``, only when both of
its candidates are full. These tests force that path at load 1.0 and
check that the engine stays consistent through it, measure the early
failure rate at the default load 0.5, check the memory ratio, keep the
single-choice path covered, and show that two choices beat one.

Each port engine (the facade on the CPU) starts from the state the JAX
package's ``init_engine(ecfg, seed)`` builds, carried across by
``engine/convert.py:from_jax_state``. So a seed names the reference's own
``hash_key``, and the fills place recipients in the buckets the
reference's do; every recipient's bucket under each choice is also held
against the JAX package's ``mb_bucket_hash``.
"""

import random

import jax.numpy as jnp
import numpy as np

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.state import EngineConfig as JEcfg
from grapevine_tpu.engine.state import init_engine
from grapevine_tpu.engine.state import mb_bucket_hash as jax_hash
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import GrapevineEngine as _Engine
from grapevine_tpu_torch.engine.convert import from_jax_state
from grapevine_tpu_torch.engine.state import EngineConfig, mb_bucket_hash
from grapevine_tpu_torch.u32 import from_numpy, to_numpy
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from test_torch_engine import jax_leaves
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

NOW = 1_700_000_000


def GrapevineEngine(cfg: GrapevineConfig, seed: int = 0) -> _Engine:
    """The port's facade on the CPU, on the JAX package's initial state for
    this geometry and seed; the recipients it is given are recorded."""
    e = _Engine(cfg, seed=seed, device="cpu")
    kw = {f: getattr(cfg, f) for f in ("bucket_cipher_rounds", "max_messages",
                                       "max_recipients", "mailbox_cap", "batch_size",
                                       "mailbox_load", "mailbox_choices")}
    jst = init_engine(JEcfg.from_config(JConfig(**kw)), seed)
    e.state = from_jax_state(e.ecfg, jax_leaves(jst), seed=seed, device="cpu")
    e.jax_hash_key = np.asarray(jst.hash_key)
    e.seen = []
    handle = e.handle_queries

    def recording(reqs, now):
        e.seen.extend(r.record.recipient for r in reqs
                      if r.record.recipient != C.ZERO_PUBKEY)
        return handle(reqs, now)

    e.handle_queries = recording
    return e


def assert_hash_equals_jax(e) -> None:
    """Every recipient the engine saw lands in the same bucket under each
    choice in both packages."""
    words = np.frombuffer(b"".join(e.seen), "<u4").reshape(-1, 8)
    n = e.ecfg.mb_table_buckets
    for c in range(e.ecfg.mb_choices):
        got = mb_bucket_hash(e.state.hash_key, from_numpy(words, "cpu"), n, salt=c)
        want = jax_hash(jnp.asarray(e.jax_hash_key), jnp.asarray(words), n, salt=c)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want), f"choice {c}")
    assert to_numpy(e.state.hash_key).tolist() == e.jax_hash_key.tolist()


def key(n: int) -> bytes:
    return n.to_bytes(4, "little") + b"\x02" * 28


def req(rt, auth, msg_id=C.ZERO_MSG_ID, recipient=C.ZERO_PUBKEY, tag=0):
    return QueryRequest(
        request_type=rt,
        auth_identity=auth,
        auth_signature=b"\x01" * C.SIGNATURE_SIZE,
        record=RequestRecord(
            msg_id=msg_id,
            recipient=recipient,
            payload=bytes([tag & 0xFF]) * C.PAYLOAD_SIZE,
        ),
    )


def test_bucket_overflow_path_is_consistent():
    """At load 1.0 (table slots == max_recipients), filling the table with
    distinct recipients hits the early TOO_MANY_RECIPIENTS path (64 balls
    in 16 buckets of 4), and the engine stays consistent: every SUCCESS
    drains, every early failure left no trace, and the placements equal
    the live recipient count."""
    cfg = GrapevineConfig(bucket_cipher_rounds=0,
        max_messages=256,
        max_recipients=64,
        mailbox_cap=4,
        batch_size=8,
        mailbox_load=1.0,
    )
    engine = GrapevineEngine(cfg, seed=13)
    sender = key(9999)
    statuses = {}
    for i in range(64):
        r = engine.handle_queries(
            [req(C.REQUEST_TYPE_CREATE, sender, recipient=key(i), tag=i)], NOW
        )[0]
        statuses[i] = r.status_code
    ok = [i for i, s in statuses.items() if s == C.STATUS_CODE_SUCCESS]
    early = [i for i, s in statuses.items() if s == C.STATUS_CODE_TOO_MANY_RECIPIENTS]
    assert set(statuses.values()) <= {
        C.STATUS_CODE_SUCCESS,
        C.STATUS_CODE_TOO_MANY_RECIPIENTS,
    }
    assert early, "expected at least one early bucket-overflow failure"
    assert engine.recipient_count() == len(ok)
    assert engine.message_count() == len(ok)
    # successes are drainable; early-failed recipients read NOT_FOUND
    for i in ok[:8]:
        r = engine.handle_queries([req(C.REQUEST_TYPE_READ, key(i))], NOW + 1)[0]
        assert r.status_code == C.STATUS_CODE_SUCCESS, f"recipient {i}"
        assert r.record.payload[0] == i
    for i in early[:4]:
        r = engine.handle_queries([req(C.REQUEST_TYPE_READ, key(i))], NOW + 1)[0]
        assert r.status_code == C.STATUS_CODE_NOT_FOUND
    assert_hash_equals_jax(engine)


def test_default_load_early_failure_rate_within_documented_bound():
    """At the default two-choice load (0.5) and half recipient fill, early
    failures need both candidates full: at most one in 10 half-fills."""
    rng = random.Random(7)
    total_early = 0
    for seed in range(10):
        cfg = GrapevineConfig(bucket_cipher_rounds=0,
            max_messages=256,
            max_recipients=64,
            mailbox_cap=4,
            batch_size=8,
        )
        engine = GrapevineEngine(cfg, seed=seed)
        sender = key(12345)
        for i in range(32):  # 50% fill
            r = engine.handle_queries(
                [req(C.REQUEST_TYPE_CREATE, sender, recipient=key(rng.randrange(1 << 20)))],
                NOW,
            )[0]
            if r.status_code == C.STATUS_CODE_TOO_MANY_RECIPIENTS:
                total_early += 1
        assert_hash_equals_jax(engine)
    # Poisson expectation ~0.008; even 2 would mean the model is off by
    # orders of magnitude
    assert total_early <= 1, f"early failures at default load: {total_early}"


def test_memory_overhead_documented_ratio():
    """Mailbox-tier slots per recipient = 1/load: 2x at the two-choice
    default (0.5), 8x at the single-choice legacy load (0.125); the same
    table geometry as the JAX package's."""
    cfg = GrapevineConfig(bucket_cipher_rounds=0, max_messages=1 << 12, max_recipients=1 << 8)
    ecfg = EngineConfig.from_config(cfg)
    assert ecfg.mb_choices == 2
    slots = ecfg.mb_table_buckets * ecfg.mb_slots
    assert slots == cfg.max_recipients / cfg.resolved_mailbox_load  # 2x
    legacy = GrapevineConfig(
        bucket_cipher_rounds=0, max_messages=1 << 12,
        max_recipients=1 << 8, mailbox_choices=1,
    )
    ecfg1 = EngineConfig.from_config(legacy)
    assert ecfg1.mb_choices == 1
    slots1 = ecfg1.mb_table_buckets * ecfg1.mb_slots
    assert slots1 == legacy.max_recipients / legacy.resolved_mailbox_load  # 8x
    for port, kw in ((ecfg, {}), (ecfg1, {"mailbox_choices": 1})):
        ref = JEcfg.from_config(JConfig(bucket_cipher_rounds=0, max_messages=1 << 12,
                                        max_recipients=1 << 8, **kw))
        assert (port.mb_choices, port.mb_table_buckets, port.mb_slots) == (
            ref.mb_choices, ref.mb_table_buckets, ref.mb_slots)


def test_single_choice_legacy_path_still_serves():
    """``mailbox_choices=1`` (the op-major oracle engine's scheme) keeps full
    CRUD semantics."""
    cfg = GrapevineConfig(bucket_cipher_rounds=0,
        max_messages=128,
        max_recipients=32,
        mailbox_cap=4,
        batch_size=4,
        mailbox_choices=1,
    )
    engine = GrapevineEngine(cfg, seed=5)
    sender = key(777)
    r = engine.handle_queries(
        [req(C.REQUEST_TYPE_CREATE, sender, recipient=key(1), tag=42)], NOW
    )[0]
    assert r.status_code == C.STATUS_CODE_SUCCESS
    r2 = engine.handle_queries([req(C.REQUEST_TYPE_READ, key(1))], NOW)[0]
    assert r2.status_code == C.STATUS_CODE_SUCCESS
    assert r2.record.payload[0] == 42
    r3 = engine.handle_queries([req(C.REQUEST_TYPE_DELETE, key(1))], NOW)[0]
    assert r3.status_code == C.STATUS_CODE_SUCCESS
    assert engine.message_count() == 0
    assert_hash_equals_jax(engine)


def test_two_choice_spreads_hot_bucket():
    """Two choices against one at the same tight geometry (16 buckets of 4,
    filled to 75% of slots with uniform recipients): over 3 seeded fills
    single-choice sees at least a few early failures and strictly more
    than two-choice (a regression collapsing both hashes to one candidate
    fails this)."""
    def fill(choices: int, seed: int) -> int:
        cfg = GrapevineConfig(bucket_cipher_rounds=0,
            max_messages=256,
            max_recipients=64,
            mailbox_cap=4,
            batch_size=8,
            mailbox_choices=choices,
            mailbox_load=1.0,  # 16 buckets x 4 slots for 64 recipients
        )
        engine = GrapevineEngine(cfg, seed=seed)
        rng = random.Random(100 + seed)
        sender = key(4242)
        early = 0
        for _ in range(48):  # 75% of table slots
            r = engine.handle_queries(
                [req(C.REQUEST_TYPE_CREATE, sender,
                     recipient=key(rng.randrange(1 << 20)))], NOW,
            )[0]
            early += r.status_code == C.STATUS_CODE_TOO_MANY_RECIPIENTS
        assert_hash_equals_jax(engine)
        return early

    single = sum(fill(1, s) for s in (0, 1, 2))
    double = sum(fill(2, s) for s in (0, 1, 2))
    assert single >= 3, f"single-choice control unexpectedly clean ({single})"
    assert double < single, (
        f"two-choice ({double}) not better than single-choice ({single})"
    )
