"""The port's staged round pipeline (``grapevine_tpu_torch/engine/
batcher.py``), held against its own depth-1 program on the CPU; the
reference's model is ``tests/test_pipeline.py``.

- depth 2 ≡ depth 1 in responses, state bytes and every file of the
  state dir (journal segments and checkpoints, seal nonces fixed) over a
  multi-chunk campaign with sweeps and checkpoints rolling mid-campaign,
  at E=1 and E=2; the depth-2 journal replays equal on a depth-1 engine;
- journal order is dispatch order with two rounds unresolved;
- a dispatch that raises mid-call resolves every earlier round and
  re-raises the first exception;
- the admission bound: far from the quotas a depth-2 campaign reads the
  state once (at its first round), near them it falls back to the exact
  read, and both give the depth-1 responses and state;
- on the card (skipped without one): depth-2 dispatch makes no host
  synchronization after the warm-up and equals depth 1.

No JAX: this file also runs on the card without the directory's conftest
(``python -m pytest --noconftest tests/test_torch_pipeline.py -k cuda``).
Comparisons are exact (tolerance 0)."""

import hashlib
import os
import random
import threading

import pytest
import torch

from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
from grapevine_tpu_torch.engine import batcher
from grapevine_tpu_torch.engine.batcher import GrapevineEngine, PendingRound
from grapevine_tpu_torch.engine.checkpoint import state_to_bytes
from grapevine_tpu_torch.engine.journal import KIND_ROUND, BatchJournal
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

NOW0 = 1_700_000_000
TOY = dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=4,
           stash_size=64, bucket_cipher_rounds=0)


def _cfg(depth, **kw) -> GrapevineConfig:
    return GrapevineConfig(pipeline_depth=depth, **dict(TOY, **kw))


def _key(n: int) -> bytes:
    return bytes([n & 0xFF, (n >> 8) & 0xFF, n ^ 0x5A]) + b"\x01" * 29


def _req(rt, auth, recipient=C.ZERO_PUBKEY, pay=0) -> QueryRequest:
    return QueryRequest(request_type=rt, auth_identity=auth, record=RequestRecord(
        msg_id=C.ZERO_MSG_ID, recipient=recipient, payload=bytes([pay]) * C.PAYLOAD_SIZE))


def _campaign_reqs(rng: random.Random, n: int, users: int = 5,
                   p_create: float = 0.6) -> list[QueryRequest]:
    """CREATE / zero-id READ / zero-id DELETE mix, a pure function of the
    rng (no response-derived inputs)."""
    out = []
    for _ in range(n):
        c = rng.random()
        auth = _key(rng.randrange(1, users + 1))
        if c < p_create:
            out.append(_req(C.REQUEST_TYPE_CREATE, auth, _key(rng.randrange(1, users + 1)),
                            rng.randrange(256)))
        elif c < p_create + (1 - p_create) * 0.6:
            out.append(_req(C.REQUEST_TYPE_READ, auth, auth))
        else:
            out.append(_req(C.REQUEST_TYPE_DELETE, auth, auth))
    return out


def _run_campaign(engine, seed=7, calls=12, max_reqs=12, expire_every=5, **mix):
    """Multi-chunk ``handle_queries`` calls (up to 3 rounds each: the path
    that pipelines) and a sweep every ``expire_every`` calls; returns the
    hash of the response stream."""
    rng = random.Random(seed)
    h = hashlib.sha256()
    for i in range(calls):
        if expire_every and i % expire_every == expire_every - 1:
            engine.expire(NOW0 + i, period=4)
            continue
        for r in engine.handle_queries(_campaign_reqs(rng, rng.randrange(1, max_reqs), **mix),
                                       NOW0 + i):
            h.update(r.pack())
    return h.hexdigest()


def _state_hash(engine) -> str:
    return hashlib.sha256(state_to_bytes(engine.ecfg, engine.state)).hexdigest()


def _dir_bytes(d) -> dict:
    return {n: open(os.path.join(d, n), "rb").read() for n in sorted(os.listdir(d))}


@pytest.fixture
def fixed_nonce(monkeypatch):
    """Seal nonces and the root key come from ``os.urandom``: fixed, two
    durable runs of the same rounds write the same bytes."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes((7 * i + 3) & 0xFF for i in range(n)))


@pytest.mark.parametrize("evict_every", [1, 2])
def test_depth2_equals_depth1_and_replays_on_depth1(tmp_path, fixed_nonce, evict_every):
    """One campaign through three engines of the same seed: depth 1 and
    depth 2, both durable (an fsync per record, a checkpoint every 8) —
    equal responses, state bytes and state-dir files (journal segments,
    checkpoint, key); then a depth-1 engine recovered from the depth-2
    state dir holds the same state."""
    def dcfg(name):
        return DurabilityConfig(state_dir=str(tmp_path / name), checkpoint_every_rounds=8,
                                journal_fsync_every=1)

    e1 = GrapevineEngine(_cfg(1, evict_every=evict_every), seed=3, device="cpu",
                         durability=dcfg("d1"))
    e2 = GrapevineEngine(_cfg(2, evict_every=evict_every), seed=3, device="cpu",
                         durability=dcfg("d2"))
    assert (e1.pipeline_depth, e2.pipeline_depth) == (1, 2)
    assert _run_campaign(e2) == _run_campaign(e1), "depth-2 responses differ"
    assert _state_hash(e2) == _state_hash(e1), "depth-2 state differs"
    assert e2.durability.seq == e1.durability.seq > 10
    assert e2.durability.ckpt_seq == e1.durability.ckpt_seq > 0, "no checkpoint rolled"
    if evict_every > 1:
        assert e2.flushes == e1.flushes > 0
    e1.close()
    e2.close()
    assert _dir_bytes(tmp_path / "d2") == _dir_bytes(tmp_path / "d1")

    e3 = GrapevineEngine(_cfg(1, evict_every=evict_every), seed=3, device="cpu",
                         durability=dcfg("d2"))
    assert e3.durability.replayed > 0 and e3.durability.seq == e2.durability.seq
    assert _state_hash(e3) == _state_hash(e2), "depth-1 replay of a depth-2 journal differs"
    assert e3.metrics.snapshot()["grapevine_phase_seconds{phase=replay}_count"] == 1
    e3.close()


def test_journal_order_is_dispatch_order(tmp_path):
    """Two rounds dispatched back to back, neither resolved, resolved out
    of order: the journal holds A before B."""
    dcfg = DurabilityConfig(state_dir=str(tmp_path / "ord"))
    engine = GrapevineEngine(_cfg(2), seed=0, device="cpu", durability=dcfg)
    pa = engine.handle_queries_async([_req(C.REQUEST_TYPE_CREATE, _key(1), _key(2), 0xAA)] * 2,
                                     NOW0)
    pb = engine.handle_queries_async([_req(C.REQUEST_TYPE_CREATE, _key(1), _key(2), 0xBB)],
                                     NOW0 + 1)
    rb, ra = pb.resolve(), pa.resolve()
    assert [r.status_code for r in ra + rb] == [C.STATUS_CODE_SUCCESS] * 3
    engine.close()
    recs = list(BatchJournal(dcfg.state_dir, engine.durability.root_key, engine.ecfg)
                .replay(after_seq=0))
    assert [r.kind for r in recs] == [KIND_ROUND, KIND_ROUND]
    assert [r.n_real for r in recs] == [2, 1]
    assert [int(r.batch["payload"][0, 0]) & 0xFF for r in recs] == [0xAA, 0xBB]
    assert [int(r.batch["now"]) for r in recs] == [NOW0, NOW0 + 1]


def test_failed_dispatch_drains_earlier_rounds_and_raises_the_first(monkeypatch):
    """Four chunks at depth 2: the third dispatch raises, and the second
    round's resolve raises too (after it resolved). Both dispatched
    rounds are resolved (the metrics count them), the dispatch's
    exception is the one raised, and the engine serves the next call."""
    engine = GrapevineEngine(_cfg(2), seed=1, device="cpu")
    dispatch, resolve = GrapevineEngine._dispatch_round, PendingRound.resolve
    calls = []

    def failing_dispatch(self, *a, **kw):
        calls.append(len(calls) + 1)
        if len(calls) == 3:
            raise RuntimeError("dispatch 3")
        return dispatch(self, *a, **kw)

    def failing_resolve(self):
        out = resolve(self)
        if self._tag == 2:
            raise RuntimeError("resolve 2")
        return out

    monkeypatch.setattr(GrapevineEngine, "_dispatch_round", failing_dispatch)
    monkeypatch.setattr(PendingRound, "resolve", failing_resolve)
    reqs = _campaign_reqs(random.Random(3), 16)
    with pytest.raises(RuntimeError, match="dispatch 3"):
        engine.handle_queries(reqs, NOW0)
    assert calls == [1, 2, 3]
    assert engine.metrics.snapshot()["rounds"] == 2
    monkeypatch.setattr(GrapevineEngine, "_dispatch_round", dispatch)
    monkeypatch.setattr(PendingRound, "resolve", resolve)
    assert len(engine.handle_queries(reqs[:5], NOW0 + 1)) == 5
    assert engine.metrics.snapshot()["rounds"] == 4


def _count_reads(monkeypatch, engine) -> list:
    reads = []
    read = engine._read_bound_locked

    def counted():
        reads.append(engine._dispatched)
        return read()

    monkeypatch.setattr(engine, "_read_bound_locked", counted)
    return reads


def test_admission_bound_skips_the_read_far_from_the_quotas(monkeypatch):
    """Far from both quotas a depth-2 campaign of multi-chunk calls reads
    the state once, at its first round: every later round's branch comes
    from the bound (resolved rounds refresh it); responses and state
    equal depth 1."""
    geo = dict(max_messages=256, max_recipients=64, mailbox_cap=8)
    e1 = GrapevineEngine(_cfg(1, **geo), seed=4, device="cpu")
    e2 = GrapevineEngine(_cfg(2, **geo), seed=4, device="cpu")
    reads = _count_reads(monkeypatch, e2)
    assert _run_campaign(e2, calls=8, expire_every=0) == _run_campaign(e1, calls=8,
                                                                       expire_every=0)
    assert _state_hash(e2) == _state_hash(e1)
    assert reads == [0] and e2._dispatched > 12


def test_admission_bound_falls_back_near_the_quotas(monkeypatch):
    """A create-heavy campaign over more users than the recipient quota
    fills the engine: near the quotas the bound cannot decide and the
    round reads the exact values, whose branch (the slow walk included)
    gives the depth-1 responses and state."""
    mix = dict(users=12, p_create=0.85)
    e1 = GrapevineEngine(_cfg(1), seed=5, device="cpu")
    e2 = GrapevineEngine(_cfg(2), seed=5, device="cpu")
    reads = _count_reads(monkeypatch, e2)
    fast = []
    step = batcher.engine_round_step

    def spy(*a, fast_ok=None, **kw):
        fast.append(fast_ok)
        return step(*a, fast_ok=fast_ok, **kw)

    monkeypatch.setattr(batcher, "engine_round_step", spy)
    h2 = _run_campaign(e2, calls=12, expire_every=0, **mix)
    monkeypatch.setattr(batcher, "engine_round_step", step)
    assert h2 == _run_campaign(e1, calls=12, expire_every=0, **mix)
    assert _state_hash(e2) == _state_hash(e1)
    assert True in fast and False in fast, "both admission branches must run"
    assert 1 < len(reads) < len(fast), "the bound and the exact read must both decide"


def test_resolve_on_another_thread():
    """A round dispatched on one thread resolves on another (the
    scheduler's pattern) with the responses of the serial program."""
    e1 = GrapevineEngine(_cfg(1), seed=2, device="cpu")
    e2 = GrapevineEngine(_cfg(2), seed=2, device="cpu")
    reqs = _campaign_reqs(random.Random(9), 4)
    want = [r.pack() for r in e1.handle_queries(reqs, NOW0)]
    pending = e2.handle_queries_async(reqs, NOW0)
    got = []
    t = threading.Thread(target=lambda: got.extend(r.pack() for r in pending.resolve()))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and got == want
    assert set(pending.spans) >= {"dispatch", "evict", "demux", "device", "round"}


def test_health_and_stash_sampling():
    """``health()`` carries the state counters, the metrics snapshot and,
    under delayed eviction, the buffer view; ``sample_stash`` feeds the
    stash gauges."""
    e = GrapevineEngine(_cfg(2, evict_every=2), seed=6, device="cpu")
    e.handle_queries(_campaign_reqs(random.Random(1), 10), NOW0)
    h = e.health()
    assert h["rounds"] == 3 and h["real_ops"] == 10 and h["messages"] == e.message_count()
    assert h["evict_rounds_since_flush"] == 1 and h["grapevine_evict_flushes_total"] == 1
    assert set(h["stash_occupancy"]) == set(h["evict_buffer_occupancy"]) == {"rec", "mb"}
    assert h["grapevine_stash_occupancy_count"] == 2
    assert h["grapevine_phase_seconds{phase=flush}_count"] == 1
    assert "durability" not in h
    assert e.flush_bubble_pending() is False
    e.flush_now()
    assert e.flush_bubble_pending() is True


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused round's Hopper kernels have no "
                    "CPU mode (run on the card: python -m pytest --noconftest "
                    "tests/test_torch_pipeline.py -k cuda)")
    return torch.device("cuda")


@pytest.mark.parametrize("impl,evict_every", [("pallas_fused", 2),
                                              ("pallas_fused_tiled", 1)])
def test_cuda_depth2_dispatch_makes_no_host_sync(cuda_device, impl, evict_every):
    """On the card, after two warm rounds, 8 depth-2 rounds dispatch under
    ``torch.cuda.set_sync_debug_mode("error")`` (any synchronizing call in
    the upload, the admission decision, the round, the flush or the output
    copies raises), each resolved after the next one dispatched; the
    responses and the state equal a depth-1 engine's."""
    geo = dict(max_messages=2**12, max_recipients=2**8, batch_size=32, mailbox_cap=8,
               vphases_impl="dense", bucket_cipher_impl=impl, evict_every=evict_every)
    e1 = GrapevineEngine(GrapevineConfig(pipeline_depth=1, **geo), seed=8, device=cuda_device)
    e2 = GrapevineEngine(GrapevineConfig(pipeline_depth=2, **geo), seed=8, device=cuda_device)
    rng = random.Random(11)
    calls = [_campaign_reqs(rng, 32, users=40) for _ in range(10)]
    want = [r.pack() for i, reqs in enumerate(calls) for r in e1.handle_queries(reqs, NOW0 + i)]
    got, pending = [], None
    for i, reqs in enumerate(calls):
        if i >= 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            nxt = e2.handle_queries_async(reqs, NOW0 + i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if pending is not None:
            got += [r.pack() for r in pending.resolve()]
        pending = nxt
    got += [r.pack() for r in pending.resolve()]
    assert got == want
    assert _state_hash(e2) == _state_hash(e1)
