"""Crash-safe port facade on the CPU: recovery to the live engine's exact
state, generator state included (the reference's ``tests/test_recovery.py``
and the recovery cases of ``tests/test_evict.py`` are the model).

Durable runs at ``evict_every`` 1 and 4 (rounds, sweeps, flushes and
checkpoints on the cadence) recover from checkpoint plus journal to
bit-equal state and generator state, with the same seed or another, and
the next round on the live and the recovered engine gives equal responses
and transcripts. A torn journal tail loses exactly its record; a crash
(SIGKILL in a child process) between the E-th round's frame and its flush
is completed and journaled at start-up; corrupt checkpoints, wrong keys,
other geometries and other cadences are refused.
"""

import os
import random
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
from grapevine_tpu_torch.engine import checkpoint as cp
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.engine.expiry import expiry_sweep
from grapevine_tpu_torch.engine.journal import KIND_FLUSH, KIND_SWEEP, BatchJournal, JournalError
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.testing import faults
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NOW = 1_700_000_000
SMALL = dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=4,
             stash_size=64, bucket_cipher_rounds=8)


def _cfg(evict_every: int, **kw) -> GrapevineConfig:
    return GrapevineConfig(**dict(SMALL, evict_every=evict_every, **kw))


def _key(n: int) -> bytes:
    return bytes([n, n ^ 0x5A]) + b"\x01" * 30


def _req(rt, auth, recipient=bytes(32), tag=0):
    return QueryRequest(request_type=rt, auth_identity=auth, record=RequestRecord(
        msg_id=bytes(16), recipient=recipient, payload=bytes([tag & 0xFF]) * C.PAYLOAD_SIZE))


def _events(n_events: int, seed: int = 17):
    """Deterministic mixed workload: creates and zero-id reads, with a
    sweep every 5th event (``None``)."""
    rng = random.Random(seed)
    out = []
    for i in range(n_events):
        if i % 5 == 3:
            out.append(None)
            continue
        reqs = []
        for _ in range(rng.randrange(1, SMALL["batch_size"] + 1)):
            if rng.random() < 0.6:
                reqs.append(_req(C.REQUEST_TYPE_CREATE, _key(rng.randrange(1, 5)),
                                 recipient=_key(rng.randrange(1, 5)),
                                 tag=rng.randrange(256)))
            else:
                reqs.append(_req(C.REQUEST_TYPE_READ, _key(rng.randrange(1, 5))))
        out.append(reqs)
    return out


def _drive(engine, events, t0=NOW):
    out = []
    for i, ev in enumerate(events):
        if ev is None:
            engine.expire(t0 + i, period=6)
        else:
            out.append([r.pack() for r in engine.handle_queries(ev, t0 + i)])
    return out


def _durable(d, evict_every: int, seed: int = 3, every: int = 5):
    return GrapevineEngine(_cfg(evict_every), seed=seed, device="cpu",
                           durability=DurabilityConfig(state_dir=str(d),
                                                       checkpoint_every_rounds=every))


def _snapshot(engine):
    return cp.state_to_bytes(engine.ecfg, engine.state)


@pytest.fixture(scope="module", params=[1, 4], ids=["E1", "E4"])
def durable_run(request, tmp_path_factory):
    """One durable run: 14 events (rounds and sweeps; at E=4 flushes too),
    a checkpoint every 5 records, closed with a journal tail. Yields
    (E, state dir, final state bytes, journal seq)."""
    e = request.param
    d = tmp_path_factory.mktemp(f"durable_e{e}")
    engine = _durable(d, e)
    _drive(engine, _events(14))
    final = _snapshot(engine)
    seq, ckpt_seq = engine.durability.seq, engine.durability.ckpt_seq
    engine.close()
    assert ckpt_seq > 0, "the cadence never checkpointed"
    assert seq > ckpt_seq, "the fixture needs a journal tail to replay"
    return e, d, final, seq


def _copy(src, tmp_path) -> str:
    dst = str(tmp_path / "statedir")
    shutil.copytree(src, dst)
    return dst


@pytest.mark.parametrize("seed", [3, 999])
def test_checkpoint_plus_journal_recovers_bit_equal(durable_run, tmp_path, seed):
    """Recovered state (checkpoint + replayed tail) is bit-identical to the
    live engine's, generator state included, whatever the init seed."""
    e, d, final, seq = durable_run
    engine = _durable(_copy(d, tmp_path), e, seed=seed)
    assert engine.durability.recovered_from_checkpoint
    assert engine.durability.replayed > 0
    assert engine.durability.seq == seq
    assert _snapshot(engine) == final
    st = engine.health()["durability"]
    assert st["last_checkpoint_seq"] > 0 and st["last_durable_seq"] == seq
    if e > 1:
        assert engine._rounds_since_flush == int(engine.state.rec.ebuf_rounds)
    engine.close()


def test_recovered_engine_continues_like_the_live_one(durable_run, tmp_path):
    """The next rounds on a live engine and on one recovered from its
    state dir give equal responses, transcripts and state."""
    e, d, final, seq = durable_run
    live = _durable(_copy(d, tmp_path / "a"), e)
    rec = _durable(_copy(d, tmp_path / "b"), e, seed=42)
    assert _snapshot(live) == _snapshot(rec) == final
    for i, reqs in enumerate(_events(6, seed=5)):
        if reqs is None:
            assert live.expire(NOW + 40 + i, 8) == rec.expire(NOW + 40 + i, 8)
            continue
        ra, ta = live.handle_queries_with_transcript(reqs, NOW + 40 + i)
        rb, tb = rec.handle_queries_with_transcript(reqs, NOW + 40 + i)
        assert [x.pack() for x in ra] == [x.pack() for x in rb]
        np.testing.assert_array_equal(ta, tb)
    assert _snapshot(live) == _snapshot(rec)
    assert torch.equal(live.state.rng.get_state(), rec.state.rng.get_state())
    live.close()
    rec.close()


def test_journal_only_recovery_matches(tmp_path):
    """No checkpoint: the journal alone replays from the seed's initial
    state to the live state (same seed)."""
    for e in (1, 4):
        d = tmp_path / f"e{e}"
        engine = _durable(d, e, every=1 << 20)
        _drive(engine, _events(11, seed=8))
        final, seq = _snapshot(engine), engine.durability.seq
        engine.close()
        assert cp.find_latest_checkpoint(str(d)) is None
        again = _durable(d, e, every=1 << 20)
        assert not again.durability.recovered_from_checkpoint
        assert again.durability.replayed == seq
        assert _snapshot(again) == final
        again.close()


def test_torn_journal_tail_recovers_to_previous_record(durable_run, tmp_path):
    """Truncating into the final frame loses exactly that record: recovery
    lands at seq - 1."""
    e, d, _, seq = durable_run
    c = _copy(d, tmp_path)
    (path,) = [os.path.join(c, n) for n in os.listdir(c) if n.endswith(".wal")]
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) - 30)  # inside the final frame's tag
    engine = _durable(c, e)
    assert engine.durability.seq == seq - 1
    engine.close()


def test_sweep_record_replays_the_sweep(tmp_path):
    """A journaled sweep is applied on replay exactly as it ran live:
    records it expired stay gone after recovery."""
    d = tmp_path / "s"
    engine = _durable(d, 1, every=1 << 20)
    _drive(engine, _events(3))
    n0 = engine.message_count()
    assert engine.expire(NOW + 100, period=10) == n0 > 0
    final = _snapshot(engine)
    engine.close()
    again = _durable(d, 1, every=1 << 20)
    assert again.message_count() == 0 and _snapshot(again) == final
    again.close()
    recs = list(BatchJournal(str(d), again.durability.root_key, again.ecfg).follow(0))
    assert recs[-1].kind == KIND_SWEEP and (recs[-1].now, recs[-1].period) == (NOW + 100, 10)


def test_crash_between_window_round_and_flush_completes_flush(tmp_path):
    """SIGKILL after the E-th round's frame and the flush frame's fault
    point: the child dies with the window full. Recovery finishes that
    flush at start-up, journaled, and the state equals an uninterrupted
    run's."""
    d = tmp_path / "crash"
    child = (
        "import sys; sys.path.insert(0, %r)\n"
        "from test_torch_recovery import _durable, _drive, _events\n"
        "eng = _durable(%r, 4, every=1 << 20)\n"
        "_drive(eng, [ev for ev in _events(6) if ev is not None])\n"
    ) % (os.path.join(REPO, "tests"), str(d))
    env = dict(os.environ, PYTHONPATH=REPO, **{faults.ENV_VAR: "flush.pre_dispatch=1"})
    res = subprocess.run([sys.executable, "-c", child], env=env, capture_output=True,
                         timeout=300)
    assert res.returncode == -9, res.stderr.decode()[-2000:]
    # the journal ends [round 1..4, flush]: the flush never ran
    root = open(os.path.join(d, "root.key"), "rb").read()
    ecfg = EngineConfig.from_config(_cfg(4))
    recs = list(BatchJournal(str(d), root, ecfg).replay(0))
    assert [r.kind for r in recs][-1] == KIND_FLUSH and len(recs) == 5

    rounds = [ev for ev in _events(6) if ev is not None][:4]
    ref = GrapevineEngine(_cfg(4), seed=3, device="cpu")
    for i, reqs in enumerate(rounds):
        ref.handle_queries(reqs, NOW + i)
    assert ref.flushes == 1
    again = _durable(d, 4, every=1 << 20)
    assert _snapshot(again) == _snapshot(ref)
    assert again._rounds_since_flush == 0
    again.close()

    # now cut the flush frame too: recovery replays 4 buffered rounds and
    # completes (and journals) the pending flush itself
    seg = sorted(n for n in os.listdir(d) if n.endswith(".wal"))[-1]
    path = os.path.join(d, seg)
    blob = open(path, "rb").read()
    flush_frame = 16 + 1 + 44
    with open(path, "wb") as fh:
        fh.write(blob[:-flush_frame])
    again = _durable(d, 4, every=1 << 20)
    assert _snapshot(again) == _snapshot(ref)
    assert again.durability.seq == 5 and again.flushes == 1
    again.close()
    kinds = [r.kind for r in BatchJournal(str(d), root, ecfg).replay(0)]
    assert kinds[-1] == KIND_FLUSH and len(kinds) == 5


def test_corrupt_checkpoint_rejected_never_half_loaded(durable_run, tmp_path):
    _, d, _, _ = durable_run
    c = _copy(d, tmp_path)
    ckpt = next(n for n in os.listdir(c) if n.startswith("ckpt-"))
    path = os.path.join(c, ckpt)
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0x10
    with open(path, "wb") as fh:
        fh.write(bytes(blob))
    with pytest.raises(cp.CheckpointError, match="integrity"):
        _durable(c, durable_run[0])


def test_wrong_root_key_rejected(durable_run, tmp_path):
    e, d, _, _ = durable_run
    c = _copy(d, tmp_path)
    with open(os.path.join(c, "root.key"), "wb") as fh:
        fh.write(b"\x42" * 32)
    with pytest.raises(cp.CheckpointError, match="integrity|root key"):
        _durable(c, e)


@pytest.mark.parametrize("kw", [dict(max_messages=128), dict(bucket_cipher_impl="pallas"),
                                dict(bucket_cipher_rounds=20)])
def test_geometry_change_rejected(durable_run, tmp_path, kw):
    e, d, _, _ = durable_run
    c = _copy(d, tmp_path)
    with pytest.raises(cp.CheckpointError, match="fingerprint"):
        GrapevineEngine(_cfg(e, **kw), seed=3, device="cpu",
                        durability=DurabilityConfig(state_dir=c))


def test_cross_cadence_journal_refused(tmp_path):
    """Journal-only recovery refuses a journal written under another
    ``evict_every``: flush frames on an E=1 engine, and more rounds than
    one window without a flush frame on an E=2 engine."""
    big = 1 << 20
    rounds = [ev for ev in _events(8) if ev is not None]
    d2 = tmp_path / "e2"
    eng = _durable(d2, 2, every=big)
    _drive(eng, rounds[:2])
    eng.close()
    with pytest.raises(JournalError, match="evict_every"):
        _durable(d2, 1, every=big)
    d1 = tmp_path / "e1"
    eng = _durable(d1, 1, every=big)
    _drive(eng, rounds[:4])
    eng.close()
    with pytest.raises(JournalError, match="different evict_every"):
        _durable(d1, 2, every=big)


def test_sweep_refuses_a_leaf_plane():
    """A tree with a leaf plane (recursive position map) was refused by
    the sweep until the recursive map was ported; the sweep now re-keys
    the plane under the new nonces in the same pass: every slot decrypts
    to the leaf it held before, the nonces moved, and the internal
    position tree is left as it was."""
    from grapevine_tpu_torch.oram.path_oram import leaf_plane_cipher

    eng = GrapevineEngine(_cfg(1, posmap_impl="recursive", sort_impl="radix"), seed=3,
                          device="cpu")
    for i in range(3):
        eng.handle_queries([_req(C.REQUEST_TYPE_CREATE, _key(i + 1), _key(i + 4), i)], NOW + i)
    ecfg, st = eng.ecfg, eng.state

    def plain_leaves(o, cfg):
        n, z = cfg.n_buckets_padded, cfg.bucket_slots
        return leaf_plane_cipher(cfg, o.cipher_key, torch.arange(n, dtype=torch.int32),
                                 o.nonces, o.tree_leaf.view(n, z).clone())

    before = {t: (plain_leaves(getattr(st, t), getattr(ecfg, t)),
                  getattr(st, t).nonces.clone(),
                  getattr(st, t).posmap.inner.tree_val.clone()) for t in ("rec", "mb")}
    assert before["rec"][0].any()
    st = expiry_sweep(ecfg, st, NOW + 10, 3600)
    for t in ("rec", "mb"):
        o, cfg = getattr(st, t), getattr(ecfg, t)
        leaves, nonces, inner_val = before[t]
        assert torch.equal(plain_leaves(o, cfg), leaves)
        assert not torch.equal(o.nonces, nonces)
        assert torch.equal(o.posmap.inner.tree_val, inner_val)


def test_durability_config_validation():
    with pytest.raises(ValueError):
        DurabilityConfig(state_dir="")
    with pytest.raises(ValueError):
        DurabilityConfig(state_dir="x", checkpoint_every_rounds=0)
    with pytest.raises(ValueError):
        DurabilityConfig(state_dir="x", journal_fsync_every=0)
