"""The port's journal-shipped hot standby on the CPU
(``grapevine_tpu_torch/engine/replication.py``; the reference's
``tests/test_replication.py`` is the model).

- the follower read path's liveness contract: a torn final frame is
  "poll again", a roll/prune racing the reader rescans, a follower behind
  the prune horizon must re-bootstrap, transient reads retry with a bound;
- ``append_raw`` refuses every malformed, out-of-order or fenced frame, and
  the ``on_append`` doorbell fires after the write and before the fsync;
- the replication fingerprint normalizes placement and scheduling knobs
  only; a shipper needs a journal;
- the loopback cycle over a real socket: live catch-up (the shipper's
  cadence books: 7 frames, every one a legal size), link cut, a durable
  tail the standby never saw drained by a fenced promote (RPO 0, state
  bit-identical, generator included), and every split-brain door shut;
- the k=4/depth-2 primary → k=0 standby promote, logically equal through
  the reference's ``testing/compare.py:assert_logical_state_equal`` on the
  states converted to the reference's pytree; the cross-geometry refusal;
- a standby that restarts on its own dir resumes with no gap, and one that
  bootstraps from a shipped checkpoint equals its primary (the replay
  cadence audit and the admission bound restart from the installed state).
"""

import builtins
import dataclasses
import errno
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
from grapevine_tpu_torch.engine import journal as jr
from grapevine_tpu_torch.engine.batcher import GrapevineEngine, pack_batch
from grapevine_tpu_torch.engine.checkpoint import engine_fingerprint, state_to_bytes
from grapevine_tpu_torch.engine.convert import to_numpy
from grapevine_tpu_torch.engine import replication as repl
from grapevine_tpu_torch.engine.replication import (
    JournalShipper,
    ReplicationError,
    StandbyReplica,
    replication_fingerprint,
)
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

ROOT = bytes(range(32))
NOW = 1_700_000_000


def _cfg(**kw):
    base = dict(
        max_messages=64, max_recipients=8, mailbox_cap=4,
        batch_size=4, stash_size=64, bucket_cipher_rounds=0,
        tree_top_cache_levels=0, pipeline_depth=1, vphases_impl="dense",
    )
    base.update(kw)
    return GrapevineConfig(**base)


SMALL = _cfg()
SMALL_E2 = _cfg(evict_every=2)


def _plant_key(d: str) -> None:
    """Both ends of a replication pair unseal under one root key."""
    os.makedirs(d, exist_ok=True)
    fd = os.open(os.path.join(d, "root.key"), os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
    try:
        os.write(fd, ROOT)
    finally:
        os.close(fd)


def _dcfg(d: str, **kw) -> DurabilityConfig:
    kw.setdefault("checkpoint_every_rounds", 1 << 20)
    return DurabilityConfig(state_dir=d, **kw)


def _req(tag: int, rt=C.REQUEST_TYPE_CREATE):
    return QueryRequest(
        request_type=rt,
        auth_identity=bytes([tag & 0xFF]) * 32,
        auth_signature=b"\x01" * C.SIGNATURE_SIZE,
        record=RequestRecord(
            msg_id=C.ZERO_MSG_ID,
            recipient=bytes([(tag ^ 0x5A) & 0xFF]) * 32,
            payload=bytes([tag & 0xFF]) * C.PAYLOAD_SIZE,
        ),
    )


def _round_batch(ecfg, tag: int):
    return pack_batch([_req(tag)], ecfg.batch_size, NOW + tag), 1


def _fresh_journal(d, ecfg, **kw):
    os.makedirs(d, exist_ok=True)
    j = jr.BatchJournal(str(d), ROOT, ecfg, **kw)
    list(j.replay(after_seq=0))
    j.open_for_append()
    return j


def _wait(pred, timeout=60.0, what=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    pytest.fail(f"timed out waiting for {what}")


def _wait_applied(replica, seq, what=""):
    """Wait until the standby has applied ``seq`` and finished the apply:
    ``_apply_locked`` publishes ``applied_seq`` before its own checkpoint
    cadence runs, all under the engine lock, so the predicate takes that
    lock and a read after it sees the whole apply."""
    def done():
        with replica.engine._lock:
            return replica.dm.applied_seq == seq
    _wait(done, what=what)


def _engine(cfg, d, **kw):
    return GrapevineEngine(cfg, seed=0, device="cpu", durability=_dcfg(d, **kw))


def _replica(cfg, d, **kw):
    return StandbyReplica(cfg, seed=0, durability=_dcfg(d, **kw), device="cpu")


def _same_state(a, b) -> bool:
    return (state_to_bytes(a.ecfg, a.state) == state_to_bytes(b.ecfg, b.state)
            and torch.equal(a.state.rng.get_state(), b.state.rng.get_state()))


@pytest.fixture(scope="module")
def ecfg():
    return EngineConfig.from_config(SMALL)


# -- the follower's liveness contract (journal.py follow_frames) ----------


def test_follow_torn_final_frame_is_poll_again_not_error(tmp_path, ecfg):
    """A half-written final frame means "not yet durable": the scan yields
    everything before it and stops; once the append completes the next
    poll yields the frame."""
    j = _fresh_journal(tmp_path, ecfg)
    j.append_round(*_round_batch(ecfg, 1))
    j.append_round(*_round_batch(ecfg, 2))
    j.close()
    (_, path), = jr.BatchJournal(str(tmp_path), ROOT, ecfg)._segments()
    blob = open(path, "rb").read()
    frame_len = len(blob) // 2

    reader = jr.BatchJournal(str(tmp_path), ROOT, ecfg)
    for cut in (frame_len + 1, frame_len + jr._HEADER.size, len(blob) - 1):
        with open(path, "wb") as fh:
            fh.write(blob[:cut])
        assert [s for s, _ in reader.follow_frames(after_seq=0)] == [1]
    with open(path, "wb") as fh:
        fh.write(blob)
    got = list(reader.follow_frames(after_seq=1))
    assert [s for s, _ in got] == [2] and got[0][1] == blob[frame_len:]


def test_follow_rescans_when_roll_prune_races_the_reader(tmp_path, ecfg, monkeypatch):
    """A segment vanishing between listdir and open triggers a rescan."""
    j = _fresh_journal(tmp_path, ecfg)
    j.append_round(*_round_batch(ecfg, 1))
    j.append_round(*_round_batch(ecfg, 2))
    j.close()
    real = jr.BatchJournal._read_segment
    calls = {"n": 0}

    def flaky(self, path):
        calls["n"] += 1
        if calls["n"] == 1:
            raise FileNotFoundError(path)
        return real(self, path)

    monkeypatch.setattr(jr.BatchJournal, "_read_segment", flaky)
    reader = jr.BatchJournal(str(tmp_path), ROOT, ecfg)
    assert [s for s, _ in reader.follow_frames(after_seq=0)] == [1, 2]
    assert calls["n"] == 2


def test_follow_behind_prune_horizon_demands_rebootstrap(tmp_path, ecfg):
    j = _fresh_journal(tmp_path, ecfg)
    j.append_round(*_round_batch(ecfg, 1))
    j.append_round(*_round_batch(ecfg, 2))
    j.roll()  # a checkpoint covering seq 2 landed: frames 1-2 pruned
    j.append_round(*_round_batch(ecfg, 3))
    j.close()
    reader = jr.BatchJournal(str(tmp_path), ROOT, ecfg)
    assert [s for s, _ in reader.follow_frames(after_seq=2)] == [3]
    with pytest.raises(jr.JournalError, match="prune horizon"):
        list(reader.follow_frames(after_seq=0))


def test_follow_retries_transient_reads_with_bounded_backoff(tmp_path, ecfg, monkeypatch):
    j = _fresh_journal(tmp_path, ecfg)
    j.append_round(*_round_batch(ecfg, 1))
    j.append_round(*_round_batch(ecfg, 2))
    j.close()
    real_open = builtins.open
    fails = {"n": 2}

    def flaky(path, *a, **kw):
        if str(path).endswith(".wal") and fails["n"] > 0:
            fails["n"] -= 1
            raise OSError(errno.EIO, "flaky mount")
        return real_open(path, *a, **kw)

    monkeypatch.setattr(builtins, "open", flaky)
    monkeypatch.setattr(jr.time, "sleep", lambda s: None)
    reader = jr.BatchJournal(str(tmp_path), ROOT, ecfg)
    assert [s for s, _ in reader.follow_frames(after_seq=0)] == [1, 2]
    fails["n"] = 10_000
    with pytest.raises(jr.JournalError, match="transient read errors"):
        list(reader.follow_frames(after_seq=0))


def test_follow_frames_refuses_a_journal_open_for_append(tmp_path, ecfg):
    j = _fresh_journal(tmp_path, ecfg)
    with pytest.raises(RuntimeError, match="read-only followers"):
        next(j.follow_frames(after_seq=0))
    j.close()


# -- append_raw and the doorbell -----------------------------------------


def _shipped_frames(d, ecfg, n=2):
    j = _fresh_journal(d, ecfg)
    for i in range(n):
        j.append_round(*_round_batch(ecfg, i + 1))
    j.append_sweep(NOW + 9, 0, 3600)
    j.close()
    return list(jr.BatchJournal(str(d), ROOT, ecfg).follow_frames(after_seq=0))


def _mangle(frame: bytes, **kw) -> bytes:
    magic, seq, bl = jr._HEADER.unpack_from(frame, 0)
    head = jr._HEADER.pack(kw.get("magic", magic), kw.get("seq", seq), kw.get("bl", bl))
    return head + frame[jr._HEADER.size:]


@pytest.mark.parametrize("case", ["gap", "short", "magic", "header_seq", "blob_len",
                                  "length", "not_open"])
def test_append_raw_refuses_malformed_and_out_of_order_frames(tmp_path, ecfg, case):
    """Each refusal leaves the follower's journal untouched: it still
    replays to exactly the frames appended before the refused one."""
    (s1, f1), (s2, f2), (s3, f3) = _shipped_frames(tmp_path / "src", ecfg)
    j = _fresh_journal(tmp_path / "dst", ecfg)
    assert j.append_raw(s1, f1) == 1
    bad = {
        "gap": (3, f3),
        "short": (2, f2[:10]),
        "magic": (2, _mangle(f2, magic=b"XXXX")),
        "header_seq": (2, _mangle(f2, seq=7)),
        "blob_len": (2, _mangle(f2, bl=12345)),
        "length": (2, f2 + b"\x00"),
        "not_open": (2, f2),
    }[case]
    if case == "not_open":
        j.close()
        with pytest.raises(RuntimeError, match="not open"):
            j.append_raw(*bad)
    else:
        with pytest.raises(jr.JournalError):
            j.append_raw(*bad)
        assert j.append_raw(s2, f2) == 2  # the right frame still goes in
        j.close()
    got = [r.seq for r in jr.BatchJournal(str(tmp_path / "dst"), ROOT, ecfg).replay()]
    assert got == ([1] if case == "not_open" else [1, 2])


def test_append_raw_refuses_a_fenced_journal_and_keeps_bytes(tmp_path, ecfg):
    frames = _shipped_frames(tmp_path / "src", ecfg)
    j = _fresh_journal(tmp_path / "dst", ecfg, fsync_every=2)
    for seq, frame in frames[:2]:
        j.append_raw(seq, frame)
    jr.write_fence(str(tmp_path / "dst"), epoch=j.epoch + 1, fingerprint="fp")
    with pytest.raises(jr.JournalError, match="fenced"):
        j.append_raw(*frames[2])
    j.close()
    (_, src), = jr.BatchJournal(str(tmp_path / "src"), ROOT, ecfg)._segments()
    (_, dst), = jr.BatchJournal(str(tmp_path / "dst"), ROOT, ecfg)._segments()
    assert open(dst, "rb").read() == b"".join(f for _, f in frames[:2])
    assert open(src, "rb").read().startswith(open(dst, "rb").read())


def test_on_append_doorbell_fires_after_the_write_before_the_fsync(tmp_path, ecfg,
                                                                   monkeypatch):
    seen, fsyncs = [], []
    real_fsync = jr.os.fsync
    monkeypatch.setattr(jr.os, "fsync", lambda fd: fsyncs.append(fd) or real_fsync(fd))
    j = _fresh_journal(tmp_path, ecfg)
    path = j._cur_path

    def bell(seq, frame):
        seen.append((seq, frame, os.path.getsize(path), len(fsyncs)))

    j.on_append = bell
    n0 = len(fsyncs)
    j.append_round(*_round_batch(ecfg, 1))
    j.append_flush()
    j.close()
    frames = list(jr.BatchJournal(str(tmp_path), ROOT, ecfg).follow_frames(after_seq=0))
    assert [(s, f) for s, f, _, _ in seen] == frames
    # each frame was on file (page cache) when the bell rang, not yet fsynced
    assert seen[0][2] == len(frames[0][1]) and seen[0][3] == n0
    assert seen[1][2] == len(frames[0][1]) + len(frames[1][1]) and seen[1][3] == n0 + 1


# -- fingerprints and construction ---------------------------------------


def test_replication_fingerprint_normalizes_placement_knobs_only():
    base = SMALL_E2
    assert replication_fingerprint(base) == replication_fingerprint(
        dataclasses.replace(base, tree_top_cache_levels=4))
    assert replication_fingerprint(base) == replication_fingerprint(
        dataclasses.replace(base, pipeline_depth=2))
    assert replication_fingerprint(base) != replication_fingerprint(SMALL)
    assert replication_fingerprint(base) != replication_fingerprint(
        dataclasses.replace(base, max_messages=128))
    assert engine_fingerprint(EngineConfig.from_config(base)) != engine_fingerprint(
        EngineConfig.from_config(dataclasses.replace(base, tree_top_cache_levels=4)))


def _wire(payload: bytes) -> bytes:
    return repl._LEN.pack(1 + len(payload)) + bytes([repl.MSG_FRAME]) + payload


def test_recv_keeps_a_message_across_a_mid_message_timeout():
    """The standby polls its feed with a short socket timeout. A timeout
    that falls inside a message keeps the bytes read so far and waits on:
    dropping them would parse the rest of the frame as the next header,
    and the standby would stall connected and behind."""
    a, b = socket.socketpair()
    try:
        b.settimeout(0.1)
        payload = bytes(range(256)) * 40
        wire = _wire(payload)
        a.sendall(wire[:1000])
        rest = threading.Timer(0.35, a.sendall, args=(wire[1000:],))
        rest.start()
        assert repl._recv_msg(b) == (repl.MSG_FRAME, payload)
        rest.join()
        a.sendall(_wire(b"next"))
        assert repl._recv_msg(b) == (repl.MSG_FRAME, b"next")
        # idle at a message boundary, the timeout is the caller's poll
        with pytest.raises(socket.timeout):
            repl._recv_msg(b)
    finally:
        a.close()
        b.close()


def test_recv_drops_a_link_that_stalls_mid_message(monkeypatch):
    """A message begun and never finished drops the link (the primary
    reconnects and resends from the applied seq) instead of waiting for
    ever; the partial bytes are never returned."""
    monkeypatch.setattr(repl, "MID_MESSAGE_STALL_S", 0.3)
    a, b = socket.socketpair()
    try:
        b.settimeout(0.1)
        a.sendall(_wire(bytes(4096))[:100])
        with pytest.raises(ReplicationError, match="stalled mid-message"):
            repl._recv_msg(b)
    finally:
        a.close()
        b.close()


def test_shipper_requires_a_journal_to_tail():
    eng = GrapevineEngine(SMALL, seed=0, device="cpu")
    try:
        with pytest.raises(ReplicationError, match="state-dir"):
            JournalShipper(eng, "127.0.0.1:1")
    finally:
        eng.close()


def test_standby_requires_a_state_dir_and_defaults_to_the_card(tmp_path, monkeypatch):
    with pytest.raises(ReplicationError, match="state dir"):
        StandbyReplica(SMALL, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        StandbyReplica(SMALL, durability=_dcfg(str(tmp_path)))


# -- the loopback cycle: ship → cut → promote → fence → serve ------------


def test_ship_promote_fence_cycle_bit_identical(tmp_path):
    primary_dir = str(tmp_path / "primary")
    standby_dir = str(tmp_path / "standby")
    _plant_key(primary_dir)
    _plant_key(standby_dir)
    primary = _engine(SMALL_E2, primary_dir)
    replica = _replica(SMALL_E2, standby_dir)
    port = replica.listen()
    shipper = JournalShipper(primary, ("127.0.0.1", port))
    shipper.start()
    primary_open = True
    try:
        for i in range(4):
            primary.handle_queries([_req(i + 1)], NOW + i)
        primary.expire(NOW + 10, period=3600)
        _wait_applied(replica, primary.durability.seq, what="live catch-up")
        assert replica.connected and not replica.promoted
        healthy, detail = replica.healthz()
        assert healthy and detail["role"] == "standby"
        with replica.engine._lock:
            assert _same_state(replica.engine, primary)

        # the cadence books: 4 rounds + 2 flush frames (E=2) + 1 sweep, each
        # one of the geometry's legal sizes
        st = shipper.stats()
        assert st["frames_shipped"] == st["frames_appended"] == 7
        assert st["cadence_ok"] and st["illegal_frames"] == 0
        sizes = {jr._HEADER.size + bl for bl in primary.durability.journal._valid_blob_lens}
        assert st["bytes_shipped"] == sum(
            5 + len(f) for _, f in jr.BatchJournal(
                primary_dir, ROOT, primary.ecfg).follow_frames(after_seq=0))
        assert all(len(f) in sizes for _, f in jr.BatchJournal(
            standby_dir, ROOT, primary.ecfg).follow_frames(after_seq=0))
        snap = primary.metrics.registry.snapshot()
        assert snap["grapevine_replication_frames_shipped_total"] == 7

        # link cut; the primary's final rounds reach disk only
        shipper.close()
        for i in range(3):
            primary.handle_queries([_req(40 + i)], NOW + 20 + i)
        dead_seq = primary.durability.seq
        dead_bytes = state_to_bytes(primary.ecfg, primary.state)
        dead_rng = primary.state.rng.get_state()
        primary.close()
        primary_open = False

        res = replica.promote(primary_state_dir=primary_dir)
        assert res["epoch"] == 1 and res["rpo_durable_frames"] == 0
        assert res["applied_seq"] == dead_seq
        assert res["drained_frames"] == dead_seq - 7
        assert state_to_bytes(replica.engine.ecfg, replica.engine.state) == dead_bytes
        assert torch.equal(replica.engine.state.rng.get_state(), dead_rng)
        healthy, detail = replica.healthz()
        assert healthy and detail["promoted"]
        assert jr.read_epoch(standby_dir) == 1

        replica.engine.handle_queries([_req(99)], NOW + 40)
        assert replica.dm.seq > dead_seq

        # door 1: shipped frames bounce off a promoted replica
        with pytest.raises(ReplicationError, match="promoted"):
            replica.apply_frame(replica.dm.seq + 1, b"\x00" * 64)
        # door 2: the revived stale primary dies before truncating the tail
        with pytest.raises(jr.JournalError, match="fenced"):
            _engine(SMALL_E2, primary_dir)
        # door 3: a double promote has exactly one winner
        loser_dir = str(tmp_path / "loser")
        _plant_key(loser_dir)
        loser = _replica(SMALL_E2, loser_dir)
        try:
            with pytest.raises(jr.JournalError, match="already fenced"):
                loser.promote(primary_state_dir=primary_dir)
            assert not loser.promoted
        finally:
            loser.close()
    finally:
        shipper.close()
        if primary_open:
            primary.close()
        replica.close()


# -- rolling upgrade: cross-knob legal, cross-geometry fenced ------------


def _as_reference_state(ecfg, state):
    """The port's state as the reference's pytree (the generator is not a
    leaf: a placeholder key, equal on both sides)."""
    import jax.numpy as jnp

    from grapevine_tpu.engine.state import EngineState as JState
    from grapevine_tpu.oram.path_oram import OramState as JOram

    leaves = to_numpy(state)
    tree = {name: JOram(**{f: jnp.asarray(leaves[f"{name}.{f}"])
                           for f in JOram._fields}) for name in ("rec", "mb")}
    return JState(**tree, **{k: jnp.asarray(leaves[k]) for k in (
        "freelist", "free_top", "recipients", "seq", "hash_key", "id_key")},
        rng=jnp.zeros((2,), jnp.uint32))


def test_cross_knob_standby_promotes_under_k4_depth2_primary(tmp_path):
    from grapevine_tpu.config import GrapevineConfig as JConfig
    from grapevine_tpu.engine.state import EngineConfig as JEcfg
    from grapevine_tpu.testing.compare import assert_logical_state_equal

    pkw = dict(tree_top_cache_levels=4, pipeline_depth=2, evict_every=2)
    pcfg, scfg = _cfg(**pkw), SMALL_E2
    assert replication_fingerprint(pcfg) == replication_fingerprint(scfg)
    primary_dir, standby_dir = str(tmp_path / "primary"), str(tmp_path / "standby")
    _plant_key(primary_dir)
    _plant_key(standby_dir)
    primary = _engine(pcfg, primary_dir)
    replica = _replica(scfg, standby_dir)
    port = replica.listen()
    shipper = JournalShipper(primary, ("127.0.0.1", port))
    shipper.start()
    primary_open = True
    try:
        for i in range(4):
            primary.handle_queries([_req(i + 1)], NOW + i)
        _wait_applied(replica, primary.durability.seq, what="cross-knob catch-up")
        shipper.close()
        primary.handle_queries([_req(9)], NOW + 9)
        dead_seq = primary.durability.seq
        dead = primary.state
        primary.close()
        primary_open = False
        res = replica.promote(primary_state_dir=primary_dir)
        assert res["applied_seq"] == dead_seq
        assert torch.equal(replica.engine.state.rng.get_state(), dead.rng.get_state())
        # different placement, different bits: the logically equal store
        jp = JEcfg.from_config(JConfig(**{**dataclasses.asdict(SMALL_E2), **pkw}))
        js = JEcfg.from_config(JConfig(**dataclasses.asdict(SMALL_E2)))
        assert jp.rec.top_cache_levels > 0 == js.rec.top_cache_levels
        assert_logical_state_equal(jp, _as_reference_state(primary.ecfg, dead),
                                   js, _as_reference_state(replica.engine.ecfg,
                                                           replica.engine.state),
                                   ctx="cross-knob promote")
    finally:
        shipper.close()
        if primary_open:
            primary.close()
        replica.close()


def test_cross_geometry_ship_refused_with_fingerprint_error(tmp_path):
    primary_dir, standby_dir = str(tmp_path / "primary"), str(tmp_path / "standby")
    _plant_key(primary_dir)
    _plant_key(standby_dir)
    primary = _engine(SMALL, primary_dir)
    replica = _replica(SMALL_E2, standby_dir)
    shipper = JournalShipper(primary, ("127.0.0.1", replica.listen()))
    shipper.start()
    try:
        _wait(lambda: shipper.fatal is not None, what="fingerprint refusal")
        assert "fingerprint" in shipper.fatal
        assert replica.dm.seq == 0 and not replica.promoted
    finally:
        shipper.close()
        primary.close()
        replica.close()


# -- restarts and the checkpoint bootstrap --------------------------------


def test_standby_restart_resumes_with_no_gap(tmp_path):
    """A standby that stops mid-feed recovers its warm state from its own
    dir (checkpoint on its cadence + journal) and, reconnected, resumes at
    the next frame: its journal stays contiguous and it promotes equal."""
    primary_dir, standby_dir = str(tmp_path / "primary"), str(tmp_path / "standby")
    _plant_key(primary_dir)
    _plant_key(standby_dir)
    primary = _engine(SMALL_E2, primary_dir)
    replica = _replica(SMALL_E2, standby_dir, checkpoint_every_rounds=4)
    shipper = JournalShipper(primary, ("127.0.0.1", replica.listen()), connect_backoff_s=0.05)
    shipper.start()
    try:
        for i in range(5):
            primary.handle_queries([_req(i + 1)], NOW + i)
        _wait_applied(replica, primary.durability.seq, what="catch-up")
        with replica.engine._lock:
            assert replica.dm.ckpt_seq > 0  # its own checkpoint cadence ran
        replica.close()
        for i in range(3):  # shipped into the void while it is down
            primary.handle_queries([_req(20 + i)], NOW + 20 + i)
        replica = _replica(SMALL_E2, standby_dir, checkpoint_every_rounds=4)
        assert replica.dm.recovered_from_checkpoint and replica.dm.replayed > 0
        shipper.target = ("127.0.0.1", replica.listen())
        _wait_applied(replica, primary.durability.seq, what="resume")
        shipper.close()
        with replica.engine._lock:
            assert _same_state(replica.engine, primary)
            ckpt_seq = replica.dm.ckpt_seq
        seqs = [r.seq for r in jr.BatchJournal(standby_dir, ROOT, replica.engine.ecfg)
                .replay(after_seq=ckpt_seq)]
        assert seqs == list(range(ckpt_seq + 1, primary.durability.seq + 1))
        primary.close()
        res = replica.promote(primary_state_dir=primary_dir)
        assert res["drained_frames"] == 0 and res["applied_seq"] == primary.durability.seq
    finally:
        shipper.close()
        primary.close()
        replica.close()


def test_checkpoint_bootstrap_installs_and_reanchors(tmp_path, monkeypatch):
    """A standby behind the primary's prune horizon gets the sealed
    checkpoint (MSG_CKPT), installs it, follows the frames past it and
    equals the primary. The install restarts the replay cadence audit from
    the installed window, and the admission bound, which belonged to the
    old state's ``free_top`` tensor, reads the new state exactly."""
    primary_dir, standby_dir = str(tmp_path / "primary"), str(tmp_path / "standby")
    _plant_key(primary_dir)
    _plant_key(standby_dir)
    primary = _engine(SMALL_E2, primary_dir)
    for i in range(3):  # a mid-window checkpoint: the buffer holds a round
        primary.handle_queries([_req(i + 1)], NOW + i)
    ck = primary.checkpoint_now()
    assert ck == primary.durability.seq and os.listdir(primary_dir).count(
        f"journal-{ck + 1:016d}.wal") == 1
    replica = _replica(SMALL_E2, standby_dir)
    eng = replica.engine
    old_ref = eng._bound_ref
    installs = []
    real = replica.dm.install_checkpoint
    monkeypatch.setattr(replica.dm, "install_checkpoint",
                        lambda seq, blob: installs.append(seq) or real(seq, blob))
    shipper = JournalShipper(primary, ("127.0.0.1", replica.listen()))
    shipper.start()
    try:
        _wait_applied(replica, ck, what="checkpoint install")
        with eng._lock:
            assert installs == [ck] and replica.dm.ckpt_seq == ck
            assert eng._replay_since is None
            assert eng.state.free_top is not old_ref
            reads = []
            read = eng._read_bound_locked
            monkeypatch.setattr(eng, "_read_bound_locked", lambda: reads.append(1) or read())
            assert eng._admission(0) is True and reads == [1]
            monkeypatch.undo()
        for i in range(3):
            primary.handle_queries([_req(30 + i)], NOW + 30 + i)
        _wait_applied(replica, primary.durability.seq, what="follow")
        with eng._lock:
            assert eng._replay_since == int(eng.state.rec.ebuf_rounds)
            assert _same_state(eng, primary)
            np.testing.assert_array_equal(to_numpy(eng.state)["rec.ebuf_idx"],
                                          to_numpy(primary.state)["rec.ebuf_idx"])
        names = sorted(os.listdir(standby_dir))
        assert f"ckpt-{ck:016d}.sealed" in names
        assert [n for n in names if n.endswith(".wal")] == [f"journal-{ck + 1:016d}.wal"]
    finally:
        shipper.close()
        primary.close()
        replica.close()
