"""The port's sealing, checkpoint files and journal codec held against the
JAX package (``engine/checkpoint.py``, ``engine/journal.py``).

- the numpy ChaCha20 (chunked, running block counter) and ``seal`` under
  a fixed key and nonce give the reference's bytes; journal segments
  written by both packages for the same round, sweep and flush records
  are byte-identical;
- ``state_to_bytes`` of a carried-across state equals the reference's
  bytes leaf for leaf, except the generator leaf and the fingerprint;
- round trips, the torn-file corpus, torn journal tails, corrupt frames,
  wrong keys, renamed checkpoints, other geometries, a checkpoint the JAX
  package wrote and fenced journals are all refused whole, as the
  reference refuses them (its ``tests/test_checkpoint.py`` is the model).
"""

import os

import numpy as np
import pytest
import torch

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine import checkpoint as jcp
from grapevine_tpu.engine import journal as jjr
from grapevine_tpu.engine.batcher import pack_batch as jax_pack_batch
from grapevine_tpu.engine.state import EngineConfig as JEcfg, init_engine as jax_init
from grapevine_tpu.session.chacha import ChaCha20
from grapevine_tpu.wire.records import QueryRequest as JReq, RequestRecord as JRec
from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
from grapevine_tpu_torch.engine import checkpoint as cp
from grapevine_tpu_torch.engine import journal as jr
from grapevine_tpu_torch.engine.batcher import pack_batch
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.state import EngineConfig, init_engine
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from test_torch_engine import jax_leaves

SMALL = dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=4,
             stash_size=64)
#: the cipher on, delayed eviction and a tree-top cache: every plane has rows
WIDE = dict(SMALL, bucket_cipher_rounds=8, evict_every=4, tree_top_cache_levels=2)
ROOT = bytes(range(32))


@pytest.fixture
def fixed_nonce(monkeypatch):
    """Both packages draw their seal nonces from ``os.urandom``."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes((7 * i + 3) & 0xFF for i in range(n)))


# -- sealing primitives -------------------------------------------------


@pytest.mark.parametrize("n", [1, 63, 64, 65, 1000, 4096, 64 * cp._CHUNK_BLOCKS + 100])
def test_chacha20_matches_reference(n):
    """The chunked keystream equals the reference's one-pass numpy stream
    (across a chunk boundary and from a nonzero counter) and the session
    layer's RFC 7539 stream."""
    key, nonce = bytes(range(32)), bytes(range(12))
    data = bytes((i * 7) & 0xFF for i in range(n))
    got = cp.chacha20_xor(key, nonce, data)
    assert got == jcp.chacha20_xor(key, nonce, data)
    assert cp.chacha20_xor(key, nonce, data, counter=2**32 - 3) == jcp.chacha20_xor(
        key, nonce, data, counter=2**32 - 3)
    if n <= 4096:
        ks = ChaCha20(key, nonce).keystream(n)
        assert got == bytes(a ^ b for a, b in zip(data, ks))


def test_seal_matches_reference_and_rejects(fixed_nonce):
    for pt in (b"", b"payload bytes", bytes(range(256)) * 300):
        blob = cp.seal(ROOT, b"checkpoint", pt, aad=b"hdr")
        assert blob == jcp.seal(ROOT, b"checkpoint", pt, aad=b"hdr")
        assert cp.unseal(ROOT, b"checkpoint", blob, aad=b"hdr") == pt
        assert jcp.unseal(ROOT, b"checkpoint", blob, aad=b"hdr") == pt
    assert cp.derive_key(ROOT, b"x") == jcp.derive_key(ROOT, b"x")
    blob = cp.seal(ROOT, b"checkpoint", b"payload bytes", aad=b"hdr")
    with pytest.raises(cp.SealError):  # tamper
        cp.unseal(ROOT, b"checkpoint", blob[:-1] + b"\x00", aad=b"hdr")
    with pytest.raises(cp.SealError):  # truncation
        cp.unseal(ROOT, b"checkpoint", blob[:-5], aad=b"hdr")
    with pytest.raises(cp.SealError):  # wrong domain subkey
        cp.unseal(ROOT, b"journal", blob, aad=b"hdr")
    with pytest.raises(cp.SealError):  # aad (header) mangled
        cp.unseal(ROOT, b"checkpoint", blob, aad=b"HDR")
    with pytest.raises(cp.SealError):  # wrong root key
        cp.unseal(b"\x01" * 32, b"checkpoint", blob, aad=b"hdr")
    with pytest.raises(cp.SealError):  # shorter than nonce+tag
        cp.unseal(ROOT, b"checkpoint", b"short")


def test_root_key_create_then_load(tmp_path):
    path = str(tmp_path / "root.key")
    k1 = cp.load_or_create_root_key(path)
    assert len(k1) == 32 and oct(os.stat(path).st_mode & 0o777) == "0o600"
    assert cp.load_or_create_root_key(path) == k1
    assert jcp.load_or_create_root_key(path) == k1
    (tmp_path / "bad.key").write_bytes(b"short")
    with pytest.raises(cp.SealError):
        cp.load_or_create_root_key(str(tmp_path / "bad.key"))


# -- state bytes and checkpoint files -----------------------------------


@pytest.fixture(scope="module")
def ecfg():
    return EngineConfig.from_config(GrapevineConfig(**WIDE))


@pytest.fixture(scope="module")
def state(ecfg):
    return init_engine(ecfg, seed=5, device="cpu")


def _split(data: bytes):
    """(manifest, [leaf bytes]) of a ``state_to_bytes`` payload."""
    import json
    import struct

    (n,) = struct.unpack_from("<I", data, 0)
    man = json.loads(data[4:4 + n])
    off, out = 4 + n, []
    for dt, shape in man["leaves"]:
        nb = np.dtype(dt).itemsize * int(np.prod(shape, dtype=np.int64))
        out.append(data[off:off + nb])
        off += nb
    assert off == len(data)
    return man, out


def test_state_bytes_match_reference_leaf_for_leaf():
    """The same state in both packages serializes to the same leaves in
    the same order (``<u4`` little-endian), except the generator leaf
    (the port's ``torch.Generator`` state, ``|u1``) and the fingerprint
    (each package hashes its own config)."""
    jecfg = JEcfg.from_config(JConfig(**WIDE))
    tecfg = EngineConfig.from_config(GrapevineConfig(**WIDE))
    jst = jax_init(jecfg, 9)
    tst = from_jax_state(tecfg, jax_leaves(jst), device="cpu")
    jman, jl = _split(jcp.state_to_bytes(jecfg, jst))
    tman, tl = _split(cp.state_to_bytes(tecfg, tst))
    assert tman["version"] == jman["version"] == 1
    assert tman["fingerprint"] != jman["fingerprint"]
    assert tman["fingerprint"] == cp.engine_fingerprint(tecfg)
    assert tman["leaves"][:-1] == jman["leaves"][:-1]
    assert len(tl) == len(jl) == 2 * 21 + 7
    assert tl[:-1] == jl[:-1]
    assert tman["leaves"][-1] == ["|u1", [tst.rng.get_state().numel()]]
    assert jman["leaves"][-1] == ["<u4", [2]]
    assert [tuple(s) for _, s in tman["leaves"][:-1]] == [s for _, s in cp.state_spec(tecfg)]


@pytest.mark.parametrize("kw", [SMALL, WIDE, dict(SMALL, evict_every=2, mailbox_choices=1)])
def test_state_bytes_roundtrip_with_generator(kw):
    ecfg = EngineConfig.from_config(GrapevineConfig(**kw))
    st = init_engine(ecfg, seed=3, device="cpu")
    data = cp.state_to_bytes(ecfg, st)
    st2 = cp.bytes_to_state(ecfg, data, device="cpu")
    assert cp.state_to_bytes(ecfg, st2) == data
    assert first_difference(to_numpy(st2), to_numpy(st), mask_junk=False) is None
    # the restored generator continues the original stream
    assert torch.equal(torch.randint(0, 2**31, (64,), generator=st2.rng),
                       torch.randint(0, 2**31, (64,), generator=st.rng))
    assert [tuple(getattr(st, k).shape) for k in ("freelist", "free_top", "seq")] == [
        (ecfg.max_messages,), (), (2,)]


def test_checkpoint_write_load(tmp_path, ecfg, state):
    path = cp.write_checkpoint(str(tmp_path), ROOT, ecfg, state, seq=42)
    assert cp.find_latest_checkpoint(str(tmp_path)) == (42, path)
    seq, state2 = cp.load_checkpoint(path, ROOT, ecfg, device="cpu")
    assert seq == 42
    assert cp.state_to_bytes(ecfg, state2) == cp.state_to_bytes(ecfg, state)
    # a newer checkpoint supersedes, pruning drops the older and tmp files
    path2 = cp.write_checkpoint(str(tmp_path), ROOT, ecfg, state, seq=50)
    (tmp_path / (os.path.basename(path2) + ".tmp.1")).write_bytes(b"x")
    assert cp.find_latest_checkpoint(str(tmp_path)) == (50, path2)
    cp.prune_checkpoints(str(tmp_path), 50)
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(path2)]


def test_checkpoint_geometry_fingerprint_rejected(tmp_path, ecfg, state):
    path = cp.write_checkpoint(str(tmp_path), ROOT, ecfg, state, seq=1)
    for kw in (dict(WIDE, max_messages=128), dict(WIDE, evict_every=2),
               dict(WIDE, bucket_cipher_impl="pallas")):
        other = EngineConfig.from_config(GrapevineConfig(**kw))
        with pytest.raises(cp.CheckpointError, match="fingerprint"):
            cp.load_checkpoint(path, ROOT, other, device="cpu")


def test_reference_checkpoint_refused(tmp_path):
    """A checkpoint the JAX package wrote for the same GrapevineConfig is
    refused with the reference's geometry error, never misread."""
    jecfg = JEcfg.from_config(JConfig(**WIDE))
    path = jcp.write_checkpoint(str(tmp_path), ROOT, jecfg, jax_init(jecfg, 1), seq=3)
    tecfg = EngineConfig.from_config(GrapevineConfig(**WIDE))
    with pytest.raises(cp.CheckpointError, match="fingerprint"):
        cp.load_checkpoint(path, ROOT, tecfg, device="cpu")


def test_renamed_checkpoint_rejected(tmp_path, ecfg, state):
    """The filename seq picks the file; the sealed payload seq anchors
    replay: a renamed checkpoint must not shift the replay base."""
    path = cp.write_checkpoint(str(tmp_path), ROOT, ecfg, state, seq=7)
    os.rename(path, cp.checkpoint_path(str(tmp_path), 5))
    (tmp_path / "root.key").write_bytes(ROOT)
    mgr = cp.DurabilityManager(DurabilityConfig(state_dir=str(tmp_path)), ecfg, "cpu")
    with pytest.raises(cp.CheckpointError, match="renamed"):
        mgr.recover(state, lambda s, rec: s)


def test_torn_checkpoint_corpus_never_half_loads(tmp_path, ecfg, state):
    """Truncations at a spread of offsets plus interior bitflips: every
    variant raises CheckpointError; none returns a state."""
    path = cp.write_checkpoint(str(tmp_path), ROOT, ecfg, state, seq=7)
    blob = open(path, "rb").read()
    cuts = [0, 1, len(cp.MAGIC), 11, 12, 50, len(blob) // 2, len(blob) - 33,
            len(blob) - 1]
    for cut in cuts:
        torn = str(tmp_path / f"torn-{cut}.sealed")
        with open(torn, "wb") as fh:
            fh.write(blob[:cut])
        with pytest.raises(cp.CheckpointError):
            cp.load_checkpoint(torn, ROOT, ecfg, device="cpu")
    for flip_at in (8, 20, len(blob) // 2, len(blob) - 10):
        flipped = str(tmp_path / f"flip-{flip_at}.sealed")
        mutated = bytearray(blob)
        mutated[flip_at] ^= 0x40
        with open(flipped, "wb") as fh:
            fh.write(bytes(mutated))
        with pytest.raises(cp.CheckpointError):
            cp.load_checkpoint(flipped, ROOT, ecfg, device="cpu")
    with pytest.raises(cp.CheckpointError, match="integrity"):
        cp.load_checkpoint(path, b"\x42" * 32, ecfg, device="cpu")


# -- journal codec + torn-tail semantics --------------------------------


def _reqs(rq, rr, tag: int):
    return [rq(request_type=C.REQUEST_TYPE_CREATE, auth_identity=bytes([tag]) * 32,
               record=rr(msg_id=bytes(16), recipient=bytes([tag ^ 0x5A]) * 32,
                         payload=bytes([tag]) * C.PAYLOAD_SIZE))]


def _round_batch(ecfg, tag: int):
    reqs = _reqs(QueryRequest, RequestRecord, tag)
    return pack_batch(reqs, ecfg.batch_size, 1_700_000_000 + tag), len(reqs)


def _fresh_journal(path, ecfg, mod=jr, **kw):
    j = mod.BatchJournal(str(path), ROOT, ecfg, **kw)
    list(j.replay(after_seq=0))
    j.open_for_append()
    return j


def test_journal_frames_match_reference_bytes(tmp_path, fixed_nonce):
    """Round, sweep and flush records: the port's segment file equals the
    reference's byte for byte (same frames, same seals), the round bodies
    equal the reference's ``_encode_round``, and each package replays the
    other's file."""
    tecfg = EngineConfig.from_config(GrapevineConfig(**WIDE))
    jecfg = JEcfg.from_config(JConfig(**WIDE))
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tj = _fresh_journal(tmp_path / "t", tecfg)
    jj = _fresh_journal(tmp_path / "j", jecfg, mod=jjr)
    for tag in (1, 2):
        tb, n = _round_batch(tecfg, tag)
        jb = jax_pack_batch(_reqs(JReq, JRec, tag), jecfg.batch_size, 1_700_000_000 + tag)
        for k in jb:
            np.testing.assert_array_equal(np.asarray(tb[k]), np.asarray(jb[k]), k)
        assert tj._encode_round(tb, n) == jj._encode_round(jb, n)
        assert tj.append_round(tb, n) == jj.append_round(jb, n)
        assert tj.append_sweep(123 + tag, 4, 60) == jj.append_sweep(123 + tag, 4, 60)
        assert tj.append_flush() == jj.append_flush()
    tj.close()
    jj.close()
    (tseg,) = tj._segments()
    (jseg,) = jj._segments()
    assert open(tseg[1], "rb").read() == open(jseg[1], "rb").read()
    for mod, ecfg_, d in ((jr, tecfg, "j"), (jjr, jecfg, "t")):
        recs = list(mod.BatchJournal(str(tmp_path / d), ROOT, ecfg_).replay(0))
        assert [r.kind for r in recs] == [1, 2, 3, 1, 2, 3]
        assert (recs[1].now, recs[1].now_hi, recs[1].period) == (124, 4, 60)


def test_journal_roundtrip_rounds_and_sweeps(tmp_path, ecfg):
    j = _fresh_journal(tmp_path, ecfg)
    batches = [_round_batch(ecfg, t) for t in (1, 2)]
    assert j.append_round(*batches[0]) == 1
    assert j.append_sweep(123, 4, 60) == 2
    assert j.append_round(*batches[1]) == 3
    assert j.append_flush() == 4
    j.close()

    j2 = jr.BatchJournal(str(tmp_path), ROOT, ecfg)
    recs = list(j2.replay(after_seq=0))
    assert [r.seq for r in recs] == [1, 2, 3, 4]
    assert [r.kind for r in recs] == [jr.KIND_ROUND, jr.KIND_SWEEP, jr.KIND_ROUND,
                                      jr.KIND_FLUSH]
    assert recs[1].now == 123 and recs[1].now_hi == 4 and recs[1].period == 60
    for rec, (batch, n) in zip((recs[0], recs[2]), batches):
        assert rec.n_real == n
        for col in ("req_type", "auth", "msg_id", "recipient", "payload"):
            np.testing.assert_array_equal(rec.batch[col], batch[col])
        assert int(rec.batch["now"]) == int(batch["now"])
    j3 = jr.BatchJournal(str(tmp_path), ROOT, ecfg)
    assert [r.seq for r in j3.replay(after_seq=2)] == [3, 4]
    # a read-only follower sees the same records, and stops at a torn tail
    assert [r.seq for r in jr.BatchJournal(str(tmp_path), ROOT, ecfg).follow(1)] == [2, 3, 4]
    (_, seg), = j3._segments()
    with open(seg, "r+b") as fh:
        fh.truncate(os.path.getsize(seg) - 3)
    assert [r.seq for r in jr.BatchJournal(str(tmp_path), ROOT, ecfg).follow(0)] == [1, 2, 3]


def test_journal_torn_tail_discarded_everywhere_else_rejected(tmp_path, ecfg):
    j = _fresh_journal(tmp_path, ecfg)
    for t in range(3):
        j.append_round(*_round_batch(ecfg, t + 1))
    j.close()
    (first_seq, path), = jr.BatchJournal(str(tmp_path), ROOT, ecfg)._segments()
    blob = open(path, "rb").read()
    frame_len = len(blob) // 3

    # truncating anywhere inside the FINAL frame = torn tail: the first
    # two records replay, the torn one is discarded, never half-decoded
    for cut in (2 * frame_len + 1, 2 * frame_len + 16, len(blob) - 1):
        with open(path, "wb") as fh:
            fh.write(blob[:cut])
        jt = jr.BatchJournal(str(tmp_path), ROOT, ecfg)
        assert [r.seq for r in jt.replay(after_seq=0)] == [1, 2]
        # ...and appending after recovery truncates the torn bytes
        jt.open_for_append()
        assert jt.append_round(*_round_batch(ecfg, 9)) == 3
        jt.close()
        recs = list(jr.BatchJournal(str(tmp_path), ROOT, ecfg).replay(0))
        assert [r.seq for r in recs] == [1, 2, 3]
        with open(path, "wb") as fh:
            fh.write(blob)

    # a bitflipped frame with valid frames after it is corruption
    mutated = bytearray(blob)
    mutated[frame_len + 20] ^= 1
    with open(path, "wb") as fh:
        fh.write(bytes(mutated))
    with pytest.raises(jr.JournalError, match="integrity"):
        list(jr.BatchJournal(str(tmp_path), ROOT, ecfg).replay(0))
    # header corruption mid-segment raises too (never read as a torn tail)
    for at, match in ((frame_len, "magic"), (frame_len + 12, "impossible blob length")):
        mutated = bytearray(blob)
        mutated[at] ^= 0xFF
        with open(path, "wb") as fh:
            fh.write(bytes(mutated))
        with pytest.raises(jr.JournalError, match=match):
            list(jr.BatchJournal(str(tmp_path), ROOT, ecfg).replay(0))
    # a missing prefix is corruption, not a quiet skip
    with open(path, "wb") as fh:
        fh.write(blob[frame_len:])
    with pytest.raises(jr.JournalError, match="starts at seq 2"):
        list(jr.BatchJournal(str(tmp_path), ROOT, ecfg).replay(after_seq=0))
    # the wrong root key fails the first frame's tag: corruption, not a tail
    with open(path, "wb") as fh:
        fh.write(blob)
    with pytest.raises(jr.JournalError, match="integrity"):
        list(jr.BatchJournal(str(tmp_path), b"\x42" * 32, ecfg).replay(0))


def test_journal_geometry_mismatch_rejected(tmp_path, ecfg):
    j = _fresh_journal(tmp_path, ecfg)
    j.append_round(*_round_batch(ecfg, 1))
    j.close()
    other = EngineConfig.from_config(GrapevineConfig(**dict(WIDE, batch_size=8)))
    with pytest.raises(jr.JournalError, match="impossible blob length|batch_size"):
        list(jr.BatchJournal(str(tmp_path), ROOT, other).replay(0))


def test_journal_roll_prunes_covered_segments(tmp_path, ecfg):
    j = _fresh_journal(tmp_path, ecfg)
    j.append_round(*_round_batch(ecfg, 1))
    j.append_round(*_round_batch(ecfg, 2))
    j.roll()  # as after a checkpoint at seq 2
    j.append_round(*_round_batch(ecfg, 3))
    j.close()
    segs = jr.BatchJournal(str(tmp_path), ROOT, ecfg)._segments()
    assert [s[0] for s in segs] == [3]
    recs = list(jr.BatchJournal(str(tmp_path), ROOT, ecfg).replay(after_seq=2))
    assert [r.seq for r in recs] == [3]


def test_journal_fsync_batching(tmp_path, ecfg):
    synced = []
    j = jr.BatchJournal(str(tmp_path), ROOT, ecfg, fsync_every=3, on_fsync=synced.append)
    list(j.replay(0))
    j.open_for_append()
    for t in range(1, 8):
        j.append_round(*_round_batch(ecfg, t))
    assert synced == [3, 6]  # every 3rd record
    assert j.durable_seq == 6 and j.seq == 7
    j.sync()
    assert synced == [3, 6, 7]
    j.close()


def test_journal_fence_refuses_stale_writer(tmp_path, ecfg):
    """A fence marker with a newer epoch stops appends (the split-brain
    guard); a second fence loses the race."""
    j = _fresh_journal(tmp_path, ecfg)
    j.append_round(*_round_batch(ecfg, 1))
    jr.write_fence(str(tmp_path), 1, cp.engine_fingerprint(ecfg))
    with pytest.raises(jr.JournalError, match="fenced"):
        j.append_round(*_round_batch(ecfg, 2))
    with pytest.raises(jr.JournalError, match="already fenced"):
        jr.write_fence(str(tmp_path), 2, "x")
    jr.write_epoch(str(tmp_path), 1)
    assert jr.read_epoch(str(tmp_path)) == 1 and jr.read_fence(str(tmp_path))["epoch"] == 1
    j2 = jr.BatchJournal(str(tmp_path), ROOT, ecfg)
    assert [r.seq for r in j2.replay(0)] == [1]
    j2.open_for_append()  # epoch 1 now serves under the fence
    assert j2.append_round(*_round_batch(ecfg, 3)) == 2
    j2.close()
