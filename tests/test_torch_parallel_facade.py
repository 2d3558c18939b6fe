"""The sharded facade on the CPU: ``GrapevineEngine(GrapevineConfig(
shards=N), device="cpu")`` builds a virtual mesh of N CPU shards and
serves, journals, checkpoints and recovers through the sharded step and
flush (``grapevine_tpu_torch/parallel/mesh.py``).

- A durable 2-shard engine and a 1-shard twin (same seed and requests,
  E=2, ``"pallas"``: neither writes the junk bucket) give equal
  responses, and after every round,
  flush and the expiry sweep equal ``state_to_bytes`` and generators.
- A checkpoint plus journal written at 2 shards recovers at 1, a journal
  written at 1 recovers at 2 and 4, each to the live state; the recovered
  engines are on their meshes and agree on one more round.
- A 2-shard standby installs a 1-shard primary's shipped checkpoint onto
  its mesh, and its promotion installs the newer checkpoint there too and
  drains the journal tail to the primary's state.
"""

import os
import shutil

import torch

from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
from grapevine_tpu_torch.engine.checkpoint import find_latest_checkpoint, state_to_bytes
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.engine.replication import StandbyReplica
from grapevine_tpu_torch.oram.path_oram import ShardedPlane
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from test_torch_replication import NOW, _plant_key, _req
from _torch_threads import one_torch_thread  # noqa: F401

KW = dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=4, stash_size=64,
          bucket_cipher_rounds=8, bucket_cipher_impl="pallas", evict_every=2,
          pipeline_depth=1, vphases_impl="dense")


def _engine(d, shards, **kw):
    return GrapevineEngine(GrapevineConfig(**KW, shards=shards), seed=4, device="cpu",
                           durability=DurabilityConfig(state_dir=d, **kw))


def _same(a, b) -> bool:
    return (state_to_bytes(a.ecfg, a.state) == state_to_bytes(b.ecfg, b.state)
            and torch.equal(a.state.rng.get_state(), b.state.rng.get_state()))


def _sharded(eng, n) -> bool:
    planes = [eng.state.rec.tree_val, eng.state.mb.tree_idx, eng.state.mb.nonces]
    if n == 1:
        return all(isinstance(p, torch.Tensor) for p in planes)
    return all(isinstance(p, ShardedPlane) and len(p.shards) == n for p in planes)


def _read(mid: bytes, who: bytes):
    return QueryRequest(request_type=C.REQUEST_TYPE_READ, auth_identity=who,
                        auth_signature=b"\x01" * C.SIGNATURE_SIZE,
                        record=RequestRecord(msg_id=mid, recipient=C.ZERO_PUBKEY,
                                             payload=bytes(C.PAYLOAD_SIZE)))


def _rounds(engines, first, n, made: list, found=C.STATUS_CODE_SUCCESS):
    """``n`` rounds of two creates and two reads by id (of the last two
    messages ``made``; each read's status ``found``) on every engine
    alike; the packed responses of each must be equal."""
    for r in range(first, first + n):
        reqs = [_req(4 * r + i + 1) for i in range(2)]
        reqs += [_read(mid, who) for mid, who in made[-2:]]
        out = [e.handle_queries(reqs, NOW + r) for e in engines]
        packed = [[x.pack() for x in o] for o in out]
        assert all(p == packed[0] for p in packed), f"round {r}: responses differ"
        for q, x in zip(reqs[:2], out[0]):
            if x.status_code == C.STATUS_CODE_SUCCESS:
                made.append((x.record.msg_id, q.record.recipient))
        assert all(x.status_code == found for x in out[0][2:]), r


def test_sharded_facade_serves_and_replays_across_shard_counts(tmp_path):
    da, db = str(tmp_path / "a"), str(tmp_path / "b")
    for d in (da, db):
        _plant_key(d)
    a = _engine(da, 2, checkpoint_every_rounds=3)  # 2 shards, checkpoints
    b = _engine(db, 1, checkpoint_every_rounds=1 << 20)  # 1 shard, journal only
    assert _sharded(a, 2) and _sharded(b, 1)
    made: list = []
    _rounds([a, b], 0, 5, made)
    assert a.flushes == b.flushes == 2 and _same(a, b)
    assert a.expire(NOW + 100, 50) == b.expire(NOW + 100, 50)
    assert _same(a, b) and _sharded(a, 2)
    # the sweep expired every message: the reads find nothing
    _rounds([a, b], 10, 1, made, found=C.STATUS_CODE_NOT_FOUND)
    assert _same(a, b) and a.durability.ckpt_seq > 0 and b.durability.ckpt_seq == 0
    a.close()
    b.close()
    recovered = []
    for src, live, n in ((da, a, 1), (da, a, 4), (db, b, 2), (db, b, 4)):
        d = str(tmp_path / f"{os.path.basename(src)}{n}")
        shutil.copytree(src, d)
        e = _engine(d, n)
        assert _sharded(e, n) and _same(e, live), (src, n)
        recovered.append(e)
    _rounds(recovered, 20, 1, made)
    assert all(_same(e, recovered[0]) for e in recovered)
    for e in recovered:
        e.close()


def test_sharded_standby_installs_and_promotes_onto_its_mesh(tmp_path):
    dp, ds = str(tmp_path / "primary"), str(tmp_path / "standby")
    for d in (dp, ds):
        _plant_key(d)
    primary = _engine(dp, 1, checkpoint_every_rounds=1 << 20)
    replica = StandbyReplica(GrapevineConfig(**KW, shards=2), seed=4, device="cpu",
                             durability=DurabilityConfig(state_dir=ds))
    eng = replica.engine
    assert _sharded(eng, 2)
    made: list = []
    _rounds([primary], 0, 3, made)
    seq = primary.checkpoint_now()
    with open(find_latest_checkpoint(dp)[1], "rb") as fh:
        replica._install_checkpoint(seq, fh.read())
    assert _sharded(eng, 2) and _same(eng, primary)
    # the primary moves on and checkpoints again: the promotion installs that
    # checkpoint (the standby never saw it) and drains the tail past it
    _rounds([primary], 3, 2, made)
    primary.checkpoint_now()
    _rounds([primary], 5, 3, made)
    primary.close()
    replica.promote(primary_state_dir=dp)
    assert _sharded(eng, 2) and _same(eng, primary)
    _rounds([eng], 8, 1, made)
    assert _sharded(eng, 2)
    replica.close()
