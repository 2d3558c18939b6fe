"""The port's hot-standby drill held against the JAX package's
(``engine/replication.py`` in both; one geometry here, a second in
``test_torch_replication_jax2.py``; two seeds each).

One drill per package, the same ops, seed, root key and seal nonces (the
reference's ``os.urandom`` fixed, as ``test_torch_checkpoint.py`` does):
a durable E=2 primary ships over loopback to a standby; 4 rounds (two
windows, two flushes) and a sweep that evicts; the standby catches up;
the link is cut; 3 more rounds (a flush and a mid-window round) reach the
primary's disk only; the primary closes; the standby promotes with the
primary's state dir and drains that tail. The port's rounds take the
reference's random draws round by round, in the primary and in the
standby's replay (as ``test_torch_pipeline_jax.py`` feeds them). Then,
at tolerance 0:

- every primary round's responses are equal, and so are the dead
  primaries' states (junk bucket masked);
- the two standby journals are byte-identical, before and after the next
  round;
- the promote records agree (epoch, drained frames, applied seq);
- the promoted states are equal leaf for leaf (the generator is not a
  leaf; junk masked), and the port's promoted generator equals its dead
  primary's;
- the next round on both promoted engines gives equal responses and
  transcripts.
"""

import os
import random
import time

import numpy as np
import pytest
import torch

from grapevine_tpu.config import DurabilityConfig as JDur
from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.batcher import GrapevineEngine as JEngine
from grapevine_tpu.engine.replication import JournalShipper as JShipper
from grapevine_tpu.engine.replication import StandbyReplica as JReplica
from grapevine_tpu.wire.records import QueryRequest as JReq, RequestRecord as JRec
from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
from grapevine_tpu_torch.engine import batcher
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.replication import JournalShipper, StandbyReplica
from grapevine_tpu_torch.engine.round_step import RoundDraws
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from test_torch_engine import jax_draws, jax_leaves
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

NOW = 1_700_000_000
ROOT = bytes(range(32))
GEO = dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=4,
           stash_size=64, evict_every=2, vphases_impl="dense", pipeline_depth=1,
           bucket_cipher_rounds=8)
#: rounds before the cut (two windows) and after it (a window and a half)
LIVE, TAIL = 4, 3


def _user(i: int) -> bytes:
    return bytes([i + 1, 0x5C]) + bytes([i + 1]) * 30


def plan_round(rng: random.Random, k: int, b: int, created: list) -> list[tuple]:
    """One full round of ``b`` ops: creates over 6 users, then reads,
    updates and deletes by id of created messages and zero-id reads and
    deletes of the caller's own mailbox."""
    ops = []
    for i in range(b):
        x = rng.random()
        a, r = _user(rng.randrange(6)), _user(rng.randrange(6))
        if k == 0 or not created or x < 0.4:
            ops.append((C.REQUEST_TYPE_CREATE, a, r, bytes(16), k * 16 + i))
        elif x < 0.8:
            mid, snd, rcp = created[rng.randrange(len(created))]
            t = (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_UPDATE, C.REQUEST_TYPE_DELETE)[
                rng.randrange(3)]
            ops.append((t, rcp if t != C.REQUEST_TYPE_UPDATE else snd, rcp, mid, 99 + i))
        else:
            t = (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_DELETE)[rng.randrange(2)]
            ops.append((t, r, r, bytes(16), i))
    return ops


def _reqs(req, rec, ops) -> list:
    return [req(request_type=t, auth_identity=a, record=rec(
        msg_id=m, recipient=r, payload=bytes([p & 0xFF]) * C.PAYLOAD_SIZE))
        for t, a, r, m, p in ops]


def _plant(d: str) -> None:
    os.makedirs(d)
    with open(os.path.join(d, "root.key"), "wb") as fh:
        fh.write(ROOT)
    os.chmod(os.path.join(d, "root.key"), 0o600)


def _wait(pred, what: str, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            pytest.fail(f"timed out waiting for {what}")
        time.sleep(0.02)


def _journal_bytes(d: str) -> dict:
    return {n: open(os.path.join(d, n), "rb").read()
            for n in sorted(os.listdir(d)) if n.endswith(".wal")}


def _reference_drill(tmp, geo, seed, draws):
    """The JAX package's drill; records each round's generator key by its
    clock (the standby's replay draws the same keys), and plans the ops
    from its own responses."""
    cfg = JConfig(**geo)
    pdir, sdir = f"{tmp}/jp", f"{tmp}/js"
    _plant(pdir)
    _plant(sdir)
    dkw = dict(checkpoint_every_rounds=1 << 20)
    primary = JEngine(cfg, seed=seed, durability=JDur(state_dir=pdir, **dkw))
    replica = JReplica(cfg, seed=seed, durability=JDur(state_dir=sdir, **dkw))
    init = {"primary": jax_leaves(primary.state), "standby": jax_leaves(replica.engine.state)}

    def recording(step):
        def call(ecfg, state, batch):
            now = int(np.asarray(batch["now"]))
            key = np.asarray(state.rng)
            assert draws.setdefault(now, key).tobytes() == key.tobytes()
            return step(ecfg, state, batch)
        return call

    primary._step = recording(primary._step)
    replica.engine._step = recording(replica.engine._step)
    shipper = JShipper(primary, ("127.0.0.1", replica.listen()))
    shipper.start()
    rng, created, rounds, resps = random.Random(seed), [], [], []
    try:
        for k in range(LIVE + TAIL):
            if k == LIVE:
                evicted = primary.expire(*SWEEP)
                assert evicted > 0
                _wait(lambda: replica.dm.applied_seq == primary.durability.seq,
                      "reference catch-up")
                shipper.close()
            ops = plan_round(rng, k, cfg.batch_size, created)
            resp = primary.handle_queries(_reqs(JReq, JRec, ops), NOW + k)
            for (t, a, r, _m, _p), x in zip(ops, resp):
                if t == C.REQUEST_TYPE_CREATE and x.status_code == C.STATUS_CODE_SUCCESS:
                    created.append((x.record.msg_id, a, r))
            rounds.append(ops)
            resps.append([x.pack() for x in resp])
        dead = jax_leaves(primary.state)
        primary.close()
        info = replica.promote(primary_state_dir=pdir)
        promoted = jax_leaves(replica.engine.state)
        journal = _journal_bytes(sdir)
        nxt = plan_round(rng, LIVE + TAIL, cfg.batch_size, created)
        r, tr = replica.engine.handle_queries_with_transcript(
            _reqs(JReq, JRec, nxt), NOW + 50)
        after = _journal_bytes(sdir)
    finally:
        shipper.close()
        replica.close()
    return dict(init=init, rounds=rounds, resps=resps, evicted=evicted, dead=dead, info=info,
                promoted=promoted, journal=journal, next=nxt,
                next_resp=[x.pack() for x in r], next_tr=np.asarray(tr), after=after)


#: the sweep between the live rounds and the cut: what rounds 0-1 (clocks
#: NOW, NOW + 1) wrote last is older than the period and expires
SWEEP = (NOW + 47, 45)


def run_drill(tmp_path, monkeypatch, geo: dict, seed: int):
    """Both packages' drills at ``geo`` from ``seed``, and every check."""
    from grapevine_tpu.engine.state import EngineConfig as JEcfg

    monkeypatch.setattr(os, "urandom", lambda n: bytes((7 * i + 3) & 0xFF for i in range(n)))
    tmp = str(tmp_path)
    keys: dict = {}
    ref = _reference_drill(tmp, geo, seed, keys)
    jecfg = JEcfg.from_config(JConfig(**geo))
    real = batcher.engine_round_step

    def fed(ecfg, state, batch, draws=None, fast_ok=None):
        key = keys[int(batch["now"].reshape(-1)[0]) & 0xFFFFFFFF]
        d = RoundDraws(*(from_numpy(x, "cpu") for x in jax_draws(jecfg, key, ecfg.batch_size)))
        return real(ecfg, state, batch, draws=d, fast_ok=fast_ok)

    monkeypatch.setattr(batcher, "engine_round_step", fed)
    cfg = GrapevineConfig(**geo)
    pdir, sdir = f"{tmp}/tp", f"{tmp}/ts"
    _plant(pdir)
    _plant(sdir)
    dkw = dict(checkpoint_every_rounds=1 << 20)
    primary = GrapevineEngine(cfg, seed=seed, device="cpu",
                              durability=DurabilityConfig(state_dir=pdir, **dkw))
    primary.state = from_jax_state(primary.ecfg, ref["init"]["primary"], seed=seed,
                                   device="cpu")
    replica = StandbyReplica(cfg, seed=seed, device="cpu",
                             durability=DurabilityConfig(state_dir=sdir, **dkw))
    replica.engine.state = from_jax_state(replica.engine.ecfg, ref["init"]["standby"],
                                          seed=seed, device="cpu")
    shipper = JournalShipper(primary, ("127.0.0.1", replica.listen()))
    shipper.start()
    try:
        for k, ops in enumerate(ref["rounds"]):
            if k == LIVE:
                assert primary.expire(*SWEEP) == ref["evicted"]
                _wait(lambda: replica.dm.applied_seq == primary.durability.seq, "catch-up")
                assert replica.connected and not replica.promoted
                shipper.close()
            resp = primary.handle_queries(_reqs(QueryRequest, RequestRecord, ops), NOW + k)
            assert [x.pack() for x in resp] == ref["resps"][k], f"round {k}"
        diff = first_difference(to_numpy(primary.state), ref["dead"], mask_junk=True)
        assert diff is None, f"dead primaries differ at {diff}"
        dead_rng = primary.state.rng.get_state()
        primary.close()
        info = replica.promote(primary_state_dir=pdir)
        for k in ("epoch", "drained_frames", "applied_seq", "rpo_durable_frames"):
            assert info[k] == ref["info"][k], k
        assert info["drained_frames"] == TAIL + 1  # 3 rounds and the window's flush
        assert _journal_bytes(sdir) == ref["journal"]
        diff = first_difference(to_numpy(replica.engine.state), ref["promoted"],
                                mask_junk=True)
        assert diff is None, f"promoted states differ at {diff}"
        assert torch.equal(replica.engine.state.rng.get_state(), dead_rng)
        r, tr = replica.engine.handle_queries_with_transcript(
            _reqs(QueryRequest, RequestRecord, ref["next"]), NOW + 50)
        assert [x.pack() for x in r] == ref["next_resp"]
        np.testing.assert_array_equal(np.asarray(tr, np.uint32),
                                      ref["next_tr"].astype(np.uint32))
        assert _journal_bytes(sdir) == ref["after"]
    finally:
        shipper.close()
        replica.close()


@pytest.mark.parametrize("seed", [3, 11])
def test_standby_drill_matches_reference(tmp_path, monkeypatch, seed):
    run_drill(tmp_path, monkeypatch, GEO, seed)
