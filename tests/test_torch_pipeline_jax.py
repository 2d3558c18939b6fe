"""The port's pipelined facade held against the JAX package's (one JAX
compile: ``engine_round_step`` at one small geometry, shared by every
test here).

- Both ``GrapevineEngine``s at ``pipeline_depth=2`` serve the same
  multi-chunk calls from one carried-across state, the port fed the
  reference's random draws round by round (as ``test_torch_engine.py``
  does): equal response bytes after every call and equal state at the
  end, over a campaign that fills the engine to within B of its message
  and recipient quotas, so both admission branches run and the port's
  bound both decides and falls back to the exact read; the port's branch
  equals the reference's predicate in every round. ``health()`` and
  ``metrics.snapshot()`` have the reference's key sets.
- An expiry period of 2^32 or more raises ``OverflowError`` in both
  facades and both sweeps before anything changes, and the record still
  reads back.
- ``handle_queries_with_transcript`` runs no checkpoint cadence and does
  not check the clock, in both; a round through ``handle_queries`` at
  ``now=0`` is refused by both, an empty call is not.
"""

import os
import random
from collections import deque

import numpy as np
import pytest

from grapevine_tpu.config import DurabilityConfig as JDur
from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.batcher import GrapevineEngine as JEngine
from grapevine_tpu.engine.expiry import expiry_sweep as jax_sweep
from grapevine_tpu.wire.records import QueryRequest as JReq, RequestRecord as JRec
from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
from grapevine_tpu_torch.engine import batcher
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.expiry import expiry_sweep
from grapevine_tpu_torch.engine.round_step import RoundDraws
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from test_torch_engine import jax_draws, jax_leaves
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

NOW = 1_700_000_000
#: 16 mailboxes of 8 hold more than the 64 messages: a create-heavy campaign
#: over more users than 16 reaches both quotas
PAIR = dict(max_messages=64, max_recipients=16, mailbox_cap=8, batch_size=4,
            stash_size=64, vphases_impl="dense", pipeline_depth=2)


def _user(i: int) -> bytes:
    return bytes([i + 1, 0x33]) + bytes([i + 1]) * 30


def _plan(rng: random.Random, call: int, created: list) -> list[tuple]:
    """12 ops (3 rounds): creates over 20 users (most ops while filling),
    then reads, updates and deletes by id of created messages and zero-id
    reads and deletes of the caller's own mailbox."""
    ops = []
    for i in range(12):
        x = rng.random()
        a, r = _user(rng.randrange(20)), _user(rng.randrange(20))
        if call < 8 and x < 0.9 or not created or x < 0.3:
            ops.append((C.REQUEST_TYPE_CREATE, a, r, bytes(16), call * 16 + i))
        elif x < 0.75:
            mid, snd, rcp = created[rng.randrange(len(created))]
            t = (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_UPDATE, C.REQUEST_TYPE_DELETE)[
                rng.randrange(3)]
            ops.append((t, rcp if t != C.REQUEST_TYPE_UPDATE else snd, rcp, mid, i))
        else:
            t = (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_DELETE)[rng.randrange(2)]
            ops.append((t, r, r, bytes(16), i))
    return ops


def _reqs(req, rec, ops) -> list:
    return [req(request_type=t, auth_identity=a, record=rec(
        msg_id=m, recipient=r, payload=bytes([p & 0xFF]) * C.PAYLOAD_SIZE))
        for t, a, r, m, p in ops]


def test_depth2_facade_matches_reference_through_saturation(monkeypatch):
    jeng = JEngine(JConfig(**PAIR), seed=31)
    teng = GrapevineEngine(GrapevineConfig(**PAIR), seed=31, device="cpu")
    teng.state = from_jax_state(teng.ecfg, jax_leaves(jeng.state), seed=31,
                                device=teng.device)
    assert jeng.pipeline_depth == teng.pipeline_depth == 2
    b, cap = teng.ecfg.batch_size, teng.ecfg.max_recipients

    # the reference's draws and admission predicate, round by round
    rngs: deque = deque()
    ref_fast, ref_free = [], []
    jstep = jeng._step

    def recording_step(ecfg, state, batch):
        rngs.append(np.asarray(state.rng))
        ft, rc = int(state.free_top), int(state.recipients)
        ref_free.append(ft)
        ref_fast.append(ft >= b and rc + b <= cap)
        return jstep(ecfg, state, batch)

    jeng._step = recording_step
    port_fast = []
    tstep = batcher.engine_round_step

    def fed_step(ecfg, state, dev_batch, fast_ok=None):
        draws = RoundDraws(*(from_numpy(x, "cpu")
                             for x in jax_draws(jeng.ecfg, rngs.popleft(), b)))
        port_fast.append(fast_ok)
        return tstep(ecfg, state, dev_batch, draws=draws, fast_ok=fast_ok)

    monkeypatch.setattr(batcher, "engine_round_step", fed_step)
    reads = []
    read = teng._read_bound_locked
    monkeypatch.setattr(teng, "_read_bound_locked", lambda: reads.append(1) or read())

    rng = random.Random(5)
    created: list = []
    for call in range(12):
        ops = _plan(rng, call, created)
        jr = jeng.handle_queries(_reqs(JReq, JRec, ops), NOW + call)
        tr = teng.handle_queries(_reqs(QueryRequest, RequestRecord, ops), NOW + call)
        assert [r.pack() for r in tr] == [r.pack() for r in jr], f"call {call}"
        for (t, a, r, _m, _p), resp in zip(ops, jr):
            if t == C.REQUEST_TYPE_CREATE and resp.status_code == C.STATUS_CODE_SUCCESS:
                created.append((resp.record.msg_id, a, r))
    assert not rngs
    diff = first_difference(to_numpy(teng.state), jax_leaves(jeng.state), mask_junk=False)
    assert diff is None, f"state differs at {diff}"
    assert port_fast == ref_fast
    assert True in ref_fast and False in ref_fast, "both admission branches must run"
    assert min(ref_free) < b, "the campaign never came within B of full"
    assert 1 < len(reads) < len(port_fast), "the bound and the exact read must both decide"
    # the port adds its round-graph counter (engine/round_graph.py)
    assert set(teng.health()) == set(jeng.health()) | {"round_graph"}
    assert set(teng.metrics.snapshot()) == set(jeng.metrics.snapshot())


def _create(req, rec, tag=1) -> list:
    return [req(request_type=C.REQUEST_TYPE_CREATE, auth_identity=_user(0),
                record=rec(msg_id=bytes(16), recipient=_user(1),
                           payload=bytes([tag]) * C.PAYLOAD_SIZE))]


def test_expiry_period_past_u32_raises_in_both():
    """C1: ``expire(now, 2**32)`` used to wrap to period 0 in the port and
    evict what the reference keeps; both facades raise OverflowError
    before anything changes (and both sweeps), and the record reads
    back."""
    jeng = JEngine(JConfig(**PAIR), seed=2)
    teng = GrapevineEngine(GrapevineConfig(**PAIR), seed=2, device="cpu")
    (jc,) = jeng.handle_queries(_create(JReq, JRec), NOW)
    (tc,) = teng.handle_queries(_create(QueryRequest, RequestRecord), NOW)
    assert jc.status_code == tc.status_code == C.STATUS_CODE_SUCCESS
    for eng in (jeng, teng):
        with pytest.raises(OverflowError):
            eng.expire(NOW + 10, 2**32)
        assert eng.expire(NOW + 10, -1) == 0
        assert eng.message_count() == 1
    with pytest.raises(OverflowError):
        jax_sweep(jeng.ecfg, jeng.state, NOW, 2**32)
    for period in (2**32, -1):
        with pytest.raises(OverflowError):
            expiry_sweep(teng.ecfg, teng.state, NOW, period)
    (back,) = teng.handle_queries([QueryRequest(
        request_type=C.REQUEST_TYPE_READ, auth_identity=_user(1),
        record=RequestRecord(msg_id=tc.record.msg_id))], NOW + 11)
    assert back.status_code == C.STATUS_CODE_SUCCESS
    assert back.record.payload == bytes([1]) * C.PAYLOAD_SIZE


def test_transcript_path_and_clock_checks_match_reference(tmp_path):
    """C2: the transcript variant runs no checkpoint cadence (even with a
    checkpoint due every record) and accepts ``now=0`` in both facades;
    ``handle_queries`` refuses a round at ``now=0`` in both, where an
    empty call returns nothing. The port checks the clock only where the
    reference does (``_assemble_round``)."""
    engines = (
        JEngine(JConfig(**PAIR), seed=4, durability=JDur(
            state_dir=str(tmp_path / "j"), checkpoint_every_rounds=1)),
        GrapevineEngine(GrapevineConfig(**PAIR), seed=4, device="cpu",
                        durability=DurabilityConfig(state_dir=str(tmp_path / "t"),
                                                    checkpoint_every_rounds=1)),
    )
    for eng, (req, rec) in zip(engines, ((JReq, JRec), (QueryRequest, RequestRecord))):
        resp, transcript = eng.handle_queries_with_transcript(_create(req, rec), 0)
        assert resp[0].status_code == C.STATUS_CODE_SUCCESS
        assert np.asarray(transcript).shape == (4, 2 * eng.ecfg.mb_choices + 1)
        assert eng.durability.seq == 1 and eng.durability.ckpt_seq == 0
        assert eng.handle_queries([], 0) == []
        with pytest.raises(ValueError, match="clock"):
            eng.handle_queries(_create(req, rec), 0)
        assert eng.durability.seq == 1
        assert not [n for n in os.listdir(eng.durability.dcfg.state_dir)
                    if n.startswith("ckpt-")]
        eng.close()
