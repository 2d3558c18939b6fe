"""The port's ``BatchScheduler`` (``grapevine_tpu_torch/server/scheduler.py``)
over the port's CPU engine, held against the reference's scheduler over
the JAX engine (one JAX compile: the round at one small geometry).

Both schedulers get the same signed ops, with windows made deterministic
(``max_wait_ms`` and ``idle_gap_ms`` far beyond the test, so only a full
batch closes a window); the port's engine starts from the reference's
state (``convert.from_jax_state``) and is fed the reference's random draws
round by round, as ``test_torch_pipeline_jax.py`` does. At pipeline depth
1 and 2: byte-equal responses (tolerance 0), equal state at the end, a
bad signature rejected by both with the op reaching neither engine, and
``close()`` settling queued ops with ``SchedulerShutdown`` in both.
Modelled on the reference's ``tests/test_scheduler.py``."""

import random
from collections import deque

import numpy as np
import pytest

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.batcher import GrapevineEngine as JEngine
from grapevine_tpu.server import scheduler as jsched
from grapevine_tpu.wire.records import QueryRequest as JReq, RequestRecord as JRec
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine import batcher
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.round_step import RoundDraws
from grapevine_tpu_torch.server import scheduler as tsched
from grapevine_tpu_torch.session import schnorrkel
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, QueryResponse, RequestRecord
from test_torch_engine import jax_draws, jax_leaves

NOW = 1_700_000_000
CTX = C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT
GEO = dict(max_messages=64, max_recipients=16, mailbox_cap=8, batch_size=4,
           stash_size=64, vphases_impl="dense")
#: windows no test reaches: only a full batch (or close()) ends one
WINDOW = dict(max_wait_ms=600_000.0, idle_gap_ms=600_000.0)
USERS = 12
#: each user's key pair (keygen is deterministic in the seed)
KEYS = [schnorrkel.keygen(bytes([i + 1, 0x5C]) * 16) for i in range(USERS)]


def _signed_ops(ops, draw, bad: set):
    """The ops as signed (port request, reference request, auth item)
    triples: user ``a`` signs a fresh challenge; indices in ``bad`` carry
    a marked but bogus signature."""
    out = []
    for k, (t, a, r, m, p) in enumerate(ops):
        sk, pub = KEYS[a]
        challenge = draw.randbytes(32)
        sig = (b"\x01" * 63 + b"\x81") if k in bad else schnorrkel.sign(sk, CTX, challenge)
        rcp = KEYS[r][1]
        f = dict(request_type=t, auth_identity=pub, auth_signature=sig)
        rec = dict(msg_id=m, recipient=rcp, payload=bytes([p & 0xFF]) * C.PAYLOAD_SIZE)
        out.append((QueryRequest(record=RequestRecord(**rec), **f),
                    JReq(record=JRec(**rec), **f), (pub, CTX, challenge, sig)))
    return out


def _plan(rng: random.Random, call: int, created: list) -> list[tuple]:
    """8 ops (2 rounds): creates first, then reads, updates and deletes by
    id of created messages and zero-id reads and deletes."""
    ops = []
    for i in range(8):
        x = rng.random()
        a, r = rng.randrange(USERS), rng.randrange(USERS)
        if call < 2 or not created or x < 0.35:
            ops.append((C.REQUEST_TYPE_CREATE, a, r, bytes(16), call * 16 + i))
        elif x < 0.8:
            mid, snd, rcp = created[rng.randrange(len(created))]
            t = (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_UPDATE, C.REQUEST_TYPE_DELETE)[
                rng.randrange(3)]
            ops.append((t, snd if t == C.REQUEST_TYPE_UPDATE else rcp, rcp, mid, i))
        else:
            t = (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_DELETE)[rng.randrange(2)]
            ops.append((t, r, r, bytes(16), i))
    return ops


def _outcome(fut):
    try:
        return fut.result(timeout=300).pack()
    except Exception as exc:  # the exception's kind is the outcome
        return type(exc).__name__


@pytest.mark.parametrize("depth", [1, 2])
def test_scheduler_matches_reference(depth, monkeypatch):
    jeng = JEngine(JConfig(pipeline_depth=depth, **GEO), seed=41)
    teng = GrapevineEngine(GrapevineConfig(pipeline_depth=depth, **GEO), seed=41,
                           device="cpu")
    teng.state = from_jax_state(teng.ecfg, jax_leaves(jeng.state), seed=41,
                                device=teng.device)
    b = teng.ecfg.batch_size
    rngs: deque = deque()
    jstep = jeng._step

    def recording_step(ecfg, state, batch):
        rngs.append(np.asarray(state.rng))
        return jstep(ecfg, state, batch)

    jeng._step = recording_step
    tstep = batcher.engine_round_step

    def fed_step(ecfg, state, dev_batch, fast_ok=None):
        draws = RoundDraws(*(from_numpy(x, "cpu")
                             for x in jax_draws(jeng.ecfg, rngs.popleft(), b)))
        return tstep(ecfg, state, dev_batch, draws=draws, fast_ok=fast_ok)

    monkeypatch.setattr(batcher, "engine_round_step", fed_step)
    js = jsched.BatchScheduler(jeng, clock=lambda: NOW, **WINDOW)
    ts = tsched.BatchScheduler(teng, clock=lambda: NOW, **WINDOW)
    assert js.pipeline_depth == ts.pipeline_depth == depth
    rng, draw = random.Random(5 + depth), random.Random(9)
    created: list = []
    rejected = 0
    try:
        for call in range(6):
            ops = _plan(rng, call, created)
            bad = {3} if call in (2, 4) else set()
            signed = _signed_ops(ops, draw, bad)
            # the reference first: every one of its rounds has recorded its
            # draws before the port's scheduler dispatches the same rounds
            jf = [js.submit_nowait(jr, auth) for _, jr, auth in signed]
            want = [_outcome(f) for f in jf]
            tf = [ts.submit_nowait(tr, auth) for tr, _, auth in signed]
            got = [_outcome(f) for f in tf]
            assert got == want, f"call {call}"
            for k in bad:
                assert want[k] == "AuthFailure"
            rejected += len(bad)
            for (t, a, r, _m, _p), out in zip(ops, want):
                if t == C.REQUEST_TYPE_CREATE and isinstance(out, bytes):
                    resp = QueryResponse.unpack(out)
                    if resp.status_code == C.STATUS_CODE_SUCCESS:
                        created.append((resp.record.msg_id, a, r))
        assert not rngs
        # the rejected ops reached neither engine: each round that lost one
        # ran one real op short
        for eng in (teng, jeng):
            snap = eng.metrics.snapshot()
            assert snap["rounds"] == 12
            assert snap["real_ops"] == 48 - rejected
            assert snap["auth_failures"] == rejected
        diff = first_difference(to_numpy(teng.state), jax_leaves(jeng.state),
                                mask_junk=False)
        assert diff is None, f"state differs at {diff}"

        # close(): ops queued behind an unfilled window settle with the
        # explicit shutdown error, in both, and reach no round
        jq = [js.submit_nowait(jr, auth) for _, jr, auth in signed[:b - 1]]
        tq = [ts.submit_nowait(tr, auth) for tr, _, auth in signed[:b - 1]]
        js.close()
        ts.close()
        assert [_outcome(f) for f in tq] == [_outcome(f) for f in jq] == \
            ["SchedulerShutdown"] * (b - 1)
        assert teng.metrics.snapshot()["rounds"] == jeng.metrics.snapshot()["rounds"] == 12
        with pytest.raises(tsched.SchedulerShutdown):
            ts.submit_nowait(signed[0][0], signed[0][2])
        assert not ts.worker_alive()
    finally:
        js.close()
        ts.close()
