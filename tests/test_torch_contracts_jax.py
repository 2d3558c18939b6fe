"""The reference's test-only contracts, the port held against the JAX
engine (one JAX ``engine_round_step`` compile, at one geometry, shared by
every test here; the sweep is a second, smaller one).

Both ``GrapevineEngine`` facades serve the same calls from one
carried-across initial state, the port fed the reference's random draws
round by round (as ``tests/test_torch_pipeline_jax.py`` does). After
every call the response bytes and the ``seq`` lanes must be equal, and
at the end the whole state (``convert.first_difference``, tolerance 0;
the cipher is off, so no junk bucket is masked). The cases are the
u64-lane contracts of ``tests/test_u64_lanes.py`` (a post-2106 round
trip, pops across a wrapped ``seq``, expiry across 2^32), the same-key
hazards of ``tests/test_same_key_ordering.py`` (the round-2 reproduction
and three 4-op orderings in one call, then a drain), and the first 24
creates of ``tests/test_mailbox_load.py``'s load-1.0 fill.
"""

from collections import deque

import jax.numpy as jnp
import numpy as np

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.batcher import GrapevineEngine as JEngine
from grapevine_tpu.wire.records import QueryRequest as JReq, RequestRecord as JRec
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine import batcher
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.round_step import RoundDraws
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.u32 import to_numpy as t2n
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from test_torch_engine import jax_draws, jax_leaves
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

NOW = 1_700_000_000
FUTURE = (1 << 32) + 12_345
CREATE, READ, UPDATE, DELETE = (C.REQUEST_TYPE_CREATE, C.REQUEST_TYPE_READ,
                                C.REQUEST_TYPE_UPDATE, C.REQUEST_TYPE_DELETE)
#: the geometry of the load-1.0 fill (16 mailbox buckets of 4), wide enough
#: for the other contracts
PAIR = dict(max_messages=256, max_recipients=64, mailbox_cap=4, batch_size=8,
            stash_size=96, mailbox_load=1.0, bucket_cipher_rounds=0,
            vphases_impl="dense")


def key(n: int) -> bytes:
    return n.to_bytes(4, "little") + b"\x02" * 28


class Twin:
    """The JAX facade and the port's on one state, the port fed the JAX
    round's draws."""

    def __init__(self, monkeypatch, seed: int):
        self.j = JEngine(JConfig(**PAIR), seed=seed)
        self.t = GrapevineEngine(GrapevineConfig(**PAIR), seed=seed, device="cpu")
        self.t.state = from_jax_state(self.t.ecfg, jax_leaves(self.j.state), seed=seed,
                                      device="cpu")
        self.rounds = 0
        rngs: deque = deque()
        jstep = self.j._step

        def recording_step(ecfg, state, batch):
            rngs.append(np.asarray(state.rng))
            return jstep(ecfg, state, batch)

        self.j._step = recording_step
        tstep = batcher.engine_round_step
        b = self.t.ecfg.batch_size

        def fed_step(ecfg, state, dev_batch, fast_ok=None):
            draws = RoundDraws(*(from_numpy(x, "cpu")
                                 for x in jax_draws(self.j.ecfg, rngs.popleft(), b)))
            self.rounds += 1
            return tstep(ecfg, state, dev_batch, draws=draws, fast_ok=fast_ok)

        monkeypatch.setattr(batcher, "engine_round_step", fed_step)
        self.rngs = rngs

    def call(self, ops: list, now: int) -> list:
        """One ``handle_queries`` call in both; ``ops`` are (type, auth,
        recipient, msg_id, payload byte). Returns the port's responses."""
        def reqs(req, rec):
            return [req(request_type=t, auth_identity=a, auth_signature=b"\x01" * 64,
                        record=rec(msg_id=m, recipient=r, payload=bytes([p & 0xFF]) *
                                   C.PAYLOAD_SIZE))
                    for t, a, r, m, p in ops]

        jr = self.j.handle_queries(reqs(JReq, JRec), now)
        tr = self.t.handle_queries(reqs(QueryRequest, RequestRecord), now)
        assert [r.pack() for r in tr] == [r.pack() for r in jr], f"call at {now}"
        assert t2n(self.t.state.seq).tolist() == np.asarray(self.j.state.seq).tolist()
        assert not self.rngs
        return tr

    def set_seq(self, lo: int, hi: int) -> None:
        seq = np.asarray([lo, hi], np.uint32)
        self.j.state = self.j.state._replace(seq=jnp.asarray(seq))
        self.t.state = self.t.state._replace(seq=from_numpy(seq, "cpu"))

    def check_state(self) -> None:
        diff = first_difference(to_numpy(self.t.state), jax_leaves(self.j.state),
                                mask_junk=False)
        assert diff is None, f"state differs at {diff}"
        assert self.t.message_count() == self.j.message_count()
        assert self.t.recipient_count() == self.j.recipient_count()


A, B = b"\x11" * 32, b"\x22" * 32
Z16 = bytes(16)


def test_post_2106_round_trip_equals_jax(monkeypatch):
    tw = Twin(monkeypatch, seed=4)
    (r,) = tw.call([(CREATE, A, B, Z16, 7)], FUTURE)
    assert r.status_code == C.STATUS_CODE_SUCCESS and r.record.timestamp == FUTURE
    mid = r.record.msg_id
    (r2,) = tw.call([(READ, B, bytes(32), Z16, 0)], FUTURE + 5)
    assert r2.record.timestamp == FUTURE
    tw.call([(UPDATE, A, B, mid, 8)], FUTURE + 9)
    (r4,) = tw.call([(READ, B, bytes(32), Z16, 0)], FUTURE + 10)
    assert r4.record.timestamp == FUTURE + 9
    assert tw.rounds == 4
    tw.check_state()


def test_wrapped_seq_pops_equal_jax(monkeypatch):
    tw = Twin(monkeypatch, seed=4)
    tw.set_seq(0xFFFFFFFE, 0)
    # three creates in one round straddle the wrap; two more after it
    tw.call([(CREATE, A, B, Z16, 1), (CREATE, A, B, Z16, 2), (CREATE, A, B, Z16, 3)], 1000)
    assert t2n(tw.t.state.seq)[1] == 1  # the low lane wrapped in that round
    tw.call([(CREATE, A, B, Z16, 4)], 1001)
    pops = [tw.call([(DELETE, B, bytes(32), Z16, 0)], 1002 + i)[0] for i in range(4)]
    assert [p.record.payload[0] for p in pops] == [1, 2, 3, 4]
    (empty,) = tw.call([(DELETE, B, bytes(32), Z16, 0)], 1010)
    assert empty.status_code == C.STATUS_CODE_NOT_FOUND
    tw.check_state()


def test_expiry_across_u32_equals_jax(monkeypatch):
    tw = Twin(monkeypatch, seed=4)
    t0 = (1 << 32) - 50
    tw.call([(CREATE, A, B, Z16, 1), (CREATE, B, A, Z16, 2)], t0)
    tw.call([(CREATE, A, key(3), Z16, 3)], t0 + 70)  # after the boundary: kept
    assert tw.t.expire(t0 + 100, period=60) == tw.j.expire(t0 + 100, period=60) == 2
    tw.check_state()
    reads = tw.call([(READ, B, bytes(32), Z16, 0), (READ, A, bytes(32), Z16, 0),
                     (READ, key(3), bytes(32), Z16, 0)], t0 + 101)
    assert [r.status_code for r in reads] == [C.STATUS_CODE_NOT_FOUND] * 2 + [
        C.STATUS_CODE_SUCCESS]
    assert tw.t.expire(t0 + 102, period=60) == tw.j.expire(t0 + 102, period=60) == 0
    tw.check_state()


def test_same_key_hazards_equal_jax(monkeypatch):
    """The round-2 reproduction (a zero-id READ by X before the first
    CREATE to X, X's mailbox absent) and three 4-op orderings, each on a
    recipient of its own, in one call of two rounds; then a drain."""
    tw = Twin(monkeypatch, seed=11)
    s = key(500)
    x = [key(600 + i) for i in range(4)]
    orderings = [("zread", "create"),
                 ("zread", "zdel", "create", "create"),
                 ("zdel", "zread", "create", "zread"),
                 ("create", "zdel", "zread", "create")]
    # one message already waits for the last recipient
    tw.call([(CREATE, s, x[3], Z16, 99)], NOW)
    ops = []
    for r, perm in zip(x, orderings):
        for i, kind in enumerate(perm):
            ops.append({"create": (CREATE, s, r, Z16, 10 + i),
                        "zread": (READ, r, bytes(32), Z16, 0),
                        "zdel": (DELETE, r, bytes(32), Z16, 0)}[kind])
    resp = tw.call(ops, NOW + 1)
    assert resp[1].status_code == C.STATUS_CODE_SUCCESS  # the reproduction's create
    (follow,) = tw.call([(READ, x[0], bytes(32), Z16, 0)], NOW + 2)
    assert follow.status_code == C.STATUS_CODE_SUCCESS
    assert follow.record.msg_id == resp[1].record.msg_id
    for t in range(3):
        tw.call([(DELETE, r, bytes(32), Z16, 0) for r in x], NOW + 3 + t)
    assert tw.t.message_count() == 0
    tw.check_state()


def test_load_fill_first_creates_equal_jax(monkeypatch):
    """The first 24 creates of the load-1.0 fill, one a call, at the
    reference's seed."""
    tw = Twin(monkeypatch, seed=13)
    sender = key(9999)
    statuses = [tw.call([(CREATE, sender, key(i), Z16, i)], NOW)[0].status_code
                for i in range(24)]
    assert set(statuses) <= {C.STATUS_CODE_SUCCESS, C.STATUS_CODE_TOO_MANY_RECIPIENTS}
    assert tw.t.recipient_count() == statuses.count(C.STATUS_CODE_SUCCESS)
    tw.check_state()
