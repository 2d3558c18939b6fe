"""u64 timestamp and ``seq`` lanes in the port (the JAX package's
``tests/test_u64_lanes.py`` is the model, case for case).

The port keeps every u32 lane in an int32 tensor
(``grapevine_tpu_torch/u32.py``), so each value here sits where that
encoding breaks if one signed compare slips in: a post-2106 clock
(2^32 + 12,345), stamps at 2^32 - 50 swept at 2^32 + 50, and a ``seq``
counter forced to (0xFFFFFFFE, 0) before two creates. Each engine is the
port's facade on the CPU. The lane helpers of
``oblivious/primitives.py`` are checked on int32 lanes holding values at
and above 2^31, and value for value against the JAX package's over a few
hundred seeded pairs that include 0, 2^31 - 1, 2^31 and 2^32 - 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grapevine_tpu.oblivious import primitives as jprim
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.oblivious.primitives import lex_argsort, u64_add_u32, u64_le, u64_sub
from grapevine_tpu_torch.u32 import c32, from_numpy, to_numpy
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

#: a post-2106 clock: 2**32 + a bit (u32 seconds would have wrapped)
FUTURE = (1 << 32) + 12_345


def _mk(commit="phase"):
    cfg = GrapevineConfig(
        bucket_cipher_rounds=0,
        max_messages=128,
        max_recipients=16,
        mailbox_cap=4,
        batch_size=4,
        commit=commit,
        mailbox_choices=1 if commit == "op" else None,
    )
    return GrapevineEngine(cfg, seed=4, device="cpu")


def req(rt, auth, msg_id=C.ZERO_MSG_ID, recipient=C.ZERO_PUBKEY, tag=0):
    return QueryRequest(
        request_type=rt,
        auth_identity=auth,
        record=RequestRecord(
            msg_id=msg_id,
            recipient=recipient,
            payload=bytes([tag]) * C.PAYLOAD_SIZE,
        ),
    )


def _post_2106_round_trip(commits):
    for commit in commits:
        e = _mk(commit)
        a, b = b"\x11" * 32, b"\x22" * 32
        r = e.handle_queries([req(1, a, recipient=b, tag=7)], FUTURE)[0]
        assert r.status_code == C.STATUS_CODE_SUCCESS
        assert r.record.timestamp == FUTURE, commit
        r2 = e.handle_queries([req(2, b)], FUTURE + 5)[0]
        assert r2.status_code == C.STATUS_CODE_SUCCESS
        assert r2.record.timestamp == FUTURE  # stored ts, not the clock
        # UPDATE refreshes to the new post-2106 clock
        r3 = e.handle_queries(
            [req(3, a, msg_id=r.record.msg_id, recipient=b, tag=8)],
            FUTURE + 9,
        )[0]
        assert r3.status_code == C.STATUS_CODE_SUCCESS
        r4 = e.handle_queries([req(2, b)], FUTURE + 10)[0]
        assert r4.record.timestamp == FUTURE + 9, commit


def test_post_2106_timestamps_round_trip():
    """CREATE at a post-2106 clock returns the full u64 timestamp, READ
    echoes it, UPDATE refreshes it: the phase-major engine (the op-major
    arm rides ``-m slow``, as in the reference)."""
    _post_2106_round_trip(("phase",))


@pytest.mark.slow  # the op-major breadth arm, as the reference places it
def test_post_2106_timestamps_round_trip_op_commit():
    _post_2106_round_trip(("op",))


def test_expiry_across_the_u32_boundary():
    """Records stamped below 2^32 expire under a sweep clock above it; a
    record stamped after the boundary does not."""
    e = _mk()
    a, b = b"\x11" * 32, b"\x22" * 32
    t0 = (1 << 32) - 50  # pre-boundary stamp
    r = e.handle_queries([req(1, a, recipient=b)], t0)[0]
    assert r.status_code == C.STATUS_CODE_SUCCESS
    # 100 s later the clock has crossed 2^32; period 60 ⇒ expired
    assert e.expire(t0 + 100, period=60) == 1
    r2 = e.handle_queries([req(2, b)], t0 + 101)[0]
    assert r2.status_code == C.STATUS_CODE_NOT_FOUND
    # and a fresh record at the post-boundary clock does NOT expire
    r3 = e.handle_queries([req(1, a, recipient=b)], t0 + 101)[0]
    assert r3.status_code == C.STATUS_CODE_SUCCESS
    assert e.expire(t0 + 102, period=60) == 0


def test_mailbox_order_across_wrapped_seq():
    """Pop-oldest is by the full 64-bit ``seq``: an entry created after the
    low lane wraps (hi 1, lo small) pops AFTER the pre-wrap one (hi 0, lo
    0xFFFFFFFE, an int32 lane of -2)."""
    e = _mk()
    seq = np.asarray([0xFFFFFFFE, 0], np.uint32)
    e.state = e.state._replace(seq=from_numpy(seq, e.device))
    a, b = b"\x11" * 32, b"\x22" * 32
    r1 = e.handle_queries([req(1, a, recipient=b, tag=1)], 1000)[0]
    assert r1.status_code == C.STATUS_CODE_SUCCESS
    # seq has advanced past the wrap (hi lane = 1 now)
    assert int(to_numpy(e.state.seq)[1]) == 1
    r2 = e.handle_queries([req(1, a, recipient=b, tag=2)], 1001)[0]
    assert r2.status_code == C.STATUS_CODE_SUCCESS
    pop1 = e.handle_queries([req(4, b)], 1002)[0]  # zero-id delete = pop
    assert pop1.record.payload[0] == 1, "oldest (pre-wrap) must pop first"
    pop2 = e.handle_queries([req(4, b)], 1003)[0]
    assert pop2.record.payload[0] == 2


def _lanes(*vals):
    return from_numpy(np.asarray(vals, np.uint32), "cpu")


def test_u64_lane_helpers():
    """The reference's directed values, then the same helpers on int32
    lanes whose u32 values are at or above 2^31 (negative as int32)."""
    lo, hi = u64_add_u32(_lanes(0xFFFFFFFF), _lanes(7), _lanes(1))
    assert (to_numpy(lo).tolist(), to_numpy(hi).tolist()) == ([0], [8])
    d_lo, d_hi = u64_sub(_lanes(2), _lanes(5), _lanes(0xFFFFFFFF), _lanes(4))
    assert (to_numpy(d_lo).tolist(), to_numpy(d_hi).tolist()) == ([3], [0])
    order = lex_argsort(_lanes(5, 1, 9), _lanes(0, 2, 0))
    assert order.tolist() == [0, 2, 1]  # (0,5) < (0,9) < (2,1)

    # high lanes: 2^31 + 1 + 2^31 - 1 carries; 0x80000000 > 0x7FFFFFFF
    lo, hi = u64_add_u32(_lanes(0x80000001), _lanes(0xFFFFFFFE), _lanes(0x7FFFFFFF))
    assert (to_numpy(lo).tolist(), to_numpy(hi).tolist()) == ([0], [0xFFFFFFFF])
    assert u64_le(_lanes(0x7FFFFFFF), _lanes(0), _lanes(0x80000000), _lanes(0)).tolist() == [True]
    assert u64_le(_lanes(0), _lanes(0x80000000), _lanes(0xFFFFFFFF), _lanes(0x7FFFFFFF)
                  ).tolist() == [False]
    d_lo, d_hi = u64_sub(_lanes(0), _lanes(0x80000000), _lanes(1), _lanes(0))
    assert (to_numpy(d_lo).tolist(), to_numpy(d_hi).tolist()) == ([0xFFFFFFFF], [0x7FFFFFFF])
    order = lex_argsort(_lanes(0xFFFFFFFE, 3, 0x80000000, 0x7FFFFFFF),
                        _lanes(0, 1, 0, 0))
    assert order.tolist() == [3, 2, 0, 1]
    assert torch.equal(_lanes(0x80000000), torch.tensor([c32(0x80000000)], dtype=torch.int32))


EDGES = np.asarray([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1], np.uint64)


@pytest.mark.parametrize("seed", [0, 1])
def test_u64_lane_helpers_equal_jax(seed):
    """Value for value against ``grapevine_tpu.oblivious.primitives`` over
    seeded u32 lanes, every pair of edge values included."""
    rng = np.random.default_rng(seed)
    n = 300
    cols = []
    for _ in range(5):
        x = rng.integers(0, 2**32, n, dtype=np.uint64)
        edge = rng.random(n) < 0.4
        x[edge] = rng.choice(EDGES, int(edge.sum()))
        cols.append(x.astype(np.uint32))
    a_lo, a_hi, b_lo, b_hi, k = cols
    # every ordered pair of edges at the head, equal hi lanes among them
    e = EDGES.astype(np.uint32)
    m = len(e) * len(e)
    a_lo[:m], b_lo[:m] = np.repeat(e, len(e)), np.tile(e, len(e))
    a_hi[:m], b_hi[:m] = np.tile(e, len(e)), np.tile(e, len(e))
    k[:m] = np.repeat(e, len(e))
    t = {name: from_numpy(v, "cpu") for name, v in
         dict(a_lo=a_lo, a_hi=a_hi, b_lo=b_lo, b_hi=b_hi, k=k).items()}
    j = {name: jnp.asarray(v) for name, v in
         dict(a_lo=a_lo, a_hi=a_hi, b_lo=b_lo, b_hi=b_hi, k=k).items()}

    for got, want in zip(u64_add_u32(t["a_lo"], t["a_hi"], t["k"]),
                         jprim.u64_add_u32(j["a_lo"], j["a_hi"], j["k"])):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    for got, want in zip(u64_sub(t["a_lo"], t["a_hi"], t["b_lo"], t["b_hi"]),
                         jprim.u64_sub(j["a_lo"], j["a_hi"], j["b_lo"], j["b_hi"])):
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
    np.testing.assert_array_equal(
        u64_le(t["a_lo"], t["a_hi"], t["b_lo"], t["b_hi"]).numpy(),
        np.asarray(jprim.u64_le(j["a_lo"], j["a_hi"], j["b_lo"], j["b_hi"])))
    # a stable sort: ties (repeated edge keys) keep lane order in both
    np.testing.assert_array_equal(lex_argsort(t["a_lo"], t["a_hi"]).numpy(),
                                  np.asarray(jprim.lex_argsort(j["a_lo"], j["a_hi"])))
    # and a batch of rows sorted along the last axis
    np.testing.assert_array_equal(
        lex_argsort(t["b_lo"].reshape(20, 15), t["b_hi"].reshape(20, 15)).numpy(),
        np.asarray(jprim.lex_argsort(j["b_lo"].reshape(20, 15), j["b_hi"].reshape(20, 15))))
