"""The traffic generator: the same seed gives the same rounds, and every
seed the same amount of each kind of work; a sequence's kinds round by
round, and its refusals."""

from collections import Counter

import pytest

from gvbench import traffic

KW = dict(batch_size=64, max_recipients=512, payload_size=936)


def test_same_seed_same_rounds():
    params = traffic.load("zipf_closed")
    a = traffic.Traffic(params, seed=2**31 + 11, **KW)
    b = traffic.Traffic(params, seed=2**31 + 11, **KW)
    c = traffic.Traffic(params, seed=2**31 + 12, **KW)
    assert a.rounds == b.rounds
    assert a.rounds != c.rounds
    assert [a.now(k) for k in range(5)] == [b.now(k) for k in range(5)]


def test_every_round_holds_the_mix_at_its_shares():
    params = traffic.load("zipf_closed")
    for seed in (1, 2**33 + 5):
        t = traffic.Traffic(params, seed=seed, **KW)
        assert len(t.rounds) == params["distinct_rounds"]
        for ops in t.rounds:
            assert len(ops) == 64
            assert Counter(op[0] for op in ops) == {1: 32, 2: 19, 4: 13}
            for kind, auth, mid, rcp, pay in ops:
                assert len(auth) == 32 and auth != bytes(32)
                assert mid == bytes(16) and len(pay) == 936
                assert (rcp != bytes(32)) == (kind == 1)


def test_zipf_recipients_are_skewed_and_the_pool_is_a_quarter():
    params = traffic.load("zipf_closed")
    t = traffic.Traffic(params, seed=3, **KW)
    assert len(t.identities) == 128
    hits = Counter(op[3] for ops in t.rounds for op in ops if op[0] == 1)
    top = hits.most_common(1)[0][1] / sum(hits.values())
    # rank 1 of 128 at theta 0.99 draws 1 / H(128, 0.99) ~ 18% of creates
    assert 0.12 < top < 0.25


def test_readback_samples_from_the_seed():
    params = traffic.load("zipf_closed")
    t = traffic.Traffic(params, seed=5, **KW)
    acked = [(bytes([i]) * 16, bytes([i]) * 32, bytes([i + 1]) * 32) for i in range(1, 40)]
    rb = t.readback(acked)
    assert rb == traffic.Traffic(params, seed=5, **KW).readback(acked)
    assert len(rb) == params["readback_rounds"] and all(len(r) == 64 for r in rb)
    for ops in rb:
        for kind, auth, mid, rcp, _pay in ops:
            m = acked[mid[0] - 1]
            assert kind == 2 and mid == m[0] and auth in (m[1], m[2]) and rcp == bytes(32)


def test_a_sequence_cycles_its_kinds_round_by_round():
    """``single_client``: every round one op, CREATE, READ, DELETE in turn
    from the first warm-up round on, through the cycle's wrap and on into
    the window, all from one identity that writes to itself."""
    params = traffic.load("single_client")
    t = traffic.Traffic(params, seed=2**31 + 21, batch_size=2048, max_recipients=2**17,
                        payload_size=936)
    assert len(t.identities) == 1
    me = t.identities[0]
    n = params["distinct_rounds"]
    assert n % 3 == 0 and t.warmup % 3 == 0
    for k in list(range(2 * n + 7)):
        ops = t.ops(k)
        assert len(ops) == 1
        kind, auth, mid, rcp, pay = ops[0]
        assert kind == (1, 2, 4)[k % 3]
        assert auth == me and mid == bytes(16)
        assert rcp == (me if kind == 1 else bytes(32))
        assert (pay != bytes(936)) == (kind == 1)
    assert t.ops(t.warmup)[0][0] == 1
    assert t.rounds == traffic.Traffic(params, seed=2**31 + 21, batch_size=2048,
                                       max_recipients=2**17, payload_size=936).rounds


def test_a_sequence_with_several_ops_a_round():
    params = dict(traffic.load("single_client"), ops_per_round=5)
    t = traffic.Traffic(params, seed=4, **KW)
    for k, ops in enumerate(t.rounds):
        assert Counter(op[0] for op in ops) == {(1, 2, 4)[k % 3]: 5}


@pytest.mark.parametrize("key,value", [("distinct_rounds", 61), ("warmup_rounds", 4)])
def test_a_sequence_refuses_a_cycle_that_would_break_its_order(key, value):
    params = dict(traffic.load("single_client"), **{key: value})
    with pytest.raises(ValueError, match="multiples of the sequence's length"):
        traffic.Traffic(params, seed=1, **KW)


def test_a_zipf_draw_needs_its_constant():
    params = dict(traffic.load("zipf_closed"))
    del params["zipf_theta"]
    with pytest.raises(ValueError, match="zipf_theta"):
        traffic.Traffic(params, seed=1, **KW)
