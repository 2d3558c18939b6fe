"""The traffic generator: the same seed gives the same rounds, and every
seed the same amount of each kind of work."""

from collections import Counter

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
