"""The port's expiry sweep held against the JAX package.

``grapevine_tpu``'s ``expiry_sweep`` and the port's run on one
carried-across state after a few CRUD rounds (fed the same batches and
random draws): full state equal after the sweep (tolerance 0, junk bucket
masked under the fused impls), then one more round with equal responses,
transcripts and state. Clocks are chosen so that some records and mailbox
entries expire, some mailboxes empty completely, and records stamped
ahead of the sweep's clock survive (the wraparound guard). At
``evict_every=4`` the sweep runs mid-window with the eviction buffer not
empty. This file runs the ``"jnp"`` cipher at ``evict_every=1`` without
a tree-top cache (k=0); the ``test_torch_expiry_*.py`` files run k=4,
``evict_every=4`` and the ``"pallas_fused"`` impl (its plain versions on
the CPU), one JAX compile pair each, to keep every file short. Plus the
free-list partition (``partition_rank``), the u64 clock helpers and the
chunk sizing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.expiry import expiry_sweep as jax_sweep
from grapevine_tpu.engine.state import EngineConfig as JEcfg, init_engine
from grapevine_tpu.oblivious import primitives as jprim
from grapevine_tpu.oblivious.radix import partition_rank as jax_partition_rank
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import batch_to_device
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.expiry import _chunk_rows, expiry_sweep
from grapevine_tpu_torch.engine.round_step import (
    RoundDraws,
    engine_flush_step,
    engine_round_step,
)
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.oblivious import primitives as tprim
from grapevine_tpu_torch.oblivious.radix import partition_rank
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.u32 import to_numpy as t2n
from grapevine_tpu_torch.wire import constants as C
from test_torch_engine import GEOMETRIES, NOW, _jax_step, crud_batches, jax_draws, jax_leaves
from test_torch_engine_evict import _jax_flush

#: jitted as the reference's GrapevineEngine jits its sweep
_jax_sweep = jax.jit(jax_sweep, static_argnums=(0,), donate_argnums=(1,))

#: round clocks: round 2 is stamped far ahead of the sweep clock (it must
#: survive); rounds 0-1 expire under SWEEP_NOW/PERIOD, rounds 3+ do not
CLOCK = (NOW, NOW + 10, NOW + 1000, NOW + 30, NOW + 40, NOW + 50, NOW + 60)
SWEEP_NOW, PERIOD = NOW + 35, 12
#: recipients written only in round 0, whose mailboxes empty in the sweep
LONELY = (bytes([100]) * 32, bytes([101]) * 32)


def run_expiry_case(geo: str, seed: int, k: int, impl: str, evict_every: int):
    """A few CRUD rounds (at ``evict_every`` 4: one whole window and two
    buffered rounds), the sweep, one more round; both packages compared
    after every step."""
    kw = dict(GEOMETRIES[geo], tree_top_cache_levels=k, bucket_cipher_impl=impl,
              vphases_impl="dense", evict_every=evict_every)
    jecfg = JEcfg.from_config(JConfig(**kw))
    tecfg = EngineConfig.from_config(GrapevineConfig(**kw))
    jst = init_engine(jecfg, seed)
    tst = from_jax_state(tecfg, jax_leaves(jst), device="cpu")
    mask = impl != "jnp"
    b = tecfg.batch_size
    n_before = 6 if evict_every > 1 else 4
    created: list = []
    batches = crud_batches(b, n_before + 1, seed, lambda: created)

    def step(rnd, batch, where):
        nonlocal jst, tst
        batch = dict(batch, now=np.uint32(CLOCK[rnd]))
        draws = RoundDraws(*(from_numpy(x, "cpu") for x in jax_draws(jecfg, jst.rng, b)))
        jst, jresp, jtr = _jax_step(jecfg, jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst, tresp, ttr = engine_round_step(tecfg, tst, batch_to_device(batch, "cpu"),
                                            draws=draws)
        for key in jresp:
            np.testing.assert_array_equal(t2n(tresp[key]), np.asarray(jresp[key]),
                                          f"{where}: response {key}")
        np.testing.assert_array_equal(t2n(ttr), np.asarray(jtr), f"{where}: transcript")
        diff = first_difference(to_numpy(tst), jax_leaves(jst), mask_junk=mask)
        assert diff is None, f"{where}: state differs at {diff}"
        if evict_every > 1 and (rnd + 1) % evict_every == 0:
            jst = _jax_flush(jecfg, jst)
            tst = engine_flush_step(tecfg, tst)
        st = np.asarray(jresp["status"])
        for i in np.flatnonzero((batch["req_type"] == C.REQUEST_TYPE_CREATE)
                                & (st == C.STATUS_CODE_SUCCESS)):
            rcp = batch["recipient"][i].tobytes()
            if rcp not in LONELY:  # nothing touches the lonely mailboxes again
                created.append((np.asarray(jresp["msg_id"])[i].tobytes(),
                                batch["auth"][i].tobytes(), rcp))

    where = f"{geo}/{impl}/k={k}/E={evict_every}/seed={seed}"
    for rnd in range(n_before):
        batch = next(batches)
        if rnd == 0:  # two creates into mailboxes nothing else writes
            for slot, rcp in enumerate(LONELY):
                batch["req_type"][slot] = C.REQUEST_TYPE_CREATE
                batch["recipient"][slot] = np.frombuffer(rcp, "<u4")
                batch["msg_id"][slot] = 0
        step(rnd, batch, f"{where} round {rnd}")
    if evict_every > 1:  # mid-window, the buffer holds live rows
        assert int(tst.rec.ebuf_rounds) == n_before % evict_every
        assert int((tst.rec.ebuf_idx != -1).sum()) > 0
        assert int((tst.mb.ebuf_idx != -1).sum()) > 0
    free0, recips0 = int(tst.free_top), int(tst.recipients)
    epochs0 = (t2n(tst.rec.epoch).copy(), t2n(tst.mb.epoch).copy())

    jst = _jax_sweep(jecfg, jst, np.uint32(SWEEP_NOW), np.uint32(PERIOD), np.uint32(0))
    tst = expiry_sweep(tecfg, tst, SWEEP_NOW, PERIOD, 0)
    diff = first_difference(to_numpy(tst), jax_leaves(jst), mask_junk=mask)
    assert diff is None, f"{where}: state after the sweep differs at {diff}"
    # something expired, some mailbox emptied, something survived
    assert free0 < int(tst.free_top) < tecfg.max_messages, where
    assert 0 < int(tst.recipients) < recips0, where
    if tecfg.rec.encrypted:
        for o, e0 in zip((tst.rec, tst.mb), epochs0):
            assert (t2n(o.nonces) == e0).all(), where
            assert int(t2n(o.epoch)[0]) == int(e0[0]) + 1, where
    step(n_before, next(batches), f"{where} round after the sweep")
    assert int(tst.rec.overflow) == int(tst.mb.overflow) == 0


@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_expiry_matches_jax_jnp(geo, seed):
    run_expiry_case(geo, seed, 0, "jnp", 1)


def test_chunk_rows_matches_reference_sizing():
    """The chunking of the production trees: records 4096 rows of 1028
    words (256 chunks), mailbox 1024 rows of 6084 words (2 chunks)."""
    from grapevine_tpu.engine.expiry import _chunk_rows as jax_chunk_rows

    kw = dict(max_messages=2**20, max_recipients=2**12, batch_size=2048)
    t = EngineConfig.from_config(GrapevineConfig(**kw))
    assert [_chunk_rows(t.rec), _chunk_rows(t.mb)] == [4096, 1024]
    assert [t.rec.row_words, t.mb.row_words] == [1028, 6084]
    assert [t.rec.n_buckets_padded // 4096, t.mb.n_buckets_padded // 1024] == [256, 2]
    for g in (dict(GEOMETRIES["g1"]), dict(GEOMETRIES["g2"]), kw):
        te, je = EngineConfig.from_config(GrapevineConfig(**g)), JEcfg.from_config(JConfig(**g))
        assert [_chunk_rows(te.rec), _chunk_rows(te.mb)] == [
            jax_chunk_rows(je.rec), jax_chunk_rows(je.mb)]


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_partition_rank_matches_jax(n):
    rng = np.random.default_rng(n)
    for flags in (rng.random(n) < 0.5, np.ones(n, bool), np.zeros(n, bool),
                  rng.random(n) < 0.05):
        got = partition_rank(torch.from_numpy(flags)).numpy()
        want = np.asarray(jax_partition_rank(jnp.asarray(flags)))
        np.testing.assert_array_equal(got, want)
        assert sorted(got.tolist()) == list(range(n))


def test_u64_clock_helpers_match_jax():
    rng = np.random.default_rng(5)
    edge = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    a = np.concatenate([edge, rng.integers(0, 2**32, 64, dtype=np.uint64).astype(np.uint32)])
    lanes = [np.array(np.meshgrid(a, a, indexing="ij")).reshape(2, -1)[i] for i in (0, 1)]
    a_lo, b_lo = lanes
    a_hi, b_hi = np.roll(a_lo, 3), np.roll(b_lo, 7)
    tl = [from_numpy(x, "cpu") for x in (a_lo, a_hi, b_lo, b_hi)]
    jl = [jnp.asarray(x) for x in (a_lo, a_hi, b_lo, b_hi)]
    # equal-high-lane pairs exercise the low-lane compare
    tl[3], jl[3] = tl[1], jl[1]
    np.testing.assert_array_equal(tprim.u64_le(*tl).numpy(), np.asarray(jprim.u64_le(*jl)))
    for got, want in zip(tprim.u64_sub(*tl), jprim.u64_sub(*jl)):
        np.testing.assert_array_equal(t2n(got), np.asarray(want))
