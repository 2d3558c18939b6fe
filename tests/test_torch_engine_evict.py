"""Delayed eviction through the engine, held against the JAX package.

- Multi-round CRUD campaigns through ``grapevine_tpu``'s
  ``engine_round_step`` + ``engine_flush_step`` and the port's, fed the
  same batches and random draws, with a flush every ``evict_every``
  rounds: equal responses, ``[B, 2D+1]`` transcripts and full state —
  the ``ebuf_*``/``fetch_tag`` planes included — after every round and
  every flush (tolerance 0). This file runs ``evict_every=2`` under the
  ``"jnp"`` cipher at two geometries × two seeds;
  ``test_torch_engine_evict4.py`` runs 4, and
  ``test_torch_engine_evict_pallas.py`` / ``_fused.py`` the kernel
  impls.
- The facade's cadence: both packages' ``GrapevineEngine`` flush after
  every second round and on ``flush_now``, from one carried-across
  state, with equal statuses, records and window health.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.batcher import GrapevineEngine as JEngine
from grapevine_tpu.engine.round_step import engine_flush_step as jax_flush
from grapevine_tpu.engine.state import EngineConfig as JEcfg, init_engine
from grapevine_tpu.wire.records import QueryRequest as JReq, RequestRecord as JRec
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import GrapevineEngine, batch_to_device
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.round_step import (
    RoundDraws,
    engine_flush_step,
    engine_round_step,
)
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.u32 import to_numpy as t2n
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from test_torch_engine import (
    GEOMETRIES,
    NOW,
    _jax_step,
    _requests,
    _users,
    crud_batches,
    jax_draws,
    jax_leaves,
)

#: jitted as the reference's GrapevineEngine jits its flush
_jax_flush = jax.jit(jax_flush, static_argnums=(0,), donate_argnums=(1,))


def run_evict_campaign(geo: str, seed: int, impl: str, evict_every: int,
                       windows: int = 2):
    """``windows`` whole windows plus one round, flushing as the engine
    does; every round and flush compared in full. The reference runs the
    same ``impl`` (its Pallas kernels in interpret mode)."""
    kw = dict(GEOMETRIES[geo], bucket_cipher_impl=impl, vphases_impl="dense",
              evict_every=evict_every)
    jecfg = JEcfg.from_config(JConfig(**kw))
    tecfg = EngineConfig.from_config(GrapevineConfig(**kw))
    assert tecfg.rec.evict_window == evict_every == jecfg.rec.evict_window
    jst = init_engine(jecfg, seed)
    tst = from_jax_state(tecfg, jax_leaves(jst), device="cpu")
    mask = impl.startswith("pallas_fused")
    created: list = []
    b = tecfg.batch_size
    n_rounds = windows * evict_every + 1
    for rnd, batch in enumerate(crud_batches(b, n_rounds, seed, lambda: created)):
        where = f"{geo}/{impl}/E={evict_every} round {rnd}"
        draws = RoundDraws(*(from_numpy(x, "cpu") for x in jax_draws(jecfg, jst.rng, b)))
        jst, jresp, jtr = _jax_step(jecfg, jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst, tresp, ttr = engine_round_step(tecfg, tst, batch_to_device(batch, "cpu"),
                                            draws=draws)
        for k in jresp:
            np.testing.assert_array_equal(t2n(tresp[k]), np.asarray(jresp[k]),
                                          f"{where}: response {k}")
        np.testing.assert_array_equal(t2n(ttr), np.asarray(jtr), f"{where}: transcript")
        diff = first_difference(to_numpy(tst), jax_leaves(jst), mask_junk=mask)
        assert diff is None, f"{where}: state differs at {diff}"
        if (rnd + 1) % evict_every == 0:
            jst = _jax_flush(jecfg, jst)
            tst = engine_flush_step(tecfg, tst)
            diff = first_difference(to_numpy(tst), jax_leaves(jst), mask_junk=mask)
            assert diff is None, f"{where}: state after the flush differs at {diff}"
        st = np.asarray(jresp["status"])
        for i in np.flatnonzero((batch["req_type"] == C.REQUEST_TYPE_CREATE)
                                & (st == C.STATUS_CODE_SUCCESS)):
            created.append((np.asarray(jresp["msg_id"])[i].tobytes(),
                            batch["auth"][i].tobytes(), batch["recipient"][i].tobytes()))
    # the campaign ends mid-window with a live buffer, and nothing dropped
    assert int(tst.rec.ebuf_rounds) == 1 and int(tst.mb.ebuf_rounds) == 2
    assert int((tst.rec.ebuf_idx != -1).sum()) > 0
    assert int(tst.rec.overflow) == int(tst.mb.overflow) == 0
    assert int(tst.rec.ebuf_gen) == windows + 1
    return created


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_campaign_e2_matches_jax_jnp(geo, seed):
    assert len(run_evict_campaign(geo, seed, "jnp", 2)) > 0


def test_engine_config_maps_evict_every_as_jax():
    """Per-tree windows, fetch counts and buffer sizes, derived and
    explicit, equal the reference's; the state planes are sized by them."""
    for kw in (dict(GEOMETRIES["g1"], evict_every=2),
               dict(GEOMETRIES["g2"], evict_every=4),
               dict(GEOMETRIES["g2"], evict_every=3, evict_buffer_slots=100),
               dict(max_messages=2**20, max_recipients=2**12, batch_size=2048,
                    evict_every=4)):
        j = JEcfg.from_config(JConfig(**kw, vphases_impl="dense"))
        t = EngineConfig.from_config(GrapevineConfig(**kw, vphases_impl="dense"))
        for tree in ("rec", "mb"):
            jc, tc = getattr(j, tree), getattr(t, tree)
            for f in ("evict_window", "evict_fetch_count", "evict_buffer_slots",
                      "height", "value_words", "top_cache_levels"):
                assert getattr(tc, f) == getattr(jc, f), (kw, tree, f)
        assert t.evict_every == j.evict_every
    kw = dict(GEOMETRIES["g1"], evict_every=2, vphases_impl="dense")
    jl = jax_leaves(init_engine(JEcfg.from_config(JConfig(**kw)), 0))
    tl = to_numpy(from_jax_state(EngineConfig.from_config(GrapevineConfig(**kw)), jl,
                                 device="cpu"))
    assert first_difference(tl, jl, mask_junk=False) is None
    assert tl["rec.fetch_tag"].shape[0] > 0 and tl["mb.ebuf_paths"].shape[0] > 0
    with pytest.raises(ValueError, match="fetch_tag|ebuf"):
        from_jax_state(EngineConfig.from_config(GrapevineConfig(**GEOMETRIES["g1"])),
                       jl, device="cpu")


def test_facade_flush_cadence_matches_jax_engine():
    """``evict_every=2``: both facades flush after rounds 2 and 4 and on
    ``flush_now`` after round 5; statuses, records and the window health
    agree round by round, and a second ``flush_now`` is a no-op."""
    kw = dict(GEOMETRIES["g1"], vphases_impl="dense", evict_every=2)
    jeng = JEngine(JConfig(**kw), seed=21)
    teng = GrapevineEngine(GrapevineConfig(**kw), seed=21, device="cpu")
    teng.state = from_jax_state(teng.ecfg, jax_leaves(jeng.state), seed=21,
                                device=teng.device)
    u = _users(4)
    z = bytes(16)
    R, CR, UP, DE = (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_CREATE,
                     C.REQUEST_TYPE_UPDATE, C.REQUEST_TYPE_DELETE)
    plans = [
        [(CR, u[0], u[1], z, 1), (CR, u[2], u[1], z, 2), (CR, u[0], u[3], z, 3),
         (CR, u[1], u[2], z, 4), (CR, u[3], u[3], z, 5)],
        [(R, u[1], u[1], ("id", 0), 0), (UP, u[0], u[1], ("id", 0), 9),
         (R, u[1], u[1], ("id", 0), 0), (DE, u[3], u[3], ("id", 2), 0)],
        [(R, u[3], u[3], ("id", 2), 0), (R, u[1], u[1], z, 0),
         (CR, u[2], u[0], z, 6), (R, u[2], u[2], ("id", 3), 0)],
        [(DE, u[1], u[1], z, 0), (R, u[0], u[0], z, 0), (UP, u[2], u[2], ("id", 4), 7)],
        [(R, u[0], u[1], ("id", 1), 0), (R, u[2], u[2], ("id", 4), 0),
         (DE, u[2], u[2], ("id", 3), 0)],
    ]
    jids, tids = [], []
    for rnd, plan in enumerate(plans):
        jr = jeng.handle_queries(_requests(JReq, JRec, plan, jids), NOW + rnd)
        tr = teng.handle_queries(_requests(QueryRequest, RequestRecord, plan, tids), NOW + rnd)
        for i, (a, b) in enumerate(zip(jr, tr)):
            where = f"round {rnd} op {i}"
            assert a.status_code == b.status_code, where
            for f in ("sender", "recipient", "timestamp", "payload"):
                assert getattr(a.record, f) == getattr(b.record, f), f"{where} {f}"
            if plan[i][0] == CR and a.status_code == C.STATUS_CODE_SUCCESS:
                jids.append(a.record.msg_id)
                tids.append(b.record.msg_id)
            elif plan[i][0] != CR:  # the same create on both sides, or none
                ja = jids.index(a.record.msg_id) if a.record.msg_id in jids else None
                tb = tids.index(b.record.msg_id) if b.record.msg_id in tids else None
                assert ja == tb, where
        # each package draws its own leaves, so occupancies differ in
        # value; the cadence and whether the buffer is empty do not
        jh, th = jeng.health(), teng.health()
        closing = (rnd + 1) % 2 == 0
        assert th["evict_rounds_since_flush"] == jh["evict_rounds_since_flush"] == (rnd + 1) % 2
        assert th["evict_buffer_slots"] == jh["evict_buffer_slots"]
        for h in (jh, th):
            assert (sum(h["evict_buffer_occupancy"].values()) == 0) == closing, rnd
            assert h["stash_overflow"] == 0
    assert teng.flushes == 2 and th["evict_rounds_since_flush"] == 1
    assert teng.flush_now() and jeng.flush_now()
    assert not teng.flush_now() and not jeng.flush_now()
    jh, th = jeng.health(), teng.health()
    assert th["evict_buffer_occupancy"] == jh["evict_buffer_occupancy"] == {"rec": 0, "mb": 0}
    assert th["evict_rounds_since_flush"] == jh["evict_rounds_since_flush"] == 0
    assert teng.flushes == 3
    assert teng.message_count() == jeng.message_count()
    assert teng.recipient_count() == jeng.recipient_count()
    statuses = {r.status_code for r in tr}
    assert C.STATUS_CODE_SUCCESS in statuses
