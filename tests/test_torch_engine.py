"""The port's engine round and facade held against the JAX package.

- ``from_jax_state``/``to_numpy`` carry an ``EngineState`` across and
  back leaf for leaf;
- a multi-round CRUD campaign through ``grapevine_tpu``'s
  ``engine_round_step`` and the port's, fed the same batches and the same
  random draws (computed from the JAX ``state.rng`` exactly as
  ``engine/round_step.py:210-222`` does), gives equal responses,
  ``[B, 2D+1]`` transcripts and full state after every round — under the
  ``"jnp"`` cipher (tolerance 0, every byte) and under
  ``"pallas_fused_tiled"`` (the JAX side in Pallas interpret mode, the
  port's plain kernel versions on the CPU; junk bucket masked);
- the facade: the same request sequence through both packages'
  ``GrapevineEngine.handle_queries`` from one carried-across state gives
  equal statuses and records (msg_ids are mapped per slot: each package
  draws its own id nonces).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.batcher import GrapevineEngine as JEngine
from grapevine_tpu.engine.round_step import engine_round_step as jax_step
from grapevine_tpu.engine.state import EngineConfig as JEcfg, init_engine
from grapevine_tpu.wire.records import QueryRequest as JReq, RequestRecord as JRec
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import GrapevineEngine, batch_to_device
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.round_step import RoundDraws, engine_round_step
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.u32 import to_numpy as t2n
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

U32 = jnp.uint32
NOW = 1_700_000_000
PW = C.PAYLOAD_SIZE // 4

#: two geometries: a minimal engine, and a wider one (a taller records
#: tree, k=2 cache, single-choice mailboxes)
GEOMETRIES = {
    "g1": dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=8,
               stash_size=64),
    "g2": dict(max_messages=256, max_recipients=16, mailbox_cap=6,
               batch_size=12, stash_size=80, tree_top_cache_levels=2,
               mailbox_choices=1),
}


def jax_leaves(st) -> dict:
    out = {}
    for name in ("rec", "mb"):
        o = getattr(st, name)
        for f in o._fields:
            out[f"{name}.{f}"] = np.asarray(getattr(o, f))
    for k in ("freelist", "free_top", "recipients", "seq", "hash_key", "id_key"):
        out[k] = np.asarray(getattr(st, k))
    return out


def jax_draws(ecfg, rng, b) -> list:
    """The reference round's draws, exactly as round_step.py:210-222."""
    d = ecfg.mb_choices
    keys = jax.random.split(rng, 8)
    mbm, recm = U32(ecfg.mb.leaves - 1), U32(ecfg.rec.leaves - 1)
    out = [
        jax.random.bits(keys[0], (b * d,), U32) & mbm,
        jax.random.bits(keys[1], (b,), U32) & recm,
        jax.random.bits(keys[2], (b * d,), U32) & mbm,
        jax.random.bits(keys[3], (b * d,), U32) & mbm,
        jax.random.bits(keys[4], (b,), U32) & recm,
        jax.random.bits(keys[5], (b * d,), U32) & mbm,
        jax.random.bits(keys[6], (b, 3), U32),
    ]
    return [np.asarray(x) for x in out]


def _users(n):
    return [bytes([i + 1]) * 32 for i in range(n)]


def crud_batches(b, n_rounds, seed, ids_of):
    """Random CRUD rounds over a few users: creates, reads/updates/deletes
    by id (known and stale), zero-id reads/deletes, padding. ``ids_of``
    returns the msg_ids created so far (from the reference's responses)."""
    rng = np.random.default_rng(seed)
    users = _users(5)
    for rnd in range(n_rounds):
        n = b if rnd % 2 == 0 else b - 3  # some rounds carry padding
        rt = np.zeros(b, np.uint32)
        auth = np.zeros((b, 8), np.uint32)
        recip = np.zeros((b, 8), np.uint32)
        mid = np.zeros((b, 4), np.uint32)
        pay = np.zeros((b, PW), np.uint32)
        known = ids_of()
        for i in range(n):
            a = users[rng.integers(len(users))]
            r = users[rng.integers(len(users))]
            kind = rng.random()
            if rnd == 0 or kind < 0.35 or not known:
                t, m = C.REQUEST_TYPE_CREATE, bytes(16)
            elif kind < 0.55:
                t = C.REQUEST_TYPE_READ
                m, a, r = known[rng.integers(len(known))]
            elif kind < 0.65:
                t = C.REQUEST_TYPE_UPDATE
                m, a, r = known[rng.integers(len(known))]
            elif kind < 0.8:
                t = C.REQUEST_TYPE_DELETE
                m, a, r = known[rng.integers(len(known))]
            else:
                t = (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_DELETE)[rng.integers(2)]
                m, a = bytes(16), r  # zero-id op on my own mailbox
            rt[i] = t
            auth[i] = np.frombuffer(a, "<u4")
            recip[i] = np.frombuffer(r, "<u4")
            mid[i] = np.frombuffer(m, "<u4")
            pay[i] = rng.integers(0, 2**32, PW, dtype=np.uint64).astype(np.uint32)
        yield {"req_type": rt, "auth": auth, "msg_id": mid, "recipient": recip,
               "payload": pay, "now": np.uint32(NOW + rnd),
               "now_hi": np.uint32(0)}


#: jitted as the reference's GrapevineEngine jits it, so a facade engine
#: of the same geometry reuses this compile
_jax_step = jax.jit(jax_step, static_argnums=(0,), donate_argnums=(1,))


def run_campaign(geo: str, seed: int, impl: str, n_rounds: int = 4):
    kw = dict(GEOMETRIES[geo], bucket_cipher_impl=impl, vphases_impl="dense")
    jecfg = JEcfg.from_config(JConfig(**kw))
    tecfg = EngineConfig.from_config(GrapevineConfig(**kw))
    jst = init_engine(jecfg, seed)
    tst = from_jax_state(tecfg, jax_leaves(jst), device="cpu")
    created: list = []  # (msg_id bytes, sender, recipient) from the reference
    b = tecfg.batch_size
    for rnd, batch in enumerate(crud_batches(b, n_rounds, seed, lambda: created)):
        draws = RoundDraws(*(from_numpy(x, "cpu") for x in jax_draws(jecfg, jst.rng, b)))
        jst, jresp, jtr = _jax_step(jecfg, jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst, tresp, ttr = engine_round_step(tecfg, tst, batch_to_device(batch, "cpu"),
                                            draws=draws)
        for k in jresp:
            np.testing.assert_array_equal(t2n(tresp[k]), np.asarray(jresp[k]),
                                          f"{geo}/{impl} round {rnd}: response {k}")
        np.testing.assert_array_equal(t2n(ttr), np.asarray(jtr),
                                      f"{geo}/{impl} round {rnd}: transcript")
        diff = first_difference(to_numpy(tst), jax_leaves(jst), mask_junk=impl != "jnp")
        assert diff is None, f"{geo}/{impl} round {rnd}: state differs at {diff}"
        st = np.asarray(jresp["status"])
        for i in np.flatnonzero((batch["req_type"] == C.REQUEST_TYPE_CREATE)
                                & (st == C.STATUS_CODE_SUCCESS)):
            created.append((np.asarray(jresp["msg_id"])[i].tobytes(),
                            batch["auth"][i].tobytes(), batch["recipient"][i].tobytes()))
    assert int(np.asarray(jst.rec.overflow)) == 0
    return created


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_campaign_matches_jax_jnp(geo, seed):
    assert len(run_campaign(geo, seed, "jnp")) > 0


def test_config_copy_matches_reference():
    """One config object's values drive both packages: same fields,
    defaults, derived geometry and refusals."""
    import dataclasses

    assert [(f.name, f.default) for f in dataclasses.fields(GrapevineConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JConfig)]
    props = ("records_height", "records_leaves", "resolved_mailbox_choices",
             "resolved_mailbox_load", "mailbox_table_buckets", "mailbox_height",
             "mailbox_leaves")
    for kw in (dict(), *GEOMETRIES.values(),
               dict(max_messages=2**20, max_recipients=2**12, batch_size=2048),
               dict(mailbox_choices=1, tree_density=4)):
        j, t = JConfig(**kw), GrapevineConfig(**kw)
        assert [getattr(t, p) for p in props] == [getattr(j, p) for p in props], kw
    for kw in (dict(commit="x"), dict(bucket_cipher_rounds=7), dict(max_messages=3),
               dict(tree_density=3), dict(shards=3), dict(evict_every=0),
               dict(commit="op", mailbox_choices=2), dict(tree_top_cache_levels=-1)):
        for cls in (JConfig, GrapevineConfig):
            with pytest.raises(ValueError):
                cls(**kw)


def test_from_jax_state_round_trips():
    kw = dict(GEOMETRIES["g2"], vphases_impl="dense")
    jst = init_engine(JEcfg.from_config(JConfig(**kw)), 11)
    leaves = jax_leaves(jst)
    tst = from_jax_state(EngineConfig.from_config(GrapevineConfig(**kw)), leaves, seed=5,
                         device="cpu")
    back = to_numpy(tst)
    assert back.keys() == leaves.keys()
    for k, v in leaves.items():
        assert back[k].dtype == np.uint32 and back[k].shape == v.shape, k
        np.testing.assert_array_equal(back[k], v, k)
    assert isinstance(tst.rng, torch.Generator)
    with pytest.raises(ValueError):
        from_jax_state(EngineConfig.from_config(GrapevineConfig(
            **GEOMETRIES["g1"])), leaves, device="cpu")


def _requests(pkg_req, pkg_rec, plan, ids):
    """Build one package's requests for ``plan``; ``("id", j)`` refers to
    the msg_id that THIS package returned for create number j."""
    out = []
    for t, a, r, m, p in plan:
        mid = ids[m[1]] if isinstance(m, tuple) else m
        out.append(pkg_req(request_type=t, auth_identity=a,
                           record=pkg_rec(msg_id=mid, recipient=r,
                                          payload=bytes([p]) * C.PAYLOAD_SIZE)))
    return out


def test_facade_matches_jax_engine():
    kw = dict(GEOMETRIES["g1"], vphases_impl="dense")
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
         (R, u[1], u[1], ("id", 0), 0), (DE, u[3], u[3], ("id", 2), 0),
         (R, u[2], u[2], z, 0), (R, u[0], u[0], ("id", 3), 0)],
        [(R, u[3], u[3], ("id", 2), 0), (DE, u[1], u[1], z, 0),
         (R, u[1], u[1], z, 0), (R, u[1], u[1], z, 0), (DE, u[2], u[2], z, 0),
         (R, u[2], u[2], z, 0), (UP, u[2], u[2], ("id", 4), 7)],
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
            if rnd == 0:
                jids.append(a.record.msg_id)
                tids.append(b.record.msg_id)
            else:  # same create slot on both sides, or both zero
                ja = jids.index(a.record.msg_id) if a.record.msg_id in jids else None
                tb = tids.index(b.record.msg_id) if b.record.msg_id in tids else None
                assert ja == tb, where
                if ja is None:
                    assert a.record.msg_id == b.record.msg_id == z, where
    statuses = [r.status_code for r in tr]
    assert C.STATUS_CODE_NOT_FOUND in statuses and C.STATUS_CODE_SUCCESS in statuses
    assert teng.message_count() == jeng.message_count()
    assert teng.recipient_count() == jeng.recipient_count()


@pytest.mark.parametrize("seed", [0, 1])
def test_admission_paths_match_jax(seed):
    """Both admission paths against the reference's on the same inputs:
    the vectorized fast path and the exact sequential walk (a host loop
    in the port, a lax.scan in the reference), with quotas that bind."""
    from grapevine_tpu.engine import vphases as jv
    from grapevine_tpu_torch.engine import vphases as tv

    rng = np.random.default_rng(seed)
    b = 16
    kw = dict(GEOMETRIES["g1"], vphases_impl="dense", max_recipients=16)
    jecfg = JEcfg.from_config(JConfig(**kw))
    tecfg = EngineConfig.from_config(GrapevineConfig(**kw))
    real = rng.random(b) < 0.85
    rlab = rng.integers(0, 6, b)
    glab = rlab % 4
    same_r = (rlab[:, None] == rlab[None, :]) & real[:, None] & real[None, :]
    same_g = (glab[:, None] == glab[None, :]) & real[:, None] & real[None, :]
    crt = real & (rng.random(b) < 0.6)
    pop = real & ~crt & (rng.random(b) < 0.5)
    first = crt & ~np.any(same_r & np.tril(np.ones((b, b), bool), -1) & crt[None, :], 1)
    common = dict(
        is_create_cand=crt, is_pop_cand=pop,
        found0=real & np.isin(rlab, [0, 1]),
        first_create=first,
        free_slots0=(3 - glab).astype(np.int32),
        init_count=np.where(np.isin(rlab, [0, 1]), rlab + 3, 0).astype(np.int32),
    )
    jg_r, jg_g = jv._DenseGroups(jnp.asarray(same_r)), jv._DenseGroups(jnp.asarray(same_g))
    tg_r, tg_g = tv._DenseGroups(torch.from_numpy(same_r)), tv._DenseGroups(torch.from_numpy(same_g))
    jc = {k: jnp.asarray(v) for k, v in common.items()}
    tc = {k: torch.from_numpy(v) for k, v in common.items()}
    want = jv._admission_fast(jecfg, **jc, groups_r=jg_r, groups_g=jg_g,
                              rslot=jg_r.group_first())
    got = tv._admission_fast(tecfg, **tc, groups_r=tg_r, groups_g=tg_g,
                             rslot=tg_r.group_first())
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), f"fast {k}")
    for free_top, recips in ((3, 14), (40, 15), (0, 0)):
        want = jv._admission_slow(jecfg, **jc, rslot=jg_r.group_first(),
                                  gslot=jg_g.group_first(),
                                  free_top0=jnp.uint32(free_top),
                                  recipients0=jnp.uint32(recips))
        got = tv._admission_slow(tecfg, **tc, rslot=tg_r.group_first(),
                                 gslot=tg_g.group_first(),
                                 free_top0=torch.tensor(free_top),
                                 recipients0=torch.tensor(recips))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          f"slow {k} at free_top={free_top}")


def test_dense_aggregates_exact_and_no_global_matmul_flags():
    """The dense phases' aggregations are float64 products, exact past
    float32's 2^24 with no process-wide matmul setting; an engine round
    leaves the TF32 flag and the float32 matmul precision as it found
    them."""
    from grapevine_tpu_torch.engine import vphases as tv

    g = tv._DenseGroups(torch.ones(2, 2, dtype=torch.bool))
    u = torch.tensor([[2**24], [1]], dtype=torch.int32)
    assert g.total_sum_rows(u).tolist() == [[2**24 + 1], [2**24 + 1]]

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        eng = GrapevineEngine(GrapevineConfig(**GEOMETRIES["g1"], vphases_impl="dense"),
                              seed=2, device="cpu")
        (resp,) = eng.handle_queries([QueryRequest(
            request_type=C.REQUEST_TYPE_CREATE, auth_identity=_users(1)[0],
            record=RequestRecord(msg_id=bytes(16), recipient=_users(2)[1],
                                 payload=bytes(C.PAYLOAD_SIZE)))], NOW)
        assert resp.status_code == C.STATUS_CODE_SUCCESS
        assert torch.backends.cuda.matmul.allow_tf32 is True
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flags[0]
        torch.set_float32_matmul_precision(flags[1])
