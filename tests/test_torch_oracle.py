"""The port's own copies of the reference's oracle pieces
(``grapevine_tpu_torch/testing/{reference,ref_oram,fixtures,compare}.py``)
give the JAX package's answers on the same seeded streams:

- ``ReferenceEngine``: the same request stream (creates past every quota,
  reads, updates and deletes by id and zero-id, hard protocol errors,
  phase-major batches, expiry sweeps) through both oracles from the same
  seeded ``random.Random`` gives byte-equal responses, equal counts and
  the same exceptions;
- the wire fixtures draw the same instances from the same seeds;
- ``RefPathOram``: the same accesses give equal outputs, transcripts and
  stash occupancy in both mirrors, and the port's vectorized
  ``oram_access`` gives the mirror's transcript bit for bit;
- ``compare.py``: the logical planes and block maps of an encrypted
  tree with a tree-top cache, and the state comparisons' verdicts (equal,
  junk-only difference, real difference) equal the reference's.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.state import EngineConfig as JEcfg, init_engine
from grapevine_tpu.oram import path_oram as jpo
from grapevine_tpu.oram import round as jround
from grapevine_tpu.testing import compare as jcmp
from grapevine_tpu.testing import fixtures as jfx
from grapevine_tpu.testing import ref_oram as jro
from grapevine_tpu.testing import reference as jref
from grapevine_tpu.wire.records import QueryRequest as JReq, RequestRecord as JRec
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.convert import from_jax_state
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.oram import path_oram as tpo
from grapevine_tpu_torch.testing import compare as tcmp
from grapevine_tpu_torch.testing import fixtures as tfx
from grapevine_tpu_torch.testing import ref_oram as tro
from grapevine_tpu_torch.testing import reference as tref
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from test_oram import random_ops
from test_torch_engine import jax_leaves
from test_torch_engine_step import _jax_step
from test_torch_posmap import jflat
from test_torch_round import _batches, jax_kv_apply

NOW = 1_700_000_000
ORACLE_CFG = dict(max_messages=16, max_recipients=4, mailbox_cap=3, batch_size=4,
                  expiry_period=50)


def _key(n: int) -> bytes:
    return bytes([n, n ^ 0x5A]) + b"\x02" * 30


def _stream(seed: int, n: int):
    """(kind, args) events: single queries, batches and sweeps."""
    rng = random.Random(seed)
    idents = [_key(i + 1) for i in range(6)]
    ids: list = []
    t = NOW
    for _ in range(n):
        t += rng.randrange(4)
        c = rng.random()
        if c < 0.1:
            yield "expire", (t + rng.randrange(80),)
            continue
        reqs = []
        for _ in range(rng.randrange(1, 4) if c < 0.3 else 1):
            rt = rng.choice([1, 1, 1, 2, 2, 3, 4, 4])
            auth = rng.choice(idents) if rng.random() > 0.03 else bytes(32)
            rcp = rng.choice(idents + [bytes(32)])
            mid = bytes(16)
            if rt != 1 and (rt == 3 or rng.random() < 0.7):
                mid = rng.choice(ids) if ids and rng.random() < 0.85 else rng.randbytes(16)
                if rng.random() < 0.05:
                    mid = bytes(16)  # an UPDATE with a zero id is a hard error
            reqs.append((rt, auth, mid, rcp, rng.randbytes(C.PAYLOAD_SIZE)))
        yield ("batch" if c < 0.3 else "query"), (reqs, t, ids)


def _build(pkg_req, pkg_rec, spec):
    rt, auth, mid, rcp, pay = spec
    return pkg_req(request_type=rt, auth_identity=auth,
                   record=pkg_rec(msg_id=mid, recipient=rcp, payload=pay))


def _call(fn):
    try:
        return "ok", fn()
    except Exception as exc:  # compared by type across the packages
        return type(exc).__name__, str(exc)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_engine_matches_jax_oracle(seed):
    jeng = jref.ReferenceEngine(config=JConfig(**ORACLE_CFG), rng=random.Random(seed))
    teng = tref.ReferenceEngine(config=GrapevineConfig(**ORACLE_CFG), rng=random.Random(seed))
    kinds = set()
    for kind, args in _stream(seed, 160):
        if kind == "expire":
            assert teng.expire(*args) == jeng.expire(*args)
        else:
            specs, t, ids = args
            jr = [_build(JReq, JRec, s) for s in specs]
            tr = [_build(QueryRequest, RequestRecord, s) for s in specs]
            if kind == "query":
                a = _call(lambda: [jeng.handle_query(jr[0], t)])
                b = _call(lambda: [teng.handle_query(tr[0], t)])
            else:
                a = _call(lambda: jeng.handle_batch(jr, t))
                b = _call(lambda: teng.handle_batch(tr, t))
            assert a[0] == b[0], (kind, a, b)
            if a[0] == "ok":
                assert [x.pack() for x in a[1]] == [x.pack() for x in b[1]]
                for q, x in zip(specs, b[1]):
                    kinds.add((q[0], x.status_code))
                    if q[0] == 1 and x.status_code == C.STATUS_CODE_SUCCESS:
                        ids.append(x.record.msg_id)
            else:
                kinds.add(a[0])
        assert teng.message_count() == jeng.message_count()
        assert teng.recipient_count() == jeng.recipient_count()
    assert "HardProtocolError" in kinds
    for want in ((1, C.STATUS_CODE_SUCCESS), (1, C.STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT),
                 (2, C.STATUS_CODE_SUCCESS), (2, C.STATUS_CODE_NOT_FOUND),
                 (4, C.STATUS_CODE_SUCCESS)):
        assert want in kinds, want


def test_reference_forced_msg_id_and_hard_errors_match_jax():
    """``forced_msg_id`` replays an engine's id, a reused one is refused
    MESSAGE_ID_ALREADY_IN_USE, and the hard protocol errors are the
    reference's."""
    jeng = jref.ReferenceEngine(config=JConfig(**ORACLE_CFG))
    teng = tref.ReferenceEngine(config=GrapevineConfig(**ORACLE_CFG))
    forced = bytes(range(16))
    spec = (1, _key(1), bytes(16), _key(2), bytes(C.PAYLOAD_SIZE))
    for _ in range(2):
        a = jeng.handle_query(_build(JReq, JRec, spec), NOW, forced_msg_id=forced)
        b = teng.handle_query(_build(QueryRequest, RequestRecord, spec), NOW,
                              forced_msg_id=forced)
        assert a.pack() == b.pack()
    assert b.status_code == C.STATUS_CODE_MESSAGE_ID_ALREADY_IN_USE
    for bad in ((3, _key(1), bytes(16), _key(2), bytes(C.PAYLOAD_SIZE)),
                (2, bytes(32), forced, _key(2), bytes(C.PAYLOAD_SIZE))):
        with pytest.raises(jref.HardProtocolError):
            jeng.handle_query(_build(JReq, JRec, bad), NOW)
        with pytest.raises(tref.HardProtocolError):
            teng.handle_query(_build(QueryRequest, RequestRecord, bad), NOW)


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_fixtures_draw_the_reference_instances(seed):
    for name in ("random_request_record", "random_record", "random_query_request",
                 "random_query_response"):
        a = getattr(jfx, name)(jfx.get_seeded_rng(seed))
        b = getattr(tfx, name)(tfx.get_seeded_rng(seed))
        assert a.pack() == b.pack(), name
    seen_j, seen_t = [], []
    jfx.run_with_several_seeds(lambda r: seen_j.append(r.random()), 3)
    tfx.run_with_several_seeds(lambda r: seen_t.append(r.random()), 3)
    assert seen_j == seen_t and tfx.DEFAULT_SEED == jfx.DEFAULT_SEED


def _mirror_fn(mode, wval):
    def fn(value, present):
        keep = mode != 2
        return (tuple(wval) if mode == 1 else value), keep, mode == 1, {
            "value": value, "present": present}
    return fn


def _torch_fn(value, present, opnd):
    mode, wval = opnd
    new_value = torch.where(mode == 1, wval, value)
    return new_value, mode != 2, mode == 1, {"value": value, "present": present}


@pytest.mark.parametrize("density", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_ref_oram_matches_jax_mirror_and_port_access(seed, density):
    geo = dict(height=5, value_words=4, bucket_slots=4, stash_size=48)
    if density == 2:
        geo["n_blocks"] = 64
    jcfg, tcfg = jpo.OramConfig(**geo), tpo.OramConfig(**geo)
    posmap = random.Random(seed).choices(range(tcfg.leaves), k=tcfg.blocks + 1)
    jm, tm = jro.RefPathOram(jcfg, posmap), tro.RefPathOram(tcfg, posmap)
    ops = random_ops(seed, 150, tcfg)
    leaf_rng = random.Random(1000 + seed)
    new_leaves = [leaf_rng.randrange(tcfg.leaves) for _ in ops]
    want = []
    for (mode, idx, val), nl in zip(ops, new_leaves):
        a = jm.access(idx, nl, _mirror_fn(mode, val))
        b = tm.access(idx, nl, _mirror_fn(mode, val))
        assert a == b
        want.append(b)
    assert jm.stash_occupancy() == tm.stash_occupancy() and tm.overflow == 0
    # the vectorized access gives the mirror's transcript bit for bit
    st = tpo.init_oram(tcfg, torch.Generator().manual_seed(0), "cpu")
    st = st._replace(posmap=torch.tensor(posmap, dtype=torch.int32))
    idxs, nls = (torch.tensor(x, dtype=torch.int32) for x in
                 ([i for _, i, _ in ops], new_leaves))
    opnd = (torch.tensor([m for m, _, _ in ops], dtype=torch.int32),
            from_numpy(np.array([v for _, _, v in ops], np.uint32), "cpu"))
    st, outs, leaves = tpo.oram_access_batch(tcfg, st, idxs, nls, opnd, _torch_fn)
    assert leaves.tolist() == [leaf for _, leaf in want]
    assert outs["present"].tolist() == [o["present"] for o, _ in want]
    got = outs["value"].numpy().view(np.uint32)
    for t, (o, _) in enumerate(want):
        if o["present"]:
            assert tuple(int(x) for x in got[t]) == tuple(o["value"]), t
    assert int((st.stash_idx != -1).sum()) == tm.stash_occupancy()


@pytest.fixture(scope="module")
def cached_trees():
    """An encrypted tree with a k=2 tree-top cache after four JAX rounds,
    and the same state carried into the port."""
    geo = dict(height=5, value_words=4, stash_size=64, cipher_rounds=8, top_cache_levels=2)
    jcfg, tcfg = jpo.OramConfig(**geo), tpo.OramConfig(**geo)

    @jax.jit
    def step(st, idxs, nl, dl, codes, vals):
        return jround.oram_round(jcfg, st, idxs, nl, dl, jax_kv_apply(jcfg, idxs, codes, vals))

    jst = jpo.init_oram(jcfg, jax.random.PRNGKey(3))
    for idxs, codes, vals, nl, dl in _batches(tcfg, 4, 12, 3):
        jst, _, _ = step(jst, *(jnp.asarray(a) for a in (idxs, nl, dl, codes, vals)))
    leaves = jflat(jst)
    return jcfg, jst, tcfg, tpo.oram_from_leaves(tcfg, lambda g: from_numpy(leaves[g], "cpu"))


def test_logical_planes_and_block_map_match_jax(cached_trees):
    jcfg, jst, tcfg, tst = cached_trees
    for x, y in zip(tcmp.logical_tree_planes(tcfg, tst), jcmp.logical_tree_planes(jcfg, jst)):
        if y is None:
            assert x is None
        else:
            np.testing.assert_array_equal(x, y)
    want = jcmp.logical_block_map(jcfg, jst)
    assert len(want) > 0 and tcmp.logical_block_map(tcfg, tst) == want


def _flip(t: torch.Tensor, row: int) -> torch.Tensor:
    t = t.clone()
    t[row] ^= 1
    return t


def test_states_equal_excluding_junk_verdicts_match_jax(cached_trees):
    """Equal, junk bucket only (equal), a real bucket (differs), a stash
    word (differs): the same verdicts and the same first leaf."""
    jcfg, jst, tcfg, tst = cached_trees
    z = tcfg.bucket_slots
    cases = {
        "same": ({}, {}),
        "junk": ({"tree_val": (-1,), "nonces": (-1,), "tree_idx": (-z,)}, {}),
        "real": ({"tree_val": (3,)}, {}),
        "stash": ({"stash_val": (0,)}, {}),
    }
    for name, (edits, _) in cases.items():
        j2, t2 = jst, tst
        for f, (row,) in edits.items():
            jx = np.asarray(getattr(jst, f)).copy()
            jx[row] ^= 1
            j2 = j2._replace(**{f: jnp.asarray(jx)})
            t2 = t2._replace(**{f: _flip(getattr(tst, f), row)})
        jeq, jkey = jcmp.states_equal_excluding_junk(jst, j2)
        teq, tkey = tcmp.states_equal_excluding_junk(tst, t2)
        assert teq == jeq, name
        assert (tkey is None) == (jkey is None) and (tkey is None or jkey.endswith(tkey)), (
            name, jkey, tkey)
        assert teq == (name in ("same", "junk"))


@pytest.fixture(scope="module")
def op_states():
    """A JAX op-major engine after two rounds, and the port's copy."""
    kw = dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=8,
              stash_size=64, commit="op")
    jecfg = JEcfg.from_config(JConfig(**kw))
    jst = init_engine(jecfg, 1)
    b = jecfg.batch_size
    for r in range(2):
        batch = {"req_type": np.ones(b, np.uint32),
                 "auth": np.full((b, 8), r + 1, np.uint32),
                 "msg_id": np.zeros((b, 4), np.uint32),
                 "recipient": np.arange(b * 8, dtype=np.uint32).reshape(b, 8) % 3 + 1,
                 "payload": np.full((b, C.PAYLOAD_SIZE // 4), r, np.uint32),
                 "now": np.uint32(NOW + r), "now_hi": np.uint32(0)}
        jst, _, _ = _jax_step(jecfg, jst, {k: jnp.asarray(v) for k, v in batch.items()})
    tecfg = EngineConfig.from_config(GrapevineConfig(**kw))
    return jecfg, jst, tecfg, jax_leaves(jst)


@pytest.mark.parametrize("edit", ["none", "stash_val", "freelist", "block_value"])
def test_logical_state_and_content_verdicts_match_jax(op_states, edit):
    jecfg, jst, tecfg, leaves = op_states

    def port(lv):
        return from_jax_state(tecfg, lv, seed=1, device="cpu")

    lv2 = {k: v.copy() for k, v in leaves.items()}
    j2 = jst
    if edit == "stash_val":
        lv2["mb.stash_val"][0, 0] ^= 1
        j2 = jst._replace(mb=jst.mb._replace(stash_val=jnp.asarray(lv2["mb.stash_val"])))
    elif edit == "freelist":
        lv2["freelist"][0] ^= 1
        j2 = jst._replace(freelist=jnp.asarray(lv2["freelist"]))
    elif edit == "block_value":
        # flip one ciphertext word of a live records block: its
        # decrypted value changes, and nothing else does
        lidx, _, _ = jcmp.logical_tree_planes(jecfg.rec, jst.rec)
        row, slot = (int(x[0]) for x in np.nonzero(lidx[:-1] != np.uint32(0xFFFFFFFF)))
        lv2["rec.tree_val"][row, slot * jecfg.rec.value_words] ^= 1
        j2 = jst._replace(rec=jst.rec._replace(tree_val=jnp.asarray(lv2["rec.tree_val"])))
    outs = []
    for fn in ("assert_logical_state_equal", "assert_logical_content_equal"):
        a = _call(lambda: getattr(jcmp, fn)(jecfg, jst, jecfg, j2, "x"))
        b = _call(lambda: getattr(tcmp, fn)(tecfg, port(leaves), tecfg, port(lv2), "x"))
        assert a[0] == b[0], (fn, a, b)
        if a[0] != "ok":
            assert a[1].split(":")[1].split()[0] == b[1].split(":")[1].split()[0], (a, b)
        outs.append(b[0])
    assert outs[0] == ("ok" if edit == "none" else "AssertionError")
