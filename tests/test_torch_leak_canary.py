"""Leak canaries on the port: the transcript detectors of
``grapevine_tpu_torch/testing/leakcheck.py`` must catch a deliberately
broken round (the JAX package's ``tests/test_leak_canary.py`` is the
model, case for case, with its geometry, seeds and thresholds).

Each canary builds a real leak through the public ``oram_round``
parameters: the round trusts its caller to supply fresh uniform
``new_leaves`` / ``dummy_leaves``, so a careless caller is the realistic
bug, and the canaries run the production round code:

- **no-dedup**: dummy fetches reuse the key's real leaf, so same-key ops
  in one round show equal leaves (``samekey_leaf_collisions``);
- **no-remap**: the remap target is the key's current leaf, so every
  later round re-fetches the same path (``cross_round_repeat_rate``);
- **biased dummy**: padding ops fetch constant leaf 0, so the pooled
  transcript skews (``uniformity_z``).

The three canaries run through the port's ``oram_round`` on the CPU from
an ``OramState`` the JAX package builds and populates as the reference's
``_populated()`` does, carried across, and fed the same leaf arrays as
the JAX package's ``oram_round``: every transcript must equal the JAX
one (tolerance 0), and so must every detector value. The two
engine-level cases (the honest engine's transcript as the positive
control, and R/U/D transcript distributions with an op-type-bias canary)
run on the port's facade alone.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np

from grapevine_tpu.oram.path_oram import OramConfig as JCfg
from grapevine_tpu.oram.path_oram import init_oram
from grapevine_tpu.oram.round import oram_round as jax_round
from grapevine_tpu.testing import leakcheck as jax_leakcheck
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import GrapevineEngine as _Engine
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.oram.path_oram import OramConfig, OramState
from grapevine_tpu_torch.oram.round import oram_round
from grapevine_tpu_torch.testing import leakcheck
from grapevine_tpu_torch.testing.leakcheck import (
    cross_round_repeat_rate,
    twosample_z,
    uniformity_z,
)
from grapevine_tpu_torch.u32 import from_numpy, to_numpy
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

U32 = jnp.uint32
NOW = 1_700_000_000

GEO = dict(height=12, value_words=4, stash_size=128)
JCFG = JCfg(**GEO)
CFG = OramConfig(**GEO)
B = 16


def GrapevineEngine(cfg, seed=0):
    """The port's facade on the CPU."""
    return _Engine(cfg, seed=seed, device="cpu")


def _jstep(state, idxs, nl, dl, insert):
    """One JAX round: a read-only pass-through (no inserts, no kills: the
    transcript alone), or with ``insert`` every block set to ones."""

    def apply(vals0, present0):
        return ({}, jnp.where(insert, jnp.ones_like(vals0), vals0),
                jnp.where(insert, jnp.ones_like(present0), present0))

    st, _, leaves = jax_round(JCFG, state, idxs, nl, dl, apply)
    return st, leaves


JSTEP = jax.jit(_jstep)


def _passthrough(vals0, present0):
    return {}, vals0, present0


class Pair:
    """One ORAM carried in both packages: every round goes through the JAX
    round and the port's with the same inputs, and the transcripts must
    be equal."""

    def __init__(self, seed=0):
        state = init_oram(JCFG, jax.random.PRNGKey(seed))
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed + 100))
        # the reference's _populated(): blocks 0..B-1 inserted
        self.j, _ = JSTEP(state, jnp.arange(B, dtype=U32), _uniform(k1), _uniform(k2), True)
        self.t = OramState(**{f: from_numpy(np.asarray(getattr(self.j, f)), "cpu")
                              for f in self.j._fields})

    def posmap(self, idxs) -> np.ndarray:
        want = np.asarray(self.j.posmap)[np.asarray(idxs)]
        np.testing.assert_array_equal(to_numpy(self.t.posmap)[np.asarray(idxs)], want)
        return want

    def step(self, idxs, nl, dl) -> np.ndarray:
        idxs, nl, dl = (np.asarray(a, np.uint32) for a in (idxs, nl, dl))
        self.j, jl = JSTEP(self.j, jnp.asarray(idxs), jnp.asarray(nl), jnp.asarray(dl), False)
        self.t, _, tl = oram_round(CFG, self.t, *(from_numpy(a, "cpu") for a in (idxs, nl, dl)),
                                   _passthrough)
        np.testing.assert_array_equal(to_numpy(tl), np.asarray(jl))
        return np.asarray(jl)


def detector(name: str, *args):
    """The port's detector value on a transcript, which must equal the JAX
    package's on the same one."""
    got = getattr(leakcheck, name)(*args)
    assert got == getattr(jax_leakcheck, name)(*args), name
    return got


def _uniform(key, n=B):
    return jax.random.bits(key, (n,), U32) & U32(JCFG.leaves - 1)


def test_no_dedup_canary_trips_collision_detector():
    p = Pair()
    idxs = np.zeros((B,), np.uint32)  # every op in the round touches one key
    k1, k2 = jax.random.split(jax.random.PRNGKey(1))
    real_leaf = np.broadcast_to(p.posmap([0]), (B,))
    # the port writes its trees in place: keep a copy of the start
    start = (p.j, OramState(*(x.clone() for x in p.t)))

    # honest: fresh uniform dummy leaves -> no same-key collisions
    # (120 pairs x 1/4096 per pair => P(any) ~ 3%; the seed avoids the fluke)
    leaves = p.step(idxs, _uniform(k1), _uniform(k2))
    honest = detector("samekey_leaf_collisions", idxs, leaves)
    # leaky: dummies fetch the key's real current leaf (from the same state)
    p.j, p.t = start
    leaves_bad = p.step(idxs, _uniform(k1), real_leaf)
    leaky = detector("samekey_leaf_collisions", idxs, leaves_bad)

    assert honest == 0, "honest round showed correlated same-key leaves"
    assert leaky == B * (B - 1) // 2, "detector missed the no-dedup leak"


def test_no_remap_canary_trips_repeat_detector():
    k = jax.random.PRNGKey(2)
    # track key 3 via slot 0; every other slot is a padding dummy
    idxs = np.where(np.arange(B) == 0, 3, CFG.dummy_index).astype(np.uint32)

    def run(leaky: bool, rounds=12):
        p = Pair()
        key = k
        seq = []
        for _ in range(rounds):
            key, k1, k2 = jax.random.split(key, 3)
            nl = p.posmap(idxs) if leaky else _uniform(k1)
            seq.append(int(p.step(idxs, nl, _uniform(k2))[0]))
        return np.asarray(seq)

    assert detector("cross_round_repeat_rate", run(leaky=False)) < 0.2
    assert detector("cross_round_repeat_rate", run(leaky=True)) == 1.0, (
        "detector missed the no-remap leak"
    )


def test_biased_dummy_canary_trips_uniformity_detector():
    k = jax.random.PRNGKey(3)
    idxs = np.full((B,), CFG.dummy_index, np.uint32)  # an all-padding round

    def run(leaky: bool, rounds=24):
        p = Pair()
        key = k
        pool = []
        for _ in range(rounds):
            key, k1, k2 = jax.random.split(key, 3)
            dl = np.zeros((B,), np.uint32) if leaky else _uniform(k2)
            pool.append(p.step(idxs, _uniform(k1), dl))
        return np.concatenate(pool)

    z_honest = detector("uniformity_z", run(leaky=False), CFG.leaves)
    z_leaky = detector("uniformity_z", run(leaky=True), CFG.leaves)
    assert abs(z_honest) < 6, f"honest transcript flagged non-uniform (z={z_honest})"
    assert z_leaky > 50, f"detector missed the biased-dummy leak (z={z_leaky})"


def _req(rng, rt, auth, msg_id=C.ZERO_MSG_ID, recipient=C.ZERO_PUBKEY, tag=None):
    return QueryRequest(
        request_type=rt,
        auth_identity=auth,
        auth_signature=b"\x01" * C.SIGNATURE_SIZE,
        record=RequestRecord(
            msg_id=msg_id,
            recipient=recipient,
            payload=bytes([rng.randrange(256) if tag is None else tag]) * C.PAYLOAD_SIZE,
        ),
    )


def test_engine_transcript_passes_all_detectors():
    """The port engine's own transcript (mailbox and records leaves over
    mixed-CRUD rounds) clears every detector: the positive control that
    the honest path satisfies what the canaries falsify."""
    cfg = GrapevineConfig(
        bucket_cipher_rounds=0,
        max_messages=256,
        max_recipients=64,
        mailbox_cap=8,
        batch_size=4,
        stash_size=96,
    )
    e = GrapevineEngine(cfg, seed=5)
    rng = random.Random(9)
    a = bytes([1]) * 32
    b = bytes([2]) * 32

    # transcript columns: [a_0..a_{D-1}, b, c_0..c_{D-1}] (round_step.py)
    dcol = cfg.resolved_mailbox_choices
    mb_cols = list(range(dcol)) + list(range(dcol + 1, 2 * dcol + 1))
    mb_pool, rec_pool = [], []
    mid = None
    rec_leaves_of_mid = []
    for t in range(24):
        reqs = [_req(rng, C.REQUEST_TYPE_CREATE, a, recipient=b)]
        if mid is not None:
            reqs.append(_req(rng, C.REQUEST_TYPE_READ, b, msg_id=mid))
        resps, tr = e.handle_queries_with_transcript(reqs, NOW + t)
        tr = np.asarray(tr)
        if mid is None and resps[0].status_code == C.STATUS_CODE_SUCCESS:
            mid = resps[0].record.msg_id
        elif mid is not None:
            assert resps[1].status_code == C.STATUS_CODE_SUCCESS
            rec_leaves_of_mid.append(int(tr[1, dcol]))  # records-round leaf
        mb_pool.append(tr[:, mb_cols].ravel())
        rec_pool.append(tr[:, dcol])

    ecfg = EngineConfig.from_config(cfg)
    assert abs(uniformity_z(np.concatenate(mb_pool), ecfg.mb.leaves, bins=8)) < 6
    assert abs(uniformity_z(np.concatenate(rec_pool), ecfg.rec.leaves, bins=8)) < 6
    # the SAME record read every round draws fresh leaves each time
    assert cross_round_repeat_rate(np.asarray(rec_leaves_of_mid)) < 0.3


def test_rud_transcript_distributions_indistinguishable():
    """Transcripts of all-READ, all-UPDATE and all-DELETE sessions over
    different random engines are two-sample indistinguishable; a
    synthetic op-type leaf bias is caught by the same detector."""
    cfg = GrapevineConfig(
        bucket_cipher_rounds=0,
        max_messages=256,
        max_recipients=32,
        mailbox_cap=8,
        batch_size=4,
        stash_size=96,
    )
    ecfg = EngineConfig.from_config(cfg)
    a, b = bytes([1]) * 32, bytes([2]) * 32

    def session_leaves(rt, seed, n_rounds=12):
        """Create a message, then hammer it with ``rt`` ops; pool the
        records-round leaf of each ``rt`` round itself."""
        rng = random.Random(seed)
        e = GrapevineEngine(cfg, seed=seed)
        (r0,) = e.handle_queries([_req(rng, C.REQUEST_TYPE_CREATE, a, recipient=b, tag=0)],
                                 NOW)
        assert r0.status_code == C.STATUS_CODE_SUCCESS
        pool = []
        for t in range(n_rounds):
            if rt == C.REQUEST_TYPE_DELETE:
                # recreate so the delete target always exists
                (rc,) = e.handle_queries(
                    [_req(rng, C.REQUEST_TYPE_CREATE, a, recipient=b, tag=t & 0xFF)],
                    NOW + 2 * t,
                )
                mid = rc.record.msg_id
            else:
                mid = r0.record.msg_id
            resps, tr = e.handle_queries_with_transcript(
                [_req(rng, rt, b, msg_id=mid, recipient=b)], NOW + 2 * t + 1)
            # the rt op itself must succeed: a silently failing op would
            # make all three pools identical no-op samples
            assert resps[0].status_code == C.STATUS_CODE_SUCCESS
            # records-round leaf: column D in [a_0..a_{D-1}, b, c_...]
            pool.append(int(np.asarray(tr)[0, cfg.resolved_mailbox_choices]))
        return np.asarray(pool)

    pools = {}
    for rt in (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_UPDATE, C.REQUEST_TYPE_DELETE):
        pools[rt] = np.concatenate([session_leaves(rt, s) for s in range(6)])
    n_leaves = ecfg.rec.leaves
    zs = [
        twosample_z(pools[C.REQUEST_TYPE_READ], pools[C.REQUEST_TYPE_UPDATE], n_leaves, bins=8),
        twosample_z(pools[C.REQUEST_TYPE_READ], pools[C.REQUEST_TYPE_DELETE], n_leaves, bins=8),
    ]
    for z in zs:
        assert abs(z) < 6, f"honest R/U/D distributions separated (z={z})"
    # canary: a leaf bias keyed on op type must be caught
    biased = pools[C.REQUEST_TYPE_DELETE] % (n_leaves // 8)  # squashed range
    z_bad = twosample_z(pools[C.REQUEST_TYPE_READ], biased, n_leaves, bins=8)
    assert z_bad > 20, f"detector missed the op-type bias (z={z_bad})"
