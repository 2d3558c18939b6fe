"""The port's recursive position map (``grapevine_tpu_torch/oram/posmap.py``
and ``path_oram.leaf_plane_cipher``) held against
``grapevine_tpu/oram/posmap.py`` (model: the reference's
``tests/test_posmap.py``), tolerance 0:

- ``derive_posmap_spec``'s caps and refusals, ``inner_oram_config`` and
  the sizing functions, at test and production geometries;
- ``init_posmap`` from the JAX draws (the table, the internal ORAM and
  the placement permutation injected through ``pack_posmap``): every
  leaf of the internal tree;
- ``lookup_remap_round`` round after round, with duplicates and whole
  batches in one internal block (full collision): the leaves, the
  internal transcript and the whole map state; ``read_table`` equals
  the flat map fed the same rounds;
- ``leaf_plane_cipher`` at cipher rounds 0 and 8.

Geometries are tiny (blocks 2^5-2^7, B <= 16); two geometries x two
seeds each."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grapevine_tpu.oram import path_oram as jpo
from grapevine_tpu.oram import posmap as jpm
from grapevine_tpu.oram.round import occurrence_masks as j_occ
from grapevine_tpu_torch.oram import path_oram as tpo
from grapevine_tpu_torch.oram import posmap as tpm
from grapevine_tpu_torch.oram.round import occurrence_masks as t_occ
from grapevine_tpu_torch.u32 import from_numpy, to_numpy

U32 = jnp.uint32

#: (outer geometry, posmap spec arguments): cipher on with a cached
#: internal tree, and cipher off with an explicit k
GEOS = {
    "c8k2": (dict(height=5, value_words=4, n_blocks=128, stash_size=64,
                  cipher_rounds=8), dict(stash_size=64, cipher_rounds=8,
                                         top_cache_levels=2)),
    "plain_k4": (dict(height=4, value_words=3, n_blocks=32, stash_size=48),
                 dict(stash_size=48, entries_per_block=4)),
}


def _cfgs(name):
    geo, pm = GEOS[name]
    spec_j = jpm.derive_posmap_spec(geo["n_blocks"], **pm)
    spec_t = tpm.derive_posmap_spec(geo["n_blocks"], **pm)
    return jpo.OramConfig(**geo, posmap=spec_j), tpo.OramConfig(**geo, posmap=spec_t)


def jflat(st) -> dict:
    """A JAX ``OramState`` / ``RecursivePosMapState`` as dotted numpy leaves
    (the names of ``path_oram.oram_leaves``)."""
    out = {}
    for f in st._fields:
        x = getattr(st, f)
        if hasattr(x, "_fields"):
            out.update({f"{f}.{g}": v for g, v in jflat(x).items()})
        else:
            out[f] = x if isinstance(x, jax.ShapeDtypeStruct) else np.asarray(x)
    return out


def tflat(st) -> dict:
    """The port's state as the same dotted numpy leaves."""
    if isinstance(st, tpm.RecursivePosMapState):
        out = {f"inner.{g}": to_numpy(v) for g, v in tpo.oram_leaves(st.inner).items()}
        out["dummy_entry"] = to_numpy(st.dummy_entry)
        return out
    return {g: to_numpy(v) for g, v in tpo.oram_leaves(st).items()}


def to_port_pm(cfg, d: dict) -> tpm.RecursivePosMapState:
    icfg = tpm.inner_oram_config(cfg.posmap)
    inner = tpo.oram_from_leaves(icfg, lambda g: from_numpy(d[f"inner.{g}"], "cpu"))
    return tpm.RecursivePosMapState(inner, from_numpy(d["dummy_entry"], "cpu"))


def assert_leaves_equal(got: dict, want: dict, where: str):
    assert got.keys() == want.keys(), where
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], f"{where}: {k}")


def test_derive_posmap_spec_caps_and_refusals_match_jax():
    for blocks in (8, 16, 64, 1 << 10, 1 << 11, 1 << 20, 1 << 24, 1 << 30):
        for kw in (dict(), dict(stash_size=80, cipher_rounds=8, top_cache_levels=4),
                   dict(evict_window=4, evict_fetch_count=2048, top_cache_levels=20),
                   dict(entries_per_block=2)):
            got = tpm.derive_posmap_spec(blocks, **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(
                jpm.derive_posmap_spec(blocks, **kw)), (blocks, kw)
            assert got.inner_leaves == jpm.derive_posmap_spec(blocks, **kw).inner_leaves
    # the production points: 2^10 entries a block at 2^20 records
    rec = tpm.derive_posmap_spec(1 << 20)
    assert (rec.entries_per_block, rec.inner_blocks, rec.inner_height) == (1024, 1024, 9)
    for blocks, kw in ((4, {}), (12, {}), (0, {}), (64, dict(entries_per_block=3)),
                       (64, dict(entries_per_block=1)), (64, dict(entries_per_block=32))):
        for mod in (tpm, jpm):
            with pytest.raises(ValueError):
                mod.derive_posmap_spec(blocks, **kw)


def test_inner_config_and_sizing_match_jax():
    for blocks in (32, 1 << 11, 1 << 20):
        for kw in (dict(cipher_rounds=8, top_cache_levels=4),
                   dict(evict_window=4, evict_fetch_count=64)):
            js, ts = jpm.derive_posmap_spec(blocks, **kw), tpm.derive_posmap_spec(blocks, **kw)
            ji, ti = jpm.inner_oram_config(js), tpm.inner_oram_config(ts)
            for f in dataclasses.fields(ti):
                assert getattr(ti, f.name) == getattr(ji, f.name), f.name
            assert ti.cipher_impl == "jnp"
            h = blocks.bit_length() - 2
            geo = dict(height=h, value_words=16, n_blocks=blocks)
            jc, tc = jpo.OramConfig(**geo, posmap=js), tpo.OramConfig(**geo, posmap=ts)
            assert tpm.posmap_private_bytes(tc) == jpm.posmap_private_bytes(jc)
            assert tpm.posmap_hbm_bytes(tc) == jpm.posmap_hbm_bytes(jc)
            flat_t, flat_j = tpo.OramConfig(**geo), jpo.OramConfig(**geo)
            assert tpm.posmap_private_bytes(flat_t) == jpm.posmap_private_bytes(flat_j)
            assert tpm.posmap_hbm_bytes(flat_t) == 0 == jpm.posmap_hbm_bytes(flat_j)
            assert tpo.oram_leaf_shapes(tc) == {
                k: tuple(v.shape) for k, v in jflat(jax.eval_shape(
                    lambda c=jc: jpo.init_oram(c, jax.random.PRNGKey(0)))).items()}


def _jax_init_parts(jcfg, key):
    """The reference's init_posmap draws, taken apart: the flat table, the
    empty internal ORAM and the placement permutation."""
    icfg = jpm.inner_oram_config(jcfg.posmap)
    table = jpm._flat_table(jcfg, key)
    inner = jpo.init_oram(icfg, jax.random.fold_in(key, 1))
    perm = jax.random.permutation(jax.random.fold_in(key, 2), jcfg.posmap.inner_blocks)
    return table, inner, perm


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("geo", list(GEOS))
def test_init_posmap_from_injected_jax_draws(geo, seed):
    jcfg, tcfg = _cfgs(geo)
    key = jax.random.PRNGKey(seed)
    table, inner, perm = _jax_init_parts(jcfg, key)
    want = jpm.init_posmap(jcfg, key)
    icfg = tpm.inner_oram_config(tcfg.posmap)
    t_inner = tpo.oram_from_leaves(icfg, lambda g: from_numpy(jflat(inner)[g], "cpu"))
    got = tpm.pack_posmap(tcfg, from_numpy(np.asarray(table), "cpu"), t_inner,
                          from_numpy(np.asarray(perm).astype(np.uint32), "cpu"))
    assert_leaves_equal(tflat(got), jflat(want), "init")
    np.testing.assert_array_equal(tpm.read_table(tcfg, got), np.asarray(table)[:tcfg.blocks])
    np.testing.assert_array_equal(jpm.read_table(jcfg, want), tpm.read_table(tcfg, got))
    # the port's own draw: a full internal tree holding the same table
    gen = torch.Generator().manual_seed(seed)
    own = tpm.init_posmap(tcfg, from_numpy(np.asarray(table), "cpu"), gen, "cpu")
    np.testing.assert_array_equal(tpm.read_table(tcfg, own), np.asarray(table)[:tcfg.blocks])


def _rounds(cfg, icfg, n, b, seed):
    """Index batches with duplicates, dummies and whole batches inside one
    internal block, plus the round's fresh outer and internal leaves."""
    rng = np.random.default_rng(seed)
    k = cfg.posmap.entries_per_block
    for r in range(n):
        if r % 3 == 2:  # full collision: every op in one internal block
            blk = rng.integers(0, cfg.posmap.inner_blocks)
            idxs = (blk * k + rng.integers(0, k, b)).astype(np.uint32)
        else:
            idxs = rng.integers(0, cfg.blocks, b).astype(np.uint32)
            idxs[rng.random(b) < 0.15] = cfg.dummy_index
            idxs[1::4] = idxs[0]  # outer duplicates
        leaves = [rng.integers(0, cfg.leaves, b).astype(np.uint32) for _ in range(2)]
        inner = [rng.integers(0, icfg.leaves, b).astype(np.uint32) for _ in range(2)]
        yield idxs, *leaves, *inner


@functools.lru_cache(maxsize=None)
def _jax_lookup(jcfg):
    @jax.jit
    def step(pm, idxs, nl, dl, pnl, pdl):
        fo, lo, _ = j_occ(idxs, jcfg.dummy_index)
        return jpm.lookup_remap_round(jcfg, pm, idxs, nl, dl, fo, lo, pnl, pdl)
    return step


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("geo", list(GEOS))
def test_lookup_remap_round_matches_jax(geo, seed):
    jcfg, tcfg = _cfgs(geo)
    icfg = tpm.inner_oram_config(tcfg.posmap)
    key = jax.random.PRNGKey(seed + 10)
    jst = jpm.init_posmap(jcfg, key)
    tst = to_port_pm(tcfg, jflat(jst))
    flat = from_numpy(np.asarray(jpm._flat_table(jcfg, key)), "cpu")
    step = _jax_lookup(jcfg)
    b = 16
    for rnd, arrs in enumerate(_rounds(tcfg, icfg, 7, b, seed)):
        jst, jleaves, jinner = step(jst, *(jnp.asarray(a) for a in arrs))
        ti, tnl, tdl, tpnl, tpdl = (from_numpy(a, "cpu") for a in arrs)
        fo, lo, _ = t_occ(ti, tcfg.dummy_index)
        tst, tleaves, tinner = tpm.lookup_remap_round(tcfg, tst, ti, tnl, tdl, fo, lo,
                                                      tpnl, tpdl)
        np.testing.assert_array_equal(to_numpy(tleaves), np.asarray(jleaves), f"round {rnd}")
        np.testing.assert_array_equal(to_numpy(tinner), np.asarray(jinner), f"round {rnd}")
        assert_leaves_equal(tflat(tst), jflat(jst), f"round {rnd}")
        # the flat map fed the same round: same leaves, same table
        flat, fleaves, none = tpm.lookup_remap_round(
            tpo.OramConfig(**{**dataclasses.asdict(tcfg), "posmap": None}),
            flat, ti, tnl, tdl, fo, lo)
        assert none is None and torch.equal(fleaves, tleaves)
        np.testing.assert_array_equal(tpm.read_table(tcfg, tst), to_numpy(flat)[:tcfg.blocks])
    assert int(tst.inner.overflow) == 0
    with pytest.raises(ValueError, match="pm_new_leaves"):
        tpm.lookup_remap_round(tcfg, tst, ti, tnl, tdl, fo, lo)


def test_group_last_slot_matches_jax():
    rng = np.random.default_rng(4)
    for b in (1, 5, 64):
        idxs = rng.integers(0, 4, b).astype(np.uint32)
        idxs[rng.random(b) < 0.3] = 9
        want = jpm._group_last_slot(jnp.asarray(idxs), 9, "dense", "xla", 4)
        got = tpm._group_last_slot(from_numpy(idxs, "cpu"), 9)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("rounds", [0, 8])
def test_leaf_plane_cipher_matches_jax(rounds):
    rng = np.random.default_rng(rounds)
    geo = dict(height=6, value_words=5, cipher_rounds=rounds)
    jc, tc = jpo.OramConfig(**geo), tpo.OramConfig(**geo)
    r, z = 40, jc.bucket_slots
    key = rng.integers(0, 2**32, 8, dtype=np.uint64).astype(np.uint32)
    buckets = rng.integers(0, jc.n_buckets_padded, r).astype(np.uint32)
    epochs = rng.integers(0, 2**32, (r, 2), dtype=np.uint64).astype(np.uint32)
    epochs[::5] = 0  # never written: the identity keystream
    pleaf = rng.integers(0, 2**32, (r, z), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jpo.leaf_plane_cipher(jc, *(jnp.asarray(a) for a in (
        key, buckets, epochs, pleaf))))
    got = tpo.leaf_plane_cipher(tc, *(from_numpy(a, "cpu") for a in (
        key, buckets, epochs, pleaf)))
    np.testing.assert_array_equal(to_numpy(got), want)
    if rounds:
        # domain separation: the leaf stream is not the row stream
        from grapevine_tpu_torch.oblivious.bucket_cipher import row_keystream

        row = row_keystream(*(from_numpy(a, "cpu") for a in (key, buckets, epochs)),
                            z, rounds)
        assert not torch.equal(got ^ from_numpy(pleaf, "cpu"), row)
