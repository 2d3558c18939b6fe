"""The port's single-access Path ORAM (``oram/path_oram.py:oram_access``,
``oram_access_batch``; ``oram/posmap.py:lookup_remap_one``) held against
``grapevine_tpu/oram/path_oram.py`` at tolerance 0 (model: the
reference's ``tests/test_round.py`` and ``tests/test_posmap.py``).

The same state, ops and fresh leaves go through both, batch after batch;
the per-access outputs, the transcript leaves (``[B, 2]`` under a
recursive map) and every state leaf must be equal after every batch. Two
geometries x two seeds, flat and recursive maps, tree-top cache k 0 and
2, cipher impls ``"jnp"`` and ``"pallas"`` (the reference in Pallas
interpret mode, the port's row-cipher wrapper taking its plain version on
CPU tensors). Then the port against itself: ``oram_access_batch`` and
``oram_round`` on one op stream hold the same logical content
(``testing/compare.py:logical_block_map``)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grapevine_tpu.oram import path_oram as jpo
from grapevine_tpu.oram import posmap as jpm
from grapevine_tpu_torch.engine.convert import first_difference
from grapevine_tpu_torch.oram import path_oram as tpo
from grapevine_tpu_torch.oram import posmap as tpm
from grapevine_tpu_torch.oram.round import oram_round
from grapevine_tpu_torch.testing.compare import logical_block_map
from grapevine_tpu_torch.u32 import from_numpy, to_numpy
from test_torch_posmap import jflat
from test_torch_round import OP_DELETE, OP_READ, OP_WRITE, _batches, torch_kv_apply
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

B = 10

#: two geometries: one block a leaf, 32-word values (the Pallas interpret
#: cipher wants rows of ~100 words or more to compile quickly), and two
#: blocks a leaf on a shorter tree
GEOS = {
    "g1": dict(height=5, value_words=32, stash_size=64, cipher_rounds=8),
    "g2": dict(height=4, value_words=24, n_blocks=32, stash_size=72, cipher_rounds=8),
}


def jax_kv_fn(value, present, opnd):
    code, val = opnd
    is_w = code == OP_WRITE
    new_value = jnp.where(is_w, val, value)
    keep = ~((code == OP_DELETE) & present)
    return new_value, keep, is_w, {"present": present,
                                   "value": jnp.where(present, value, 0)}


def torch_kv_fn(value, present, opnd):
    code, val = opnd
    is_w = code == OP_WRITE
    new_value = torch.where(is_w, val, value)
    keep = ~((code == OP_DELETE) & present)
    return new_value, keep, is_w, {"present": present,
                                   "value": torch.where(present, value, 0)}


def _cfgs(geo, recursive, k, impl):
    g = dict(GEOS[geo], top_cache_levels=k)
    jspec = tspec = None
    if recursive:
        blocks = g.get("n_blocks", 1 << g["height"])
        pm = dict(stash_size=g["stash_size"], cipher_rounds=g["cipher_rounds"],
                  top_cache_levels=k)
        jspec = jpm.derive_posmap_spec(blocks, **pm)
        tspec = tpm.derive_posmap_spec(blocks, **pm)
    return (jpo.OramConfig(**g, cipher_impl=impl, posmap=jspec),
            tpo.OramConfig(**g, cipher_impl=impl, posmap=tspec))


@functools.lru_cache(maxsize=None)
def _jax_batch(jcfg):
    return jax.jit(lambda st, idxs, nl, ops, pml: jpo.oram_access_batch(
        jcfg, st, idxs, nl, ops, jax_kv_fn, pm_leaves=pml))


def _same(tst, jst, where):
    got = {k: to_numpy(v) for k, v in tpo.oram_leaves(tst).items()}
    diff = first_difference(got, jflat(jst), mask_junk=False)
    assert diff is None, f"{where}: state differs at {diff}"


def _run(geo, recursive, k, impl, seed):
    jcfg, tcfg = _cfgs(geo, recursive, k, impl)
    step = _jax_batch(jcfg)
    jst = jpo.init_oram(jcfg, jax.random.PRNGKey(seed))
    leaves = jflat(jst)
    tst = tpo.oram_from_leaves(tcfg, lambda g: from_numpy(leaves[g], "cpu"))
    rng = np.random.default_rng(seed + 50)
    il = tpm.inner_oram_config(tcfg.posmap).leaves if recursive else 1
    for bi, (idxs, codes, vals, nl, _dl) in enumerate(_batches(tcfg, 4, B, seed)):
        pml = rng.integers(0, il, B).astype(np.uint32)
        jst, jout, jlv = step(jst, jnp.asarray(idxs), jnp.asarray(nl),
                              (jnp.asarray(codes), jnp.asarray(vals)),
                              jnp.asarray(pml) if recursive else None)
        ti, tnl, tc, tv, tpml = (from_numpy(a, "cpu") for a in (idxs, nl, codes, vals, pml))
        tst, tout, tlv = tpo.oram_access_batch(tcfg, tst, ti, tnl, (tc, tv), torch_kv_fn,
                                               tpml if recursive else None)
        assert tuple(tlv.shape) == ((B, 2) if recursive else (B,))
        np.testing.assert_array_equal(to_numpy(tlv), np.asarray(jlv), f"batch {bi} leaves")
        for key in ("present", "value"):
            np.testing.assert_array_equal(to_numpy(tout[key]), np.asarray(jout[key]),
                                          f"batch {bi} {key}")
        _same(tst, jst, f"batch {bi}")
    assert int(tst.overflow) == 0
    if recursive:
        assert int(tst.posmap.inner.overflow) == 0
        np.testing.assert_array_equal(tpm.read_table(tcfg, tst.posmap),
                                      jpm.read_table(jcfg, jst.posmap))
    return tst


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("geo,k,impl", [
    ("g1", 0, "jnp"), ("g1", 2, "pallas"), ("g2", 0, "pallas"), ("g2", 2, "jnp"),
])
def test_oram_access_batch_matches_jax_flat(geo, k, impl, seed):
    st = _run(geo, False, k, impl, seed)
    assert int((st.stash_idx != -1).sum()) < st.stash_idx.numel()


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("geo,k", [("g1", 0), ("g2", 2)])
def test_oram_access_batch_matches_jax_recursive(geo, k, seed):
    _run(geo, True, k, "jnp", seed)


@pytest.mark.parametrize("recursive", [False, True])
def test_lookup_remap_one_matches_jax(recursive):
    """One lookup and remap per index, dummy included, against the
    reference's: the looked-up leaf, the internal transcript leaf and the
    whole map."""
    jcfg, tcfg = _cfgs("g2", recursive, 0, "jnp")
    jst = jpo.init_oram(jcfg, jax.random.PRNGKey(9))
    jpm_state = jst.posmap
    if recursive:
        leaves = {g[len("posmap."):]: v for g, v in jflat(jst).items()
                  if g.startswith("posmap.")}
        inner = tpo.oram_from_leaves(tpm.inner_oram_config(tcfg.posmap),
                                     lambda g: from_numpy(leaves[f"inner.{g}"], "cpu"))
        tpm_state = tpm.RecursivePosMapState(inner, from_numpy(leaves["dummy_entry"], "cpu"))
    else:
        tpm_state = from_numpy(np.asarray(jpm_state), "cpu")
    rng = np.random.default_rng(1)
    il = tpm.inner_oram_config(tcfg.posmap).leaves if recursive else 1
    one = jax.jit(lambda pm, i, nl, pl: jpm.lookup_remap_one(jcfg, pm, i, nl, pl))
    for idx in [3, tcfg.dummy_index, 3, 17, 0, tcfg.dummy_index, 31]:
        nl, pl = int(rng.integers(0, tcfg.leaves)), int(rng.integers(0, il))
        args = (np.uint32(idx), np.uint32(nl), np.uint32(pl))
        jpm_state, jleaf, jinner = one(jpm_state, *(jnp.asarray(a) for a in args))
        tpm_state, tleaf, tinner = tpm.lookup_remap_one(
            tcfg, tpm_state, *(from_numpy(a, "cpu") for a in args[:2]),
            from_numpy(args[2], "cpu") if recursive else None)
        assert int(to_numpy(tleaf)) == int(np.asarray(jleaf)), idx
        if recursive:
            assert int(to_numpy(tinner)) == int(np.asarray(jinner)), idx
        else:
            assert tinner is None and jinner is None
    np.testing.assert_array_equal(tpm.read_table(tcfg, tpm_state),
                                  jpm.read_table(jcfg, jpm_state))


@pytest.mark.parametrize("seed", [0, 1])
def test_access_batch_equals_round(seed):
    """The same op stream through the port's ``oram_access_batch`` and its
    ``oram_round`` gives the same outputs and, batch after batch, the same
    live blocks with the same values (placement and leaves differ: the two
    draw their leaves apart); then every index reads back the same."""
    cfg = tpo.OramConfig(height=5, value_words=4, stash_size=96, cipher_rounds=8)
    gen = torch.Generator().manual_seed(seed)
    st_seq = tpo.init_oram(cfg, gen, "cpu")
    st_rnd = tpo.init_oram(cfg, torch.Generator().manual_seed(seed), "cpu")
    # the trees are written in place: the two runs need their own planes
    st_rnd = st_rnd._replace(**{f: getattr(st_rnd, f).clone() for f in
                                ("tree_idx", "tree_val", "nonces")})
    rng = np.random.default_rng(seed + 7)
    for bi, (idxs, codes, vals, nl, dl) in enumerate(_batches(cfg, 6, 12, seed)):
        nl2 = rng.integers(0, cfg.leaves, 12).astype(np.uint32)
        ti, tc, tv, tnl, tdl, tnl2 = (from_numpy(a, "cpu")
                                      for a in (idxs, codes, vals, nl, dl, nl2))
        st_seq, out_s, lv_s = tpo.oram_access_batch(cfg, st_seq, ti, tnl2, (tc, tv),
                                                    torch_kv_fn)
        st_rnd, out_r, lv_r = oram_round(cfg, st_rnd, ti, tnl, tdl,
                                         torch_kv_apply(cfg, ti, tc, tv))
        for key in ("present", "value"):
            np.testing.assert_array_equal(to_numpy(out_s[key]), to_numpy(out_r[key]),
                                          f"batch {bi} {key}")
        assert int(lv_s.max()) < cfg.leaves and int(lv_r.max()) < cfg.leaves
        assert logical_block_map(cfg, st_seq) == logical_block_map(cfg, st_rnd), bi
    assert int(st_seq.overflow) == 0 and int(st_rnd.overflow) == 0
    all_idx = torch.arange(cfg.leaves, dtype=torch.int32)
    ops = (torch.full((cfg.leaves,), OP_READ, dtype=torch.int32),
           torch.zeros((cfg.leaves, cfg.value_words), dtype=torch.int32))
    nl = torch.randint(0, cfg.leaves, (cfg.leaves,), generator=gen).to(torch.int32)
    _, back_s, _ = tpo.oram_access_batch(cfg, st_seq, all_idx, nl, ops, torch_kv_fn)
    _, back_r, _ = tpo.oram_access_batch(cfg, st_rnd, all_idx, nl, ops, torch_kv_fn)
    assert back_s["present"].any()
    for key in ("present", "value"):
        assert torch.equal(back_s[key], back_r[key]), key


def test_common_prefix_depth_counts_shared_leading_bits():
    """Equal to the reference's shift-and-compare loop on leaves with the
    top bit set and on words past the tree's height."""
    cfg = tpo.OramConfig(height=6, value_words=1)
    jcfg = jpo.OramConfig(height=6, value_words=1)
    rng = np.random.default_rng(3)
    a = np.concatenate([rng.integers(0, 64, 40), rng.integers(0, 2**32, 8),
                        [0xFFFFFFFF, 0x80000000, 63, 0]]).astype(np.uint32)
    for b in (0, 63, 37, 0xFFFFFFFF):
        want = np.asarray(jpo._common_prefix_depth(jcfg, jnp.asarray(a), jnp.uint32(b)))
        got = tpo._common_prefix_depth(cfg, from_numpy(a, "cpu"), from_numpy(np.uint32(b), "cpu"))
        np.testing.assert_array_equal(got.numpy(), want, f"leaf {b:#x}")
