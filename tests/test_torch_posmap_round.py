"""The recursive position map at the ORAM level: the port's ``oram_round``
(E=1), fetch round and ``oram_flush`` (E=2) with ``cfg.posmap`` set,
held against ``grapevine_tpu/oram/round.py`` at tolerance 0 (model: the
reference's ``tests/test_posmap.py``). The same state, ops, outer and
internal leaves go through both, round after round; the outputs, the
``[B, 2]`` transcript (payload tree, internal ORAM) and every state leaf
(the leaf planes and the whole internal tree included) are equal after
every round and flush. Two geometries x two seeds, each cipher impl's
plain version on the port side (junk bucket masked on the fused
scatters), both sort impls."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grapevine_tpu.oram import path_oram as jpo
from grapevine_tpu.oram import posmap as jpm
from grapevine_tpu.oram import round as jround
from grapevine_tpu_torch.engine.convert import first_difference
from grapevine_tpu_torch.oram import path_oram as tpo
from grapevine_tpu_torch.oram import posmap as tpm
from grapevine_tpu_torch.oram import round as tround
from grapevine_tpu_torch.u32 import from_numpy, to_numpy
from test_torch_posmap import jflat
from test_torch_round import _batches, jax_kv_apply, torch_kv_apply
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

B = 12

#: (geometry, posmap spec arguments): blocks 2^7 with a k=3 tree-top
#: cache on both trees, and blocks 2^5 uncached with k=4 entries a block
GEOS = {
    "k3": (dict(height=5, value_words=4, n_blocks=128, stash_size=80, cipher_rounds=8,
                top_cache_levels=3),
           dict(stash_size=80, cipher_rounds=8, top_cache_levels=3)),
    "k0": (dict(height=4, value_words=3, n_blocks=32, stash_size=64, cipher_rounds=8),
           dict(stash_size=64, cipher_rounds=8, entries_per_block=4)),
}


def _cfgs(name, window, impl):
    geo, pm = GEOS[name]
    ev = {}
    if window > 1:
        ev = dict(evict_window=window, evict_fetch_count=B,
                  evict_buffer_slots=tpo.derive_evict_buffer_slots(geo["n_blocks"], window,
                                                                   B, 4))
        pm = dict(pm, evict_window=window, evict_fetch_count=B)
    jspec, tspec = jpm.derive_posmap_spec(geo["n_blocks"], **pm), \
        tpm.derive_posmap_spec(geo["n_blocks"], **pm)
    return (jpo.OramConfig(**geo, **ev, posmap=jspec),
            tpo.OramConfig(**geo, **ev, posmap=tspec, cipher_impl=impl))


@functools.lru_cache(maxsize=None)
def _jax_programs(jcfg, sort_impl):
    @jax.jit
    def step(st, idxs, nl, dl, codes, vals, pnl, pdl):
        return jround.oram_round(jcfg, st, idxs, nl, dl,
                                 jax_kv_apply(jcfg, idxs, codes, vals),
                                 sort_impl=sort_impl, pm_new_leaves=pnl,
                                 pm_dummy_leaves=pdl)

    return step, jax.jit(lambda st: jround.oram_flush(jcfg, st, sort_impl=sort_impl))


def _same(tst, jst, where, mask):
    got = {k: to_numpy(v) for k, v in tpo.oram_leaves(tst).items()}
    diff = first_difference(got, jflat(jst), mask_junk=mask)
    assert diff is None, f"{where}: state differs at {diff}"


def _run(name, window, impl, sort_impl, seed):
    jcfg, tcfg = _cfgs(name, window, impl)
    icfg = tpm.inner_oram_config(tcfg.posmap)
    step, flush = _jax_programs(jcfg, sort_impl)
    jst = jpo.init_oram(jcfg, jax.random.PRNGKey(seed))
    leaves = jflat(jst)
    tst = tpo.oram_from_leaves(tcfg, lambda g: from_numpy(leaves[g], "cpu"))
    mask = impl.startswith("pallas_fused")
    rng = np.random.default_rng(seed + 100)
    n = 3 * window + 2
    for rnd, (idxs, codes, vals, nl, dl) in enumerate(_batches(tcfg, n, B, seed)):
        pnl, pdl = (rng.integers(0, icfg.leaves, B).astype(np.uint32) for _ in range(2))
        arrs = (idxs, nl, dl, codes, vals, pnl, pdl)
        jst, jout, jlv = step(jst, *(jnp.asarray(a) for a in arrs))
        ti, tnl, tdl, tc, tv, tpnl, tpdl = (from_numpy(a, "cpu") for a in arrs)
        tst, tout, tlv = tround.oram_round(tcfg, tst, ti, tnl, tdl,
                                           torch_kv_apply(tcfg, ti, tc, tv),
                                           sort_impl, tpnl, tpdl)
        assert tuple(tlv.shape) == (B, 2)
        np.testing.assert_array_equal(to_numpy(tlv), np.asarray(jlv), f"round {rnd}")
        for key in ("present", "value"):
            np.testing.assert_array_equal(to_numpy(tout[key]), np.asarray(jout[key]),
                                          f"round {rnd} {key}")
        _same(tst, jst, f"round {rnd}", mask)
        if window > 1 and (rnd + 1) % window == 0:
            jst, tst = flush(jst), tround.oram_flush(tcfg, tst, sort_impl)
            _same(tst, jst, f"flush after round {rnd}", mask)
    if window > 1:  # a partial window drains too
        jst, tst = flush(jst), tround.oram_flush(tcfg, tst, sort_impl)
        _same(tst, jst, "partial-window flush", mask)
    assert int(tst.overflow) == 0 and int(tst.posmap.inner.overflow) == 0
    np.testing.assert_array_equal(tpm.read_table(tcfg, tst.posmap),
                                  jpm.read_table(jcfg, jst.posmap))


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("name,impl,sort_impl", [
    ("k3", "pallas_fused_tiled", "radix"), ("k0", "jnp", "xla"),
    ("k0", "pallas_fused", "radix"),
])
def test_recursive_oram_round_matches_jax(name, impl, sort_impl, seed):
    _run(name, 1, impl, sort_impl, seed)


@pytest.mark.parametrize("seed", [5, 6])
@pytest.mark.parametrize("name,impl,sort_impl", [
    ("k3", "pallas_fused", "xla"), ("k0", "pallas", "radix"),
])
def test_recursive_fetch_rounds_and_flush_match_jax(name, impl, sort_impl, seed):
    _run(name, 2, impl, sort_impl, seed)
