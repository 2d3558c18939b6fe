"""Delayed eviction at the ORAM level (grapevine_tpu_torch/oram/round.py)
held against ``grapevine_tpu/oram/round.py``: the same state, ops and
leaves go through the fetch-only ``oram_round`` (``_oram_fetch_round``)
round after round, with ``oram_flush`` every ``evict_window`` rounds, at
windows 2 and 4 and tree-top cache depths 0 and 4. Outputs, transcript
leaves and every state leaf — the ``ebuf_*``/``fetch_tag`` planes
included — are equal bit for bit after every round and flush (tolerance
0). The reference side runs its jnp cipher; the port side runs each of
its cipher impls on the CPU (the kernels' plain versions), whose words
are the same (the fused scatters' junk bucket masked)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grapevine_tpu.oram import round as jround
from grapevine_tpu.oram.path_oram import OramConfig as JCfg, init_oram
from grapevine_tpu_torch.engine.convert import first_difference
from grapevine_tpu_torch.oblivious import cipher_kernels as ck
from grapevine_tpu_torch.oblivious import gather_kernels as gk
from grapevine_tpu_torch.oram import path_oram as tpo
from grapevine_tpu_torch.oram import round as tround
from grapevine_tpu_torch.oram.path_oram import OramConfig, OramState
from grapevine_tpu_torch.u32 import from_numpy, to_numpy
from test_torch_round import _batches, _leaves, jax_kv_apply, torch_kv_apply
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

B = 12


def _geo(window, k):
    return dict(height=5, value_words=4, stash_size=64, cipher_rounds=8,
                top_cache_levels=k, evict_window=window, evict_fetch_count=B,
                evict_buffer_slots=tpo.derive_evict_buffer_slots(32, window, B, 4))


@functools.lru_cache(maxsize=None)
def _jax_programs(jcfg):
    """Jitted reference fetch round and flush, one compile per geometry."""

    @jax.jit
    def step(st, idxs, nl, dl, codes, vals):
        return jround.oram_round(jcfg, st, idxs, nl, dl,
                                 jax_kv_apply(jcfg, idxs, codes, vals))

    return step, jax.jit(lambda st: jround.oram_flush(jcfg, st))


def _assert_same(tst, jst, where, mask_junk):
    got = {f"t.{f}": to_numpy(getattr(tst, f)) for f in tst._fields}
    want = {f"t.{f}": v for f, v in _leaves(jst).items()}
    diff = first_difference(got, want, mask_junk=mask_junk)
    assert diff is None, f"{where}: state differs at {diff}"


@pytest.mark.parametrize("impl", ["jnp", "pallas", "pallas_fused", "pallas_fused_tiled"])
@pytest.mark.parametrize("k", [0, 4])
@pytest.mark.parametrize("window", [2, 4])
def test_fetch_rounds_and_flush_match_jax(window, k, impl):
    geo = _geo(window, k)
    jcfg = JCfg(**geo)
    tcfg = OramConfig(**geo, cipher_impl=impl)
    step, flush = _jax_programs(jcfg)
    jst = init_oram(jcfg, jax.random.PRNGKey(window + k))
    tst = OramState(**{f: from_numpy(v, "cpu") for f, v in _leaves(jst).items()})
    assert tst.fetch_tag.shape == (tcfg.n_buckets_padded,)
    mask = impl.startswith("pallas_fused")
    flushes = 0
    batches = _batches(tcfg, 3 * window + 1, B, 11 * window + k)
    for rnd, (idxs, codes, vals, nl, dl) in enumerate(batches):
        jst, jout, jleaves = step(jst, *(jnp.asarray(a) for a in (idxs, nl, dl, codes, vals)))
        ti, tc, tv, tnl, tdl = (from_numpy(a, "cpu") for a in (idxs, codes, vals, nl, dl))
        tree_before = tst.tree_val.clone()
        tst, tout, tleaves = tround.oram_round(tcfg, tst, ti, tnl, tdl,
                                               torch_kv_apply(tcfg, ti, tc, tv))
        assert torch.equal(tst.tree_val, tree_before), "a fetch round wrote the tree"
        np.testing.assert_array_equal(to_numpy(tleaves), np.asarray(jleaves), f"round {rnd}")
        for key in ("present", "value"):
            np.testing.assert_array_equal(to_numpy(tout[key]), np.asarray(jout[key]),
                                          f"round {rnd} {key}")
        _assert_same(tst, jst, f"round {rnd}", mask)
        if (rnd + 1) % window == 0:
            jst = flush(jst)
            tst = tround.oram_flush(tcfg, tst)
            flushes += 1
            _assert_same(tst, jst, f"flush after round {rnd}", mask)
            assert int(tst.ebuf_rounds) == 0 and bool((tst.ebuf_idx == -1).all())
    # the last round left a partial window: an early flush drains it too
    assert int(tst.ebuf_rounds) == 1 and flushes == 3
    jst, tst = flush(jst), tround.oram_flush(tcfg, tst)
    _assert_same(tst, jst, "partial-window flush", mask)
    assert int(tst.overflow) == 0 and int(tst.ebuf_gen) == 5


def test_flush_target_slots_matches_jax():
    for window, f, h in ((2, 12, 5), (4, 12, 5), (4, 2048, 19), (8, 4096, 10)):
        geo = dict(height=h, value_words=4, evict_window=window,
                   evict_fetch_count=f, evict_buffer_slots=7)
        assert (tround.flush_target_slots(OramConfig(**geo))
                == jround.flush_target_slots(JCfg(**geo)))
    # the production records and mailbox flush sizes at E = 4, B = 2048
    assert tround.flush_target_slots(OramConfig(**dict(
        height=19, value_words=4, evict_window=4, evict_fetch_count=2048,
        evict_buffer_slots=1))) == 163_840
    assert tround.flush_target_slots(OramConfig(**dict(
        height=10, value_words=4, evict_window=8, evict_fetch_count=4096,
        evict_buffer_slots=1))) == 2048


def test_evict_config_validation_and_buffer_sizing_match_jax():
    from grapevine_tpu.oram.path_oram import derive_evict_buffer_slots as jderive

    for args in ((2**20, 4, 2048, 4), (2**11, 8, 4096, 4), (64, 2, 8, 4), (256, 4, 12, 4)):
        assert tpo.derive_evict_buffer_slots(*args) == jderive(*args)
    for bad in (dict(evict_window=0), dict(evict_window=2, evict_fetch_count=4),
                dict(evict_window=2, evict_buffer_slots=4)):
        for cls in (JCfg, OramConfig):
            with pytest.raises(ValueError):
                cls(height=5, value_words=4, **bad)
    assert OramConfig(**_geo(2, 0)).delayed_eviction
    assert not OramConfig(height=5, value_words=4).delayed_eviction


@pytest.mark.parametrize("impl", ["pallas", "pallas_fused", "pallas_fused_tiled"])
def test_cipher_rows_routes_every_pallas_impl_to_the_row_kernel(impl, monkeypatch):
    """Every ``pallas*`` impl ciphers unfused rows through
    ``cipher_rows_pallas`` (its plain version on CPU tensors, no launch),
    as the reference routes them to its Pallas kernel; the words equal
    the ``"jnp"`` path's."""
    rng = np.random.default_rng(3)
    r, z, v = 9, 4, 6
    u = lambda s: from_numpy(rng.integers(0, 2**32, s, dtype=np.uint64).astype(np.uint32), "cpu")
    key, bucket, epoch, pidx, pval = u((8,)), u((r,)), u((r, 2)), u((r, z)), u((r, z * v))
    calls = []
    monkeypatch.setattr(tpo, "cipher_rows_pallas",
                        lambda *a: calls.append(1) or ck.cipher_rows_pallas(*a))
    cfg = dict(height=4, value_words=v, cipher_rounds=8)
    before = (dict(ck.LAUNCHES), dict(gk.LAUNCHES))
    got = tpo.cipher_rows(OramConfig(**cfg, cipher_impl=impl), key, bucket, epoch, pidx, pval)
    want = tpo.cipher_rows(OramConfig(**cfg), key, bucket, epoch, pidx, pval)
    assert calls == [1] and (dict(ck.LAUNCHES), dict(gk.LAUNCHES)) == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
