"""The port's batched ORAM round (grapevine_tpu_torch/oram/round.py) held
against ``grapevine_tpu/oram/round.py:oram_round``: the same state, idxs,
leaves and slot-order KV callback go through both, round after round;
outputs, transcript leaves and every state leaf must be equal bit for bit
(tolerance 0). With the fused cipher path the port's junk bucket is
masked (non-owner rows race there by design)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grapevine_tpu.oram.path_oram import OramConfig as JCfg, init_oram
from grapevine_tpu.oram.path_oram import path_bucket_indices as jax_path
from grapevine_tpu.oram import round as jround
from grapevine_tpu.oram.round import oram_round as jax_round
from grapevine_tpu_torch.engine.convert import first_difference
from grapevine_tpu_torch.oblivious.primitives import scatter_drop, scatter_fresh
from grapevine_tpu_torch.oram import round as tround
from grapevine_tpu_torch.oram.path_oram import OramConfig, OramState, path_bucket_indices
from grapevine_tpu_torch.oram.round import oram_round
from grapevine_tpu_torch.u32 import from_numpy, to_numpy

U32 = jnp.uint32
OP_READ, OP_WRITE, OP_DELETE = 1, 2, 3


def jax_kv_apply(cfg, idxs, codes, vals):
    """Slot-order KV semantics (the model callback of tests/test_round.py)."""

    def apply_batch(vals0, present0):
        b = idxs.shape[0]
        real = idxs != U32(cfg.dummy_index)
        eq = (idxs[:, None] == idxs[None, :]) & real[:, None] & real[None, :]
        tril_s = jnp.tril(jnp.ones((b, b), jnp.bool_), k=-1)
        iota = jnp.arange(b, dtype=jnp.int32)
        is_w = (codes == OP_WRITE) & real
        ch = eq & (is_w | ((codes == OP_DELETE) & real))[None, :]

        def state_at(mask):
            lj = jnp.max(jnp.where(mask, iota[None, :], -1), axis=1)
            has = lj >= 0
            ljc = jnp.clip(lj, 0, b - 1)
            alive = jnp.where(has, is_w[ljc], present0 & real)
            value = jnp.where((has & is_w[ljc])[:, None], vals[ljc],
                              jnp.where(present0[:, None], vals0, 0))
            return alive, value

        present_i, value_i = state_at(ch & tril_s)
        out = {"present": present_i,
               "value": jnp.where(present_i[:, None], value_i, 0)}
        final_alive, final_val = state_at(ch)
        return out, final_val, final_alive

    return apply_batch


def torch_kv_apply(cfg, idxs, codes, vals):
    """The same callback written in PyTorch."""

    def apply_batch(vals0, present0):
        b = idxs.shape[0]
        real = idxs != cfg.dummy_index
        eq = (idxs[:, None] == idxs[None, :]) & real[:, None] & real[None, :]
        iota = torch.arange(b, dtype=torch.int32)
        tril_s = iota[None, :] < iota[:, None]
        is_w = (codes == OP_WRITE) & real
        ch = eq & (is_w | ((codes == OP_DELETE) & real))[None, :]

        def state_at(mask):
            lj = torch.amax(torch.where(mask, iota[None, :], -1), dim=1)
            has = lj >= 0
            ljc = lj.clamp(0, b - 1).long()
            alive = torch.where(has, is_w[ljc], present0 & real)
            value = torch.where((has & is_w[ljc])[:, None], vals[ljc],
                                torch.where(present0[:, None], vals0, 0))
            return alive, value

        present_i, value_i = state_at(ch & tril_s)
        out = {"present": present_i,
               "value": torch.where(present_i[:, None], value_i, 0)}
        final_alive, final_val = state_at(ch)
        return out, final_val, final_alive

    return apply_batch


def _leaves(st):
    return {f: np.asarray(getattr(st, f)) for f in st._fields}


def _batches(cfg, n, b, seed):
    """Random KV op batches with duplicates, dummies and deletes, plus the
    round's fresh leaves, all from numpy."""
    rng = np.random.default_rng(seed)
    live: set[int] = set()
    for _ in range(n):
        idxs = np.empty(b, np.uint32)
        codes = np.empty(b, np.uint32)
        for i in range(b):
            r = rng.random()
            if r < 0.1:
                idxs[i], codes[i] = cfg.dummy_index, OP_READ
            elif r < 0.5 or not live:
                idxs[i], codes[i] = rng.integers(0, cfg.blocks), OP_WRITE
                live.add(int(idxs[i]))
            elif r < 0.8:
                idxs[i], codes[i] = rng.choice(sorted(live)), OP_READ
            else:
                x = int(rng.choice(sorted(live)))
                idxs[i], codes[i] = x, OP_DELETE
                live.discard(x)
        vals = rng.integers(1, 2**32, (b, cfg.value_words), dtype=np.uint64)
        nl = rng.integers(0, cfg.leaves, b).astype(np.uint32)
        dl = rng.integers(0, cfg.leaves, b).astype(np.uint32)
        yield idxs, codes, vals.astype(np.uint32), nl, dl


@pytest.mark.parametrize("impl", ["jnp", "pallas_fused_tiled"])
@pytest.mark.parametrize("k", [0, 4])
def test_oram_round_matches_jax(k, impl):
    geo = dict(height=5, value_words=4, stash_size=64, cipher_rounds=8,
               top_cache_levels=k)
    jcfg = JCfg(**geo)  # the reference side always runs its jnp cipher
    tcfg = OramConfig(**geo, cipher_impl=impl)
    b = 12

    @jax.jit
    def jstep(st, idxs, nl, dl, codes, vals):
        return jax_round(jcfg, st, idxs, nl, dl, jax_kv_apply(jcfg, idxs, codes, vals))

    jst = init_oram(jcfg, jax.random.PRNGKey(k + 1))
    tst = OramState(**{f: from_numpy(v, "cpu") for f, v in _leaves(jst).items()})
    for rnd, (idxs, codes, vals, nl, dl) in enumerate(_batches(tcfg, 6, b, 7 + k)):
        jst, jout, jleaves = jstep(jst, *(jnp.asarray(a) for a in (idxs, nl, dl, codes, vals)))
        ti, tc, tv, tnl, tdl = (from_numpy(a, "cpu") for a in (idxs, codes, vals, nl, dl))
        tst, tout, tleaves = oram_round(tcfg, tst, ti, tnl, tdl,
                                        torch_kv_apply(tcfg, ti, tc, tv))
        np.testing.assert_array_equal(to_numpy(tleaves), np.asarray(jleaves), f"round {rnd}")
        for key in ("present", "value"):
            np.testing.assert_array_equal(to_numpy(tout[key]), np.asarray(jout[key]),
                                          f"round {rnd} {key}")
        got = {f: to_numpy(getattr(tst, f)) for f in tst._fields}
        want = {f: np.asarray(v) for f, v in _leaves(jst).items()}
        # prefix the names so the junk mask finds tree_idx/tree_val pairs
        diff = first_difference({f"t.{f}": v for f, v in got.items()},
                                {f"t.{f}": v for f, v in want.items()},
                                mask_junk=impl != "jnp")
        assert diff is None, f"round {rnd}: state differs at {diff}"
    assert int(tst.overflow) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_occurrence_masks_and_owner_map_match_jax(seed):
    rng = np.random.default_rng(seed)
    cfg = OramConfig(height=5, value_words=4)
    idxs = rng.integers(0, 6, 24).astype(np.uint32)
    idxs[rng.random(24) < 0.25] = cfg.dummy_index
    want = jround.occurrence_masks(jnp.asarray(idxs), cfg.dummy_index)
    got = tround.occurrence_masks(from_numpy(idxs, "cpu"), cfg.dummy_index)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))
    leaves = rng.integers(0, cfg.leaves, 9).astype(np.uint32)
    jflat = jax.vmap(lambda lf: jax_path(JCfg(height=5, value_words=4), lf))(
        jnp.asarray(leaves)).reshape(-1)
    tflat = path_bucket_indices(cfg, from_numpy(leaves, "cpu")).reshape(-1)
    np.testing.assert_array_equal(to_numpy(tflat), np.asarray(jflat))
    np.testing.assert_array_equal(
        to_numpy(tround._bucket_owner_map(cfg, tflat)),
        np.asarray(jround._bucket_owner_map(JCfg(height=5, value_words=4), jflat)),
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_eviction_assignment_sorts_invalid_rows_last(seed):
    """The eviction sort key puts SENTINEL (0xFFFFFFFF, int32 -1) rows
    LAST, as the unsigned reference sort does; a signed sort would put
    them first and change every placement."""
    rng = np.random.default_rng(seed)
    geo = dict(height=5, value_words=4)
    jcfg, tcfg = JCfg(**geo), OramConfig(**geo)
    w, b = 200, 6
    valid = rng.random(w) < 0.6
    wleaf = rng.integers(0, tcfg.leaves, w).astype(np.uint32)
    leaves = rng.integers(0, tcfg.leaves, b).astype(np.uint32)
    flat = np.asarray(jax.vmap(lambda lf: jax_path(jcfg, lf))(
        jnp.asarray(leaves))).reshape(-1)
    bmap = np.asarray(jround._bucket_owner_map(jcfg, jnp.asarray(flat)))
    nslots = b * tcfg.path_len * tcfg.bucket_slots
    plen, z = tcfg.path_len, tcfg.bucket_slots
    want = jround._assign_evictions(
        jcfg, jnp.asarray(valid), jnp.asarray(wleaf), jnp.asarray(bmap), b,
        nslots, "xla", lambda oc, lv, r: (oc * U32(plen) + U32(lv)) * U32(z) + r,
    )
    got = tround._assign_evictions(
        tcfg, torch.from_numpy(valid), from_numpy(wleaf, "cpu"),
        from_numpy(bmap, "cpu"), b, nslots,
        lambda oc, lv, r: (oc * plen + lv) * z + r,
    )
    for w_, g_ in zip(want, got):
        np.testing.assert_array_equal(to_numpy(g_), np.asarray(w_))


def test_scatter_helpers_drop_out_of_bounds_like_jax():
    """PyTorch raises on an out-of-bounds index where JAX's mode="drop"
    drops the write; the port's helpers must drop."""
    dst = np.arange(10, dtype=np.uint32) * 3
    idx = np.array([2, 10, 0, 11, 7], np.int64)  # 10 and 11 out of bounds
    src = np.array([100, 101, 102, 103, 104], np.uint32)
    want = np.asarray(jnp.asarray(dst).at[jnp.asarray(idx)].set(
        jnp.asarray(src), mode="drop"))
    got = scatter_drop(from_numpy(dst, "cpu"), torch.from_numpy(idx),
                       from_numpy(src, "cpu"))
    np.testing.assert_array_equal(to_numpy(got), want)
    want_f = np.asarray(jnp.full((10,), 0xFFFFFFFF, U32).at[jnp.asarray(idx)].set(
        jnp.asarray(src), mode="drop"))
    got_f = scatter_fresh(10, -1, torch.from_numpy(idx), from_numpy(src, "cpu"))
    np.testing.assert_array_equal(to_numpy(got_f), want_f)
