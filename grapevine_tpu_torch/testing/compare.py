"""State-comparison helpers (port of ``grapevine_tpu/testing/compare.py``).

They take the port's ``EngineState`` / ``OramState`` (on any device,
sharded over a mesh or not) and compare them host-side through numpy
u32 views (``engine/convert.py``), so the tests and ``chip_smoke.py`` on the card use the same checks. The
random streams are compared by their generator state (a ``jax.random``
key in the reference).
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.convert import to_numpy
from ..oram.path_oram import OramState, oram_leaves
from ..u32 import SENTINEL
from ..u32 import to_numpy as _t2n

__all__ = [
    "states_equal_excluding_junk",
    "logical_tree_planes",
    "assert_logical_state_equal",
    "logical_block_map",
    "assert_logical_content_equal",
]

_SENT = np.uint32(SENTINEL & 0xFFFFFFFF)


def _leaves(state) -> dict:
    """Flat numpy u32 leaves of an ``EngineState`` or one ``OramState``."""
    if isinstance(state, OramState):
        return {f: _t2n(t) for f, t in oram_leaves(state).items()}
    return to_numpy(state)


def _same_generator(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return torch.equal(a.get_state(), b.get_state())


def _streams_equal(sa, sb) -> bool:
    """The engine's random streams (``rng``, and a recursive map's
    ``pm_rng``) are at the same position; an ``OramState`` has none."""
    if isinstance(sa, OramState):
        return True
    return _same_generator(sa.rng, sb.rng) and _same_generator(sa.pm_rng, sb.pm_rng)


def states_equal_excluding_junk(sa, sb):
    """Engine-state bit-equality with the padded junk bucket masked.

    The fused scatters' plain versions (and the reference's kernels)
    redirect non-owner rows to the LAST (padded) bucket of each tree,
    which heap indices never address, so that bucket's at-rest bytes may
    differ while every path-addressable byte must match exactly. Z is
    derived per tree from the paired ``tree_idx``/``tree_val`` leaves.

    Returns (equal, first_differing_leaf_or_None)."""
    la, lb = _leaves(sa), _leaves(sb)
    if la.keys() != lb.keys():
        return False, "<tree structure>"
    for key, x in la.items():
        y = lb[key]
        if x.shape != y.shape:
            return False, key
        if key.endswith(("tree_val", "nonces")):
            # the fused scatter also commits the write epoch through the
            # junk redirect, so the junk bucket's nonce row may differ too
            x, y = x[:-1], y[:-1]
        elif key.endswith("tree_idx"):
            z = x.size // la[key[: -len("tree_idx")] + "tree_val"].shape[0]
            x, y = x[:-z], y[:-z]
        if not np.array_equal(x, y):
            return False, key
    if not _streams_equal(sa, sb):
        return False, "rng"
    return True, None


def logical_tree_planes(cfg, oram):
    """Decrypted logical content of one ORAM's bucket tree, with the
    tree-top cache overlaid (host-side; never on the round path).

    Returns ``(idx [n, Z], val [n, Z*V], leaf [n, Z] | None)`` plaintext
    u32 planes. Under ``cfg.top_cache_levels = k > 0`` the top 2^k−1
    buckets' tree rows are stale and the authoritative plaintext lives in
    the cache planes, so rows [0, 2^k−1) come from the cache. Under
    delayed eviction the buckets fetched since the last flush are masked
    empty (their live rows are in the eviction buffer). A sharded tree
    (``parallel/mesh.py``) is joined first."""
    from ..oblivious.bucket_cipher import row_keystream
    from ..parallel.mesh import unshard_oram

    oram = unshard_oram(oram)
    z = cfg.bucket_slots
    n = cfg.n_buckets_padded
    idx = _t2n(oram.tree_idx).reshape(n, z).copy()
    val = _t2n(oram.tree_val).copy()
    leaf = _t2n(oram.tree_leaf).reshape(n, z).copy() if oram.tree_leaf.numel() else None
    if cfg.encrypted:
        buckets = torch.arange(n, dtype=torch.int32, device=oram.tree_val.device)
        ks = _t2n(row_keystream(oram.cipher_key, buckets, oram.nonces, cfg.row_words,
                                cfg.cipher_rounds))
        idx ^= ks[:, :z]
        val ^= ks[:, z:]
        del ks
        if leaf is not None:
            leaf ^= _t2n(row_keystream(oram.cipher_key, buckets + n, oram.nonces, z,
                                       cfg.cipher_rounds))
    cb = cfg.cache_buckets
    if cb:
        idx[:cb] = _t2n(oram.cache_idx).reshape(cb, z)
        val[:cb] = _t2n(oram.cache_val)
        if leaf is not None:
            leaf[:cb] = _t2n(oram.cache_leaf).reshape(cb, z)
    if cfg.delayed_eviction:
        stale = _t2n(oram.fetch_tag) == _t2n(oram.ebuf_gen)
        idx[stale] = _SENT
    return idx, val, leaf


def logical_block_map(cfg, oram) -> dict:
    """{block index: value bytes} of every live block in one ORAM: tree
    planes (cache overlaid, stale buckets masked) ∪ eviction buffer ∪
    stash. Placement-free (host-side; never on the round path)."""
    v = cfg.value_words
    idx, val, _leaf = logical_tree_planes(cfg, oram)
    out: dict = {}
    rows = val.reshape(-1, v)
    flat = idx.reshape(-1)
    for slot in np.nonzero(flat != _SENT)[0]:
        out[int(flat[slot])] = rows[slot].tobytes()
    for pidx, pval in ((oram.ebuf_idx, oram.ebuf_val), (oram.stash_idx, oram.stash_val)):
        sidx, sval = _t2n(pidx), _t2n(pval)
        for j in np.nonzero(sidx != _SENT)[0]:
            blk = int(sidx[j])
            assert blk not in out, (
                f"block {blk} lives in two places — the "
                "tree/buffer/stash partition invariant broke"
            )
            out[blk] = sval[j].tobytes()
    return out


def _assert_engine_scalars_equal(sa, sb, ctx: str) -> None:
    for f in ("freelist", "free_top", "recipients", "seq", "hash_key", "id_key"):
        assert np.array_equal(_t2n(getattr(sa, f)), _t2n(getattr(sb, f))), (
            f"{ctx}: {f} diverges")
    assert _streams_equal(sa, sb), f"{ctx}: rng diverges"


def assert_logical_content_equal(ecfg_a, sa, ecfg_b, sb, ctx=""):
    """Cross-``evict_every`` final-state contract: the two engines hold
    the SAME live blocks with the SAME values and positions, and every
    engine scalar is equal; physical placement may differ."""
    from ..oram.posmap import read_table

    for tree in ("rec", "mb"):
        ca, cb_ = getattr(ecfg_a, tree), getattr(ecfg_b, tree)
        oa, ob = getattr(sa, tree), getattr(sb, tree)
        ma, mb_ = logical_block_map(ca, oa), logical_block_map(cb_, ob)
        assert set(ma) == set(mb_), (
            f"{ctx}: {tree} live-block sets diverge "
            f"(only-a={sorted(set(ma) - set(mb_))[:8]}, "
            f"only-b={sorted(set(mb_) - set(ma))[:8]})"
        )
        bad = [k for k in ma if ma[k] != mb_[k]]
        assert not bad, f"{ctx}: {tree} block values diverge at {bad[:8]}"
        assert np.array_equal(read_table(ca, oa.posmap), read_table(cb_, ob.posmap)), (
            f"{ctx}: {tree} logical position table diverges")
        for f in ("overflow", "cipher_key"):
            assert np.array_equal(_t2n(getattr(oa, f)), _t2n(getattr(ob, f))), (
                f"{ctx}: {tree}.{f} diverges")
    _assert_engine_scalars_equal(sa, sb, ctx)


def assert_logical_state_equal(ecfg_a, sa, ecfg_b, sb, ctx=""):
    """Cached↔uncached final-state contract: every logical plane, stash,
    position map and scalar equal (ciphertext at cached levels may
    diverge). Works across differing ``top_cache_levels`` and across
    flat/recursive maps (internal trees compared logically too)."""
    from ..oram.posmap import inner_oram_config

    for tree in ("rec", "mb"):
        ca, cb_ = getattr(ecfg_a, tree), getattr(ecfg_b, tree)
        oa, ob = getattr(sa, tree), getattr(sb, tree)
        pa = logical_tree_planes(ca, oa)
        pb = logical_tree_planes(cb_, ob)
        for name, x, y in zip(("idx", "val", "leaf"), pa, pb):
            if x is None and y is None:
                continue
            # mask the padded junk bucket (states_equal_excluding_junk)
            assert np.array_equal(x[:-1], y[:-1]), f"{ctx}: {tree} logical {name} plane diverges"
        for f in ("stash_idx", "stash_val", "stash_leaf", "overflow", "epoch", "cipher_key"):
            assert np.array_equal(_t2n(getattr(oa, f)), _t2n(getattr(ob, f))), (
                f"{ctx}: {tree}.{f} diverges")
        if ca.posmap is None:
            assert np.array_equal(_t2n(oa.posmap), _t2n(ob.posmap)), (
                f"{ctx}: {tree} flat posmap diverges")
        else:
            ia, ib = inner_oram_config(ca.posmap), inner_oram_config(cb_.posmap)
            qa = logical_tree_planes(ia, oa.posmap.inner)
            qb = logical_tree_planes(ib, ob.posmap.inner)
            for name, x, y in zip(("idx", "val"), qa[:2], qb[:2]):
                assert np.array_equal(x[:-1], y[:-1]), (
                    f"{ctx}: {tree} inner posmap logical {name} diverges")
            for f in ("stash_idx", "stash_val", "posmap", "overflow"):
                assert np.array_equal(_t2n(getattr(oa.posmap.inner, f)),
                                      _t2n(getattr(ob.posmap.inner, f))), (
                    f"{ctx}: {tree} inner posmap {f} diverges")
            assert np.array_equal(_t2n(oa.posmap.dummy_entry), _t2n(ob.posmap.dummy_entry)), (
                f"{ctx}: {tree} posmap dummy_entry diverges")
    _assert_engine_scalars_equal(sa, sb, ctx)
