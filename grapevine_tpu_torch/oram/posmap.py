"""Position maps: the flat private table or a recursive position ORAM
(port of ``grapevine_tpu/oram/posmap.py``).

- **flat**: the private int32[blocks + 1] table (the last entry backs
  the dummy index); ``lookup`` is one private gather, ``remap`` one
  private scatter.
- **recursive**: ``k = entries_per_block`` entries are packed per block
  of a smaller *internal* Path ORAM whose bucket tree sits encrypted in
  device memory like the payload tree. Only the internal ORAM's own flat
  map, stash and tree-top cache stay resident, so private position
  memory shrinks by ``k`` (:func:`posmap_private_bytes`).

A batch of B outer accesses resolves through exactly B internal accesses
every round: outer dummies become internal dummies, and duplicate
internal blocks are deduplicated by the internal round's own occurrence
masks, so every internal transcript entry is an independent uniform
internal leaf. The internal leaves ride the public transcript
(``engine/round_step.py``, the leak monitor's ``*_pm`` streams).

Flat ↔ recursive identity: responses and the payload tree's state are
the same bit for bit, because the initial table is the same draw, every
lookup returns the round-start entry and every remap commits the round's
last write, and the payload tree's per-slot leaf plane carries each
block's leaf so eviction never reads the map. The internal tree's
cipher is the plain PyTorch keystream (``cipher_impl="jnp"``), as the
reference pins it to jnp.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..oblivious.primitives import flag, index1, scatter_drop
from ..oblivious.segmented import grouping_sort, segment_bounds
from ..u32 import SENTINEL, shr
from ..u32 import to_numpy as _t2n

I32 = torch.int32

#: refuse recursion below this block count: the internal tree needs at
#: least 4 blocks for a height-1 two-per-leaf layout
MIN_RECURSIVE_BLOCKS = 8

#: k cap: 2^10 entries a block (4 KiB internal block values)
MAX_ENTRIES_PER_BLOCK_LOG2 = 10

#: oblint taint anchors (``analysis/oblint.py``) of ``lookup_remap_round``
#: standalone: the queried indices, the map state, every fresh leaf and
#: the occurrence masks (secret here; the engine round derives them from
#: its own anchors). The reference's ``oram/posmap.py:311``.
OBLINT_SECRETS = (
    "idxs", "pm_state", "new_leaves", "dummy_leaves",
    "first_occ", "last_occ", "pm_new_leaves", "pm_dummy_leaves",
)


@dataclasses.dataclass(frozen=True)
class PosMapSpec:
    """Static geometry of a recursive position map (embedded in
    ``OramConfig.posmap``, so ``repr``-based checkpoint fingerprints
    cover it: a flat checkpoint never restores into a recursive engine)."""

    #: k: position entries packed per internal-ORAM block
    entries_per_block: int
    #: internal block space = outer blocks / k
    inner_blocks: int
    #: internal tree height (two blocks per leaf)
    inner_height: int
    inner_bucket_slots: int = 4
    inner_stash_size: int = 96
    #: at-rest cipher rounds of the internal tree (the outer tree's)
    inner_cipher_rounds: int = 0
    #: tree-top cache depth of the internal tree (clamped to its height)
    inner_top_cache_levels: int = 0
    #: delayed eviction of the internal tree: one fetch round per outer
    #: round, so its window and fetch count mirror the outer tree's; it
    #: flushes inside the outer ``oram_flush``
    inner_evict_window: int = 1
    inner_evict_fetch_count: int = 0
    inner_evict_buffer_slots: int = 0

    @property
    def inner_leaves(self) -> int:
        return 1 << self.inner_height


def derive_posmap_spec(
    blocks: int,
    stash_size: int = 96,
    cipher_rounds: int = 0,
    entries_per_block: int | None = None,
    top_cache_levels: int = 0,
    evict_window: int = 1,
    evict_fetch_count: int = 0,
) -> PosMapSpec:
    """Recursion geometry from capacity: ``k`` ~ sqrt(blocks), capped at
    2^10; an explicit ``entries_per_block`` must be a power of two >= 2
    with blocks/k >= 4."""
    if blocks < MIN_RECURSIVE_BLOCKS or blocks & (blocks - 1):
        raise ValueError(
            f"recursive posmap needs a power-of-two block space >= "
            f"{MIN_RECURSIVE_BLOCKS}, got {blocks} — use posmap_impl='flat' "
            "at this capacity"
        )
    if entries_per_block is None:
        k = 1 << max(1, min(MAX_ENTRIES_PER_BLOCK_LOG2,
                            (blocks.bit_length() - 1) // 2))
        while blocks // k < 4:
            k >>= 1
    else:
        k = entries_per_block
        if k < 2 or k & (k - 1) or blocks // k < 4 or blocks % k:
            raise ValueError(
                f"entries_per_block must be a power of two >= 2 with "
                f"blocks/k >= 4, got k={k} at blocks={blocks}"
            )
    inner_blocks = blocks // k
    ih = max(1, inner_blocks.bit_length() - 2)
    ebs = 0
    if evict_window > 1:
        from .path_oram import derive_evict_buffer_slots

        ebs = derive_evict_buffer_slots(inner_blocks, evict_window,
                                        evict_fetch_count, 4)
    return PosMapSpec(
        entries_per_block=k,
        inner_blocks=inner_blocks,
        inner_height=ih,
        inner_stash_size=stash_size,
        inner_cipher_rounds=cipher_rounds,
        inner_top_cache_levels=min(top_cache_levels, ih),
        inner_evict_window=evict_window,
        inner_evict_fetch_count=evict_fetch_count if evict_window > 1 else 0,
        inner_evict_buffer_slots=ebs,
    )


def inner_oram_config(spec: PosMapSpec):
    """The internal Path ORAM's ``OramConfig``: a flat-map ORAM (one
    level of recursion) on the plain keystream (``cipher_impl="jnp"``)."""
    from .path_oram import OramConfig

    return OramConfig(
        height=spec.inner_height,
        value_words=spec.entries_per_block,
        bucket_slots=spec.inner_bucket_slots,
        stash_size=spec.inner_stash_size,
        cipher_rounds=spec.inner_cipher_rounds,
        cipher_impl="jnp",
        n_blocks=spec.inner_blocks,
        top_cache_levels=spec.inner_top_cache_levels,
        evict_window=spec.inner_evict_window,
        evict_fetch_count=spec.inner_evict_fetch_count,
        evict_buffer_slots=spec.inner_evict_buffer_slots,
    )


class RecursivePosMapState(NamedTuple):
    """``inner``: the internal ORAM's ``OramState`` (block values are
    packed entry vectors). ``dummy_entry``: the flat table's throwaway
    ``table[blocks]`` entry, kept so both maps carry the same values."""

    inner: object  # OramState
    dummy_entry: torch.Tensor  # int32 scalar


def init_posmap(cfg, table, side: torch.Generator, device) -> RecursivePosMapState:
    """The recursive map holding ``table`` (the flat map's draw, int32
    [blocks + 1]): the internal ORAM (its map and cipher key) and the
    placement permutation are drawn from ``side``, then
    :func:`pack_posmap` places the blocks."""
    from .path_oram import init_oram

    inner = init_oram(inner_oram_config(cfg.posmap), side, device)
    perm = torch.randperm(cfg.posmap.inner_blocks, generator=side, device=device)
    return pack_posmap(cfg, table, inner, perm.to(I32))


def pack_posmap(cfg, table, inner, perm) -> RecursivePosMapState:
    """Pack ``table`` k entries a block into the empty internal ORAM
    ``inner``, initialized FULL: slot s (two slots a leaf) holds block
    ``perm[s]``, so every block sits at a secret uniformly random leaf
    slot, and the internal flat map is set to match. With the cipher on,
    the placed rows are encrypted under epoch 1 before they sit in
    device memory."""
    from .path_oram import cipher_rows

    spec = cfg.posmap
    icfg = inner_oram_config(spec)
    k, nb, z = spec.entries_per_block, spec.inner_blocks, icfg.bucket_slots
    npad = icfg.n_buckets_padded
    device = table.device

    vals = table[: cfg.blocks].reshape(nb, k)  # blocks = nb * k exactly
    density = nb // icfg.leaves  # 2 by construction
    slot_iota = torch.arange(nb, dtype=I32, device=device)
    leaf_of_slot = slot_iota // density
    hb = (1 << icfg.height) - 1 + leaf_of_slot  # leaf buckets
    flat_slot = (hb * z + slot_iota % density).long()

    tree_idx = inner.tree_idx.clone()
    tree_idx[flat_slot] = perm
    val_slots = torch.zeros((npad * z, k), dtype=I32, device=device)
    val_slots[flat_slot] = vals[perm.long()]
    tree_val = val_slots.reshape(npad, z * k)
    pm = inner.posmap.clone()
    pm[perm.long()] = leaf_of_slot

    nonces, epoch = inner.nonces, inner.epoch
    if icfg.encrypted:
        ep1 = torch.tensor([1, 0], dtype=I32, device=device)[None, :].expand(npad, 2)
        buckets = torch.arange(npad, dtype=I32, device=device)
        enc_idx, tree_val = cipher_rows(icfg, inner.cipher_key, buckets, ep1,
                                        tree_idx.reshape(npad, z), tree_val)
        tree_idx = enc_idx.reshape(-1)
        nonces = ep1.contiguous()
        epoch = torch.tensor([2, 0], dtype=I32, device=device)
    inner = inner._replace(tree_idx=tree_idx.contiguous(), tree_val=tree_val.contiguous(),
                           posmap=pm, nonces=nonces, epoch=epoch)
    return RecursivePosMapState(inner=inner, dummy_entry=table[cfg.blocks].clone())


def _group_last_slot(idxs, dummy_index: int, occ_impl: str = "dense",
                     sort_impl: str = "xla", key_bits: int | None = None):
    """int32[B]: the slot of the round's LAST op on the same real index;
    dummies get their own slot. The dense [B,B] form, or under
    ``occ_impl="scan"`` the sorted O(B log B) form (radix with
    ``sort_impl="radix"``), so a scan round holds no [B,B] tensor
    through the map's glue either."""
    b = idxs.shape[0]
    slot_iota = torch.arange(b, dtype=I32, device=idxs.device)
    is_real = idxs != dummy_index
    if occ_impl == "scan":
        perm, inv, seg_start = grouping_sort([idxs], key_bits, sort_impl)
        _, end = segment_bounds(seg_start)
        return torch.where(is_real, perm[end.long()][inv].to(I32), slot_iota)
    eq = (idxs[:, None] == idxs[None, :]) & is_real[:, None] & is_real[None, :]
    last = (b - 1) - torch.argmax(eq.flip(1).to(I32), dim=1).to(I32)
    return torch.where(is_real, last, slot_iota)


def RANGELINT_BOUNDS(cfg, prefix: str = "pm_state") -> dict:
    """Rangelint input-interval anchors (``analysis/rangelint.py``) for one
    ``lookup_remap_round`` argument set at geometry ``cfg``, value for value
    the reference's (``grapevine_tpu/oram/posmap.py:317``): queried indices
    are block ids or the dummy, every leaf argument is a fresh uniform draw
    below its tree's leaf count, and the map state carries the per-plane
    invariants of :func:`.path_oram.RANGELINT_BOUNDS`. The k-entry packing
    offsets (``shr(idx, lg k)``, ``idx & (k-1)``) are then derived clean."""
    lv = cfg.leaves - 1
    b = {
        "idxs": (0, cfg.dummy_index),
        "new_leaves": (0, lv),
        "dummy_leaves": (0, lv),
    }
    if cfg.posmap is None:
        b[prefix] = (0, lv)
    else:
        icfg = inner_oram_config(cfg.posmap)
        il = icfg.leaves - 1
        b["pm_new_leaves"] = (0, il)
        b["pm_dummy_leaves"] = (0, il)
        b[f"{prefix}.inner.posmap"] = (0, il)
        b[f"{prefix}.inner.stash_val"] = (0, lv)
        b[f"{prefix}.inner.cache_val"] = (0, lv)
        b[f"{prefix}.inner.overflow"] = (0, 2**32 - 2**16)
        if not icfg.encrypted:
            b[f"{prefix}.inner.tree_val"] = (0, lv)
        b[f"{prefix}.dummy_entry"] = (0, lv)
    return b


def lookup_remap_round(cfg, pm_state, idxs, new_leaves, dummy_leaves, first_occ,
                       last_occ, pm_new_leaves=None, pm_dummy_leaves=None,
                       sort_impl: str = "xla", occ_impl: str = "dense"):
    """Resolve B positions with a fixed access schedule.

    Returns ``(pm_state', leaves int32[B], inner_leaves int32[B] | None)``:
    ``leaves[i]`` is the round-start entry for first occurrences and
    ``dummy_leaves[i]`` otherwise; the last occurrence's ``new_leaves``
    wins each index's remap. ``inner_leaves`` is the internal ORAM's
    public transcript (None for the flat map)."""
    if cfg.posmap is None:
        leaves = torch.where(first_occ, pm_state[idxs.long()], dummy_leaves)
        remap_tgt = torch.where(last_occ, idxs, cfg.blocks + 1).long()  # OOB = drop
        return scatter_drop(pm_state, remap_tgt, new_leaves), leaves, None
    if pm_new_leaves is None or pm_dummy_leaves is None:
        raise ValueError(
            "recursive posmap lookup needs pm_new_leaves/pm_dummy_leaves "
            "(fresh uniform internal leaves)"
        )
    from .round import oram_round

    spec = cfg.posmap
    icfg = inner_oram_config(spec)
    k = spec.entries_per_block
    lgk = k.bit_length() - 1
    b = idxs.shape[0]
    is_real = idxs != cfg.dummy_index
    # block ids are below 2^30, so the int32 lanes shift as u32 do
    inner_idxs = torch.where(is_real, shr(idxs, lgk), icfg.dummy_index)
    offs = idxs & (k - 1)  # garbage for dummies; never committed
    # the internal round commits each internal block at its LAST
    # occurrence: every winning remap lands on that row (distinct outer
    # indices in one block have distinct offsets, so targets are unique)
    last_slot = _group_last_slot(
        inner_idxs, icfg.dummy_index, occ_impl, sort_impl,
        key_bits=max(1, icfg.dummy_index.bit_length()))

    def apply_pm(vals0, present0):
        looked = vals0.gather(1, offs[:, None].long())[:, 0]
        tgt = torch.where(last_occ & is_real, last_slot * k + offs, b * k).long()
        final = scatter_drop(vals0.reshape(b * k), tgt, new_leaves).reshape(b, k)
        # internal blocks are created full at init and never leave
        return looked, final, torch.ones(b, dtype=torch.bool, device=idxs.device)

    with record_function("posmap"):
        inner2, looked, inner_leaves = oram_round(
            icfg, pm_state.inner, inner_idxs, pm_new_leaves, pm_dummy_leaves,
            apply_pm, sort_impl=sort_impl, occ_impl=occ_impl,
        )
    # decrypted entries are re-masked to the leaf range they were stored
    # under (identity for honest state: leaves is a power of two)
    looked = looked & (cfg.leaves - 1)
    leaves = torch.where(first_occ, looked, dummy_leaves)
    return pm_state._replace(inner=inner2), leaves, inner_leaves


def lookup_remap_one(cfg, pm_state, idx, new_leaf, pm_leaf=None):
    """Single-access lookup and remap (the op-major engine's path).

    Returns ``(pm_state', leaf, inner_leaf | None)``. Flat: one private
    gather and one scatter into a new table. Recursive: ONE internal ORAM
    access per outer access, dummy for dummy (a fixed schedule); the
    throwaway ``dummy_entry`` reproduces the flat table's ``table[blocks]``
    read and remap. ``pm_leaf`` is the fresh internal leaf."""
    if cfg.posmap is None:
        i = index1(idx)
        return pm_state.index_put((i,), new_leaf.reshape(1)), pm_state[i][0], None
    if pm_leaf is None:
        raise ValueError(
            "recursive posmap lookup needs pm_leaf (a fresh uniform "
            "internal leaf)"
        )
    from .path_oram import oram_access

    spec = cfg.posmap
    icfg = inner_oram_config(spec)
    k = spec.entries_per_block
    lgk = k.bit_length() - 1
    is_dummy = idx == cfg.dummy_index
    # block ids are below 2^30, so the int32 lanes shift as u32 do
    inner_idx = torch.where(is_dummy, icfg.dummy_index, shr(idx, lgk))
    off = index1(idx & (k - 1))

    def fn(value, present, operand):
        # remap the entry; keep the block, never insert (always present
        # for real indices: the internal tree is initialized full)
        return (value.index_put((off,), new_leaf.reshape(1)), flag(True, value),
                flag(False, value), value[off][0])

    with record_function("posmap"):
        inner2, looked, inner_leaf = oram_access(icfg, pm_state.inner, inner_idx,
                                                 pm_leaf, None, fn)
    # decrypted entries are re-masked to the leaf range they were stored under
    looked = looked & (cfg.leaves - 1)
    leaf = torch.where(is_dummy, pm_state.dummy_entry, looked)
    dummy2 = torch.where(is_dummy, new_leaf, pm_state.dummy_entry)
    return pm_state._replace(inner=inner2, dummy_entry=dummy2), leaf, inner_leaf


# -- sizing + test/debug views ------------------------------------------


def posmap_private_bytes(cfg) -> int:
    """Resident position-handling bytes (flat: the whole table;
    recursive: the internal ORAM's flat map, stash, scalars and tree-top
    cache — its bucket tree is encrypted device storage)."""
    if cfg.posmap is None:
        return 4 * (cfg.blocks + 1)
    spec = cfg.posmap
    icfg = inner_oram_config(spec)
    s, k = icfg.stash_size, spec.entries_per_block
    table = 4 * (icfg.blocks + 1)
    stash = 4 * s + 4 * s * k  # stash_idx + stash_val + stash_leaf(0)
    scalars = 4 * (1 + 1 + 8 + 2)  # dummy_entry, overflow, key, epoch
    z = icfg.bucket_slots
    cache = icfg.cache_buckets * (4 * z + 4 * z * k)
    return table + stash + scalars + cache


def posmap_hbm_bytes(cfg) -> int:
    """Device-memory bytes the map adds (recursive only): the internal
    bucket tree planes plus the payload tree's leaf plane."""
    if cfg.posmap is None:
        return 0
    icfg = inner_oram_config(cfg.posmap)
    z, k = icfg.bucket_slots, cfg.posmap.entries_per_block
    inner_tree = icfg.n_buckets_padded * (4 * z + 4 * z * k + 8)
    leaf_plane = 4 * cfg.n_buckets_padded * cfg.bucket_slots
    return inner_tree + leaf_plane


def read_table(cfg, pm_state) -> np.ndarray:
    """TEST/DEBUG: the full logical table u32[blocks] from either map
    (decrypting the internal tree as needed). Host-side, never on the
    round path."""
    if cfg.posmap is None:
        return _t2n(pm_state)[: cfg.blocks].copy()
    from ..oblivious.bucket_cipher import row_keystream

    spec = cfg.posmap
    icfg = inner_oram_config(spec)
    k, z = spec.entries_per_block, icfg.bucket_slots
    inner = pm_state.inner
    tidx = _t2n(inner.tree_idx).reshape(-1, z)
    tval = _t2n(inner.tree_val)
    if icfg.encrypted:
        buckets = torch.arange(icfg.n_buckets_padded, dtype=I32,
                               device=inner.tree_val.device)
        ks = _t2n(row_keystream(inner.cipher_key, buckets, inner.nonces,
                                icfg.row_words, icfg.cipher_rounds))
        tidx = tidx ^ ks[:, :z]
        tval = tval ^ ks[:, z:]
    sent = np.uint32(SENTINEL & 0xFFFFFFFF)
    out = np.zeros((cfg.blocks,), np.uint32)
    seen = np.zeros((spec.inner_blocks,), bool)
    rows = tval.reshape(-1, k)
    flat_idx = tidx.reshape(-1)
    live = flat_idx != sent
    # delayed eviction: buckets fetched since the last flush hold stale
    # copies (their live rows are in the buffer, read below)
    stale_b = None
    if icfg.delayed_eviction:
        stale_b = _t2n(inner.fetch_tag) == _t2n(inner.ebuf_gen)
        live &= ~np.repeat(stale_b, z)
    # tree-top cache: cached buckets' rows are stale in the tree; the
    # authoritative plaintext rows live in the cache planes
    ncache = int(inner.cache_idx.numel())
    if ncache:
        live[:ncache] = False
        crows = _t2n(inner.cache_val).reshape(-1, k)
        cidx = _t2n(inner.cache_idx).copy()
        if stale_b is not None:
            cidx[np.repeat(stale_b[: ncache // z], z)] = sent
        for slot in np.nonzero(cidx != sent)[0]:
            blk = int(cidx[slot])
            out[blk * k: (blk + 1) * k] = crows[slot]
            seen[blk] = True
    for slot in np.nonzero(live)[0]:
        blk = int(flat_idx[slot])
        out[blk * k: (blk + 1) * k] = rows[slot]
        seen[blk] = True
    for pidx, pval in ((inner.ebuf_idx, inner.ebuf_val),
                       (inner.stash_idx, inner.stash_val)):
        sidx, sval = _t2n(pidx), _t2n(pval)
        for j in np.nonzero(sidx != sent)[0]:
            blk = int(sidx[j])
            out[blk * k: (blk + 1) * k] = sval[j]
            seen[blk] = True
    if not seen.all():
        raise AssertionError("recursive posmap lost internal blocks")
    return out
