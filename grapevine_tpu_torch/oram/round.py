"""Batched Path-ORAM access round: one fetch, N ops, one eviction (port of
``grapevine_tpu/oram/round.py``, single device).

1. **Dedup + fetch**: duplicate indices after the first occurrence fetch a
   fresh dummy path; all B paths are fetched at once, and buckets shared
   by several paths are owned by the lowest column touching them. The
   top ``k`` levels come from the decrypted tree-top cache, the rest from
   the encrypted trees — through a fused gather+decrypt kernel under
   ``cipher_impl="pallas_fused"`` (the row ring, one row a step) or
   ``"pallas_fused_tiled"`` (one CTA a row), else a gather and
   ``cipher_rows``.
2. **Apply**: the vectorized callback resolves slot-order semantics and
   returns each key's final state, committed at its last occurrence.
3. **Evict**: one leaf sort, then a level-synchronous greedy pass
   assigns entries to the deepest fetched bucket on their path;
   leftovers recompact into the stash; owned buckets are written back
   (a fused encrypt+scatter kernel on the fused paths) — write
   transcript ≡ read transcript.

With a recursive position map (``cfg.posmap``, ``oram/posmap.py``) step
1 resolves positions through one internal ORAM round and also gathers
and decrypts the per-slot leaf plane (the plain keystream,
``leaf_plane_cipher``) beside the fused fetch; eviction reads leaves
from that plane, never from the map, and the plane is re-encrypted and
owner-masked on write-back. The transcript is then ``[B, 2]``: column 0
the payload tree, column 1 the internal ORAM.

Sharded (``mesh`` set, ``parallel/mesh.py``): the tree and nonce planes
are :class:`path_oram.ShardedPlane` s; the fused kernels are bypassed
(the reference's ``axis_name is None and fused`` guards), so the rows are
gathered per shard, reduced onto the controller device and decrypted
there by ``cipher_rows`` (B2 under every ``pallas*`` impl), and the
encrypted rows are written back owner-masked per shard. Every other
plane (stash, position map, cache, eviction buffer, a recursive map's
internal ORAM) is replicated state on the controller device, and the
internal ORAM's rounds and flushes never see the mesh.

Delayed eviction (``evict_window`` > 1): :func:`oram_round` runs
:func:`_oram_fetch_round` instead — steps 1-2, then every live row
recompacts into the private eviction buffer and the tree is not written —
and :func:`oram_flush` evicts the window's working set into the union of
its fetched buckets every ``evict_window`` rounds.

The trees and nonces are updated IN PLACE (the analog of the reference's
buffer donation): the ``state`` passed in is consumed.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..oblivious.bucket_cipher import epoch_next
from ..oblivious.gather_kernels import (
    gather_decrypt_rows,
    gather_decrypt_rows_tiled,
    scatter_encrypt_rows,
    scatter_encrypt_rows_tiled,
)
from ..oblivious.primitives import rank_of, scatter_drop, scatter_fresh
from ..oblivious.radix import radix_rank
from ..oblivious.segmented import grouping_sort, segment_bounds
from ..u32 import SENTINEL, ult, widen
from .path_oram import (
    OramConfig,
    OramState,
    _path_gather,
    _path_scatter_,
    cipher_rows,
    leaf_plane_cipher,
    path_bucket_indices,
    path_slot_indices,
    working_leaves,
)
from .posmap import lookup_remap_round

I32 = torch.int32


def occurrence_masks(idxs, dummy_index: int):
    """(first_occ, last_occ, chain_slot) over real (non-dummy) indices —
    the [B,B]-mask form."""
    b = idxs.shape[0]
    is_real = idxs != dummy_index
    eq = (idxs[:, None] == idxs[None, :]) & is_real[:, None] & is_real[None, :]
    iota = torch.arange(b, dtype=I32, device=idxs.device)
    earlier = iota[None, :] < iota[:, None]  # column slot before row slot
    first_occ = is_real & ~torch.any(eq & earlier, dim=1)
    last_occ = is_real & ~torch.any(eq & earlier.T, dim=1)
    chain_slot = torch.where(
        is_real, torch.argmax(eq.to(I32), dim=1).to(I32), iota
    )
    return first_occ, last_occ, chain_slot


def occurrence_masks_sorted(idxs, dummy_index: int, sort_impl: str = "xla",
                            key_bits: int | None = None):
    """:func:`occurrence_masks` in O(B log B): one sort by (index, slot),
    then segment boundaries in sorted order mark first and last
    occurrences — no [B,B] intermediate, the same masks.
    ``sort_impl="radix"`` with a declared ``key_bits`` bound ranks by
    counting passes instead of the comparison sort."""
    b = idxs.shape[0]
    is_real = idxs != dummy_index
    iota = torch.arange(b, dtype=I32, device=idxs.device)
    perm, inv, seg_start = grouping_sort([idxs], key_bits, sort_impl)
    start, end = segment_bounds(seg_start)
    first_occ = is_real & (iota == start)[inv]
    last_occ = is_real & (iota == end)[inv]
    chain_slot = torch.where(is_real, perm[start.long()][inv].to(I32), iota)
    return first_occ, last_occ, chain_slot


def occurrence(cfg: OramConfig, idxs, occ_impl: str, sort_impl: str):
    """The round's dedup masks under the engine's ``vphases_impl``:
    ``"scan"`` sorts (block indices are bounded: real < blocks, dummy =
    blocks), ``"dense"`` takes the [B,B] masks."""
    if occ_impl == "scan":
        return occurrence_masks_sorted(
            idxs, cfg.dummy_index, sort_impl=sort_impl,
            key_bits=max(1, cfg.dummy_index.bit_length()))
    return occurrence_masks(idxs, cfg.dummy_index)


def _bucket_owner_map(cfg: OramConfig, flat_b):
    """Dense heap-bucket → owner-column map (lowest column touching the
    bucket; ``B`` = not fetched this round)."""
    plen = cfg.path_len
    b = flat_b.shape[0] // plen
    cols = torch.arange(b, dtype=I32, device=flat_b.device).repeat_interleave(plen)
    bmap = torch.full((cfg.n_buckets_padded,), b, dtype=I32, device=flat_b.device)
    return bmap.scatter_reduce_(0, flat_b.long(), cols, reduce="amin")


def _assign_evictions(cfg: OramConfig, valid, wleaf, bucket_map, n_targets: int,
                      nslots: int, slot_of, sort_impl: str = "xla"):
    """Joint level-synchronous greedy eviction assignment: one stable sort
    of the working set by leaf (invalid rows last), then per level a
    segmented rank caps each bucket at Z. Returns ``(slot_tgt int32[W],
    placed bool[W])`` in working-set order; ``slot_tgt == nslots`` means
    unplaced. ``sort_impl="radix"`` ranks by counting passes instead of
    the comparison sort: the same permutation."""
    h, z = cfg.height, cfg.bucket_slots
    w = valid.shape[0]
    dev = valid.device
    skey = torch.where(valid, wleaf, SENTINEL)
    if sort_impl == "radix":
        # leaves are h bits; invalid rows sort last under the 2^h
        # sentinel exactly as under 0xFFFFFFFF (both sorts are stable),
        # so the permutation is the argsort's at h + 1 declared bits
        with record_function("oram_evict_sort"):
            eperm = radix_rank(torch.where(valid, wleaf, 1 << h), h + 1)
    else:
        with record_function("oram_evict_sort"):
            # widened to int64 so the SENTINEL (0xFFFFFFFF) sorts LAST, as u32
            eperm = torch.sort(widen(skey), stable=True).indices
    sleaf = skey[eperm]
    svalid = valid[eperm]
    iota_w = torch.arange(w, dtype=I32, device=dev)
    placed = torch.zeros(w, dtype=torch.bool, device=dev)
    slot_tgt_s = torch.full((w,), nslots, dtype=I32, device=dev)
    # the reference's unsigned min(sleaf, leaves - 1): invalid rows carry
    # the sentinel, valid rows a leaf < leaves
    bleaf = torch.where(svalid, sleaf, cfg.leaves - 1)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    for level in range(h, -1, -1):
        bid = bleaf >> (h - level)  # bucket prefix per entry; sorted ⇒ contiguous
        hb = (1 << level) - 1 + bid
        tgt = bucket_map[hb.clamp(max=cfg.n_buckets_padded - 1).long()]
        bnd = torch.cat([one, bid[1:] != bid[:-1]])
        elig = svalid & ~placed & (tgt != n_targets)
        ei = elig.to(I32)
        ecum = torch.cumsum(ei, 0).to(I32) - ei  # exclusive count
        start = torch.cummax(torch.where(bnd, iota_w, 0), 0).values
        rank = torch.clamp(ecum - ecum[start.long()], min=0)
        chosen = elig & (rank < z)
        slot_tgt_s = torch.where(chosen, slot_of(tgt, level, rank), slot_tgt_s)
        placed = placed | chosen
    slot_tgt = torch.empty_like(slot_tgt_s).scatter_(0, eperm, slot_tgt_s)
    placed_w = torch.empty_like(placed).scatter_(0, eperm, placed)
    return slot_tgt, placed_w


def _fused_kernels(cfg: OramConfig, mesh=None):
    """The (gather+decrypt, encrypt+scatter) kernel pair that
    ``cfg.cipher_impl`` selects, or None for the unfused path. None under
    a mesh: the sharded path keeps gather → reduce → decrypt, so no tree
    plaintext crosses between devices (the reference's
    ``pallas_gather.py:17-20``)."""
    if not cfg.encrypted or mesh is not None:
        return None
    if cfg.cipher_impl == "pallas_fused":
        return gather_decrypt_rows, scatter_encrypt_rows
    if cfg.cipher_impl == "pallas_fused_tiled":
        return gather_decrypt_rows_tiled, scatter_encrypt_rows_tiled
    return None


def _fetch(cfg: OramConfig, state: OramState, idxs, new_leaves, dummy_leaves,
           pm_new_leaves=None, pm_dummy_leaves=None, sort_impl: str = "xla",
           occ_impl: str = "dense", mesh=None):
    """Step 1 of both round programs: dedup, posmap read/remap, the
    owner map, and the decrypted path rows (top ``k`` levels from the
    cache); under a recursive map also the decrypted leaf plane rows
    (``pleaf``) and the internal transcript. Returns a dict of the
    round's public and private pieces."""
    b = idxs.shape[0]
    z, v, plen = cfg.bucket_slots, cfg.value_words, cfg.path_len
    dev = idxs.device
    first_occ, last_occ, _ = occurrence(cfg, idxs, occ_impl, sort_impl)
    posmap, leaves, inner_leaves = lookup_remap_round(
        cfg, state.posmap, idxs, new_leaves, dummy_leaves, first_occ, last_occ,
        pm_new_leaves, pm_dummy_leaves, sort_impl=sort_impl, occ_impl=occ_impl,
    )
    path_b = path_bucket_indices(cfg, leaves)  # [B, plen]
    flat_b = path_b.reshape(b * plen)
    bmap = _bucket_owner_map(cfg, flat_b)
    cols_flat = torch.arange(b, dtype=I32, device=dev).repeat_interleave(plen)
    fowner = bmap[flat_b.long()] == cols_flat

    # tree-top cache split: the top kc levels resolve against the
    # decrypted cache planes; only the bottom plen - kc touch the trees
    kc = cfg.top_cache_levels
    nbot = plen - kc
    bot_b = path_b[:, kc:].reshape(b * nbot).contiguous()
    top_b = path_b[:, :kc].reshape(b * kc).clamp(max=max(cfg.cache_buckets, 1) - 1)
    top_slots = path_slot_indices(cfg, top_b).reshape(-1)

    fused = _fused_kernels(cfg, mesh)
    pleaf = None
    with record_function("oram_fetch"):
        if fused is not None:
            pidx, pval = fused[0](
                state.cipher_key, state.tree_idx, state.tree_val,
                state.nonces, bot_b, z=z, rounds=cfg.cipher_rounds,
            )
        else:
            pidx = _path_gather(state.tree_idx.view(-1, z), bot_b, mesh)
            pval = _path_gather(state.tree_val, bot_b, mesh)
            pnonce = _path_gather(state.nonces, bot_b, mesh)
            pidx, pval = cipher_rows(
                cfg, state.cipher_key, bot_b, pnonce, pidx, pval
            )
        if kc:
            pidx = torch.cat(
                [state.cache_idx[top_slots.long()].reshape(b, kc, z),
                 pidx.reshape(b, nbot, z)], dim=1,
            ).reshape(b * plen, z)
            pval = torch.cat(
                [state.cache_val[top_b.long()].reshape(b, kc, z * v),
                 pval.reshape(b, nbot, z * v)], dim=1,
            ).reshape(b * plen, z * v)
        if cfg.posmap is not None:
            # the leaf plane rides its own plain keystream beside the
            # fused fetch (the kernels cover only the idx/val planes)
            with record_function("leaf_plane"):
                pleaf = leaf_plane_cipher(
                    cfg, state.cipher_key, bot_b,
                    _path_gather(state.nonces, bot_b, mesh),
                    _path_gather(state.tree_leaf.view(-1, z), bot_b, mesh),
                )
            if kc:
                pleaf = torch.cat(
                    [state.cache_leaf[top_slots.long()].reshape(b, kc, z),
                     pleaf.reshape(b, nbot, z)], dim=1,
                )
            pleaf = pleaf.reshape(-1)
    return dict(first_occ=first_occ, last_occ=last_occ, posmap=posmap,
                leaves=leaves, inner_leaves=inner_leaves, path_b=path_b,
                flat_b=flat_b, bmap=bmap, fowner=fowner, bot_b=bot_b,
                top_b=top_b, top_slots=top_slots, pidx=pidx, pval=pval,
                pleaf=pleaf)


def _apply(cfg: OramConfig, idxs, last_occ, keep, head_idx, head_val, pidx,
           pval, apply_batch):
    """Step 2 of both round programs over the working set ``head`` ++
    fetched rows (``keep`` False invalidates a row) ++ B insert rows.
    Returns ``(widx, wval, outs, row_tgt)`` after the round's last op on
    each key has committed the callback's final state; ``row_tgt``
    int64[B] is the working-set row each op committed (``W`` = none)."""
    b = idxs.shape[0]
    v = cfg.value_words
    dev = idxs.device
    pidx = torch.where(keep[:, None], pidx, SENTINEL)
    nh, nslots = head_idx.shape[0], pidx.numel()
    # working set plus one spill row (index w) that absorbs the
    # reference's dropped writes
    w = nh + nslots + b
    widx_x = torch.cat([head_idx, pidx.reshape(-1),
                        torch.full((b + 1,), SENTINEL, dtype=I32, device=dev)])
    wval_x = torch.cat([head_val, pval.reshape(-1, v),
                        torch.zeros((b + 1, v), dtype=I32, device=dev)])
    widx0 = widx_x[:w]

    iota_w = torch.arange(w, dtype=I32, device=dev)
    row_map = scatter_fresh(
        cfg.blocks + 2, w,
        torch.where(ult(widx0, cfg.blocks), widx0, cfg.blocks + 2).long(),
        iota_w,
    )
    pos0 = row_map[idxs.clamp(max=cfg.blocks).long()]  # w = absent
    present0 = pos0 != w
    pos0 = pos0.clamp(max=w - 1)
    vals0 = torch.where(present0[:, None], wval_x[pos0.long()], 0)

    with record_function("oram_apply"):
        outs, final_val, final_alive = apply_batch(vals0, present0)

    # the round's last op on each key commits the callback's final state:
    # updates rewrite (or kill) the existing row; net inserts land in the
    # b reserved rows; everything else writes the spill row
    upd = last_occ & present0
    ins = last_occ & ~present0 & final_alive
    slot_iota = torch.arange(b, dtype=I32, device=dev)
    row_tgt = torch.where(
        upd, pos0, torch.where(ins, nh + nslots + slot_iota, w)
    ).long()
    widx_x[row_tgt] = torch.where(final_alive, idxs, SENTINEL)
    wval_x[row_tgt] = final_val
    return widx_x[:w], wval_x[:w], outs, row_tgt


def _working_leaf_plane(head_leaf, pleaf, row_tgt, new_leaves):
    """Recursive map: the working set's leaves from the leaf planes
    (``head`` ++ fetched rows ++ B insert rows); rows committed this
    round take their key's winning fresh leaf, the value the map's remap
    just recorded."""
    b = new_leaves.shape[0]
    wl = torch.cat([head_leaf, pleaf,
                    torch.zeros(b + 1, dtype=I32, device=pleaf.device)])
    wl[row_tgt] = new_leaves  # the spill row absorbs uncommitted ops
    return wl[:-1]


def _recompact(n: int, widx, wval, keep, wleaf=None):
    """Rows with ``keep`` packed in order into fresh ``n``-row planes
    (the rest dropped); returns ``(idx, val, leaf, dropped int32)``
    (``leaf`` None without a leaf plane)."""
    target = torch.where(keep, rank_of(keep), n).long()
    idx = scatter_fresh(n, SENTINEL, target, widx)
    val = scatter_fresh(n, 0, target, wval)
    leaf = None if wleaf is None else scatter_fresh(n, 0, target, wleaf)
    dropped = torch.clamp(keep.to(I32).sum() - n, min=0).to(I32)
    return idx, val, leaf, dropped


def _write_back(cfg: OramConfig, state: OramState, tgt_b, owner, pidx, pval,
                pleaf=None, mesh=None):
    """Encrypt rows under ``state.epoch`` and write the owned ones into
    the trees in place with their nonce (and, with ``pleaf``, the leaf
    plane under its own keystream). The rest are not written: the fused
    kernels and the unfused path both skip them (on the CPU the fused
    kernels' plain versions send them to the junk bucket, as the
    reference does; heap ids never address it). Under a ``mesh`` each
    shard writes only its own rows."""
    z = cfg.bucket_slots
    fused = _fused_kernels(cfg, mesh)
    tree_idx, tree_val, nonces = state.tree_idx, state.tree_val, state.nonces
    epochs_w = state.epoch[None, :].expand(tgt_b.shape[0], 2)
    if pleaf is not None:
        with record_function("leaf_plane"):
            enc = leaf_plane_cipher(cfg, state.cipher_key, tgt_b, epochs_w, pleaf)
        _path_scatter_(state.tree_leaf.view(-1, z), tgt_b, enc, owner, mesh)
    if fused is not None:
        fused[1](state.cipher_key, tree_idx, tree_val, nonces, tgt_b, owner,
                 state.epoch, pidx, pval, z=z, rounds=cfg.cipher_rounds)
        return
    enc_pidx, enc_pval = cipher_rows(
        cfg, state.cipher_key, tgt_b, epochs_w, pidx, pval
    )
    _path_scatter_(tree_idx.view(-1, z), tgt_b, enc_pidx, owner, mesh)
    _path_scatter_(tree_val, tgt_b, enc_pval, owner, mesh)
    if cfg.encrypted:
        _path_scatter_(nonces, tgt_b, epochs_w, owner, mesh)


def _transcript(f: dict):
    """The round's public transcript: int32[B], or ``[B, 2]`` (payload
    tree, internal ORAM) under a recursive map."""
    if f["inner_leaves"] is None:
        return f["leaves"]
    return torch.stack([f["leaves"], f["inner_leaves"]], dim=1)


def oram_round(cfg: OramConfig, state: OramState, idxs, new_leaves,
               dummy_leaves, apply_batch, sort_impl: str = "xla",
               pm_new_leaves=None, pm_dummy_leaves=None, occ_impl: str = "dense",
               mesh=None):
    """One batched oblivious access round over this ORAM.

    ``apply_batch(vals0 int32[B,V], present0 bool[B]) -> (outs,
    final_val int32[B,V], final_alive bool[B])`` as in the reference.
    Returns ``(state', outs, leaves)``; ``leaves`` int32[B] is the public
    transcript, ``[B, 2]`` under a recursive map (``pm_new_leaves`` /
    ``pm_dummy_leaves`` then supply fresh uniform internal leaves).
    ``sort_impl`` picks the eviction sort (``"xla"`` comparison,
    ``"radix"`` counting passes; the same permutation). ``occ_impl``
    picks the dedup (``"dense"`` [B,B] masks, ``"scan"`` sorted, the
    same masks; the engine's ``vphases_impl``). ``mesh`` (the reference's
    ``axis_name``) runs the sharded round over a state whose tree planes
    are sharded. Under delayed eviction this is the fetch-only
    :func:`_oram_fetch_round`."""
    if cfg.delayed_eviction:
        return _oram_fetch_round(cfg, state, idxs, new_leaves, dummy_leaves,
                                 apply_batch, sort_impl, pm_new_leaves,
                                 pm_dummy_leaves, occ_impl, mesh)
    b = idxs.shape[0]
    z, v, plen = cfg.bucket_slots, cfg.value_words, cfg.path_len
    s = cfg.stash_size
    nslots = b * plen * z
    recursive = cfg.posmap is not None

    f = _fetch(cfg, state, idxs, new_leaves, dummy_leaves, pm_new_leaves,
               pm_dummy_leaves, sort_impl, occ_impl, mesh)
    # non-owner copies of shared buckets are invalidated
    widx, wval, outs, row_tgt = _apply(
        cfg, idxs, f["last_occ"], f["fowner"], state.stash_idx, state.stash_val,
        f["pidx"], f["pval"], apply_batch)
    posmap, fowner = f["posmap"], f["fowner"]
    if recursive:
        wleaf = _working_leaf_plane(state.stash_leaf, f["pleaf"], row_tgt, new_leaves)
    else:
        wleaf = working_leaves(posmap, cfg, widx)

    # --- 3. joint level-synchronous greedy eviction --------------------
    with record_function("oram_evict"):
        valid = widx != SENTINEL
        slot_tgt, placed = _assign_evictions(
            cfg, valid, wleaf, f["bmap"], b, nslots,
            lambda oc, level, rank: (oc * plen + level) * z + rank, sort_impl,
        )
        new_pidx = scatter_fresh(nslots, SENTINEL, slot_tgt.long(), widx)
        new_pval = scatter_fresh(nslots, 0, slot_tgt.long(), wval)
        new_pleaf = (scatter_fresh(nslots, 0, slot_tgt.long(), wleaf)
                     if recursive else None)
        # --- 4. stash recompaction ---------------------------------------
        stash_idx, stash_val, stash_leaf, stash_dropped = _recompact(
            s, widx, wval, valid & ~placed, wleaf if recursive else None
        )

    kc = cfg.top_cache_levels
    nbot = plen - kc

    def bottom(x, width):
        return x.reshape(b, plen, width)[:, kc:].reshape(b * nbot, width).contiguous()

    def top(x, width):
        return x.reshape(b, plen, width)[:, :kc].reshape(b * kc, width)

    fowner_bot = fowner.reshape(b, plen)[:, kc:].reshape(b * nbot).contiguous()
    with record_function("oram_writeback"):
        _write_back(cfg, state, f["bot_b"], fowner_bot, bottom(new_pidx, z),
                    bottom(new_pval, z * v),
                    bottom(new_pleaf, z) if recursive else None, mesh)
        cache_idx, cache_val, cache_leaf = (state.cache_idx, state.cache_val,
                                            state.cache_leaf)
        if kc:
            # cached levels write back plaintext, owner-masked
            top_slots, top_b = f["top_slots"], f["top_b"]
            fowner_top = fowner.reshape(b, plen)[:, :kc].reshape(b * kc)
            slot_tgt_top = torch.where(fowner_top.repeat_interleave(z),
                                       top_slots, -1).long()
            cache_idx = scatter_drop(state.cache_idx, slot_tgt_top,
                                     top(new_pidx, z).reshape(-1))
            cache_val = scatter_drop(
                state.cache_val, torch.where(fowner_top, top_b, -1).long(),
                top(new_pval, z * v),
            )
            if recursive:
                cache_leaf = scatter_drop(state.cache_leaf, slot_tgt_top,
                                          top(new_pleaf, z).reshape(-1))

    new_state = state._replace(
        cache_idx=cache_idx,
        cache_val=cache_val,
        cache_leaf=cache_leaf,
        stash_idx=stash_idx,
        stash_val=stash_val,
        stash_leaf=stash_leaf if recursive else state.stash_leaf,
        posmap=posmap,
        overflow=state.overflow + stash_dropped,
        epoch=epoch_next(state.epoch),
    )
    return new_state, outs, _transcript(f)


def _oram_fetch_round(cfg: OramConfig, state: OramState, idxs, new_leaves,
                      dummy_leaves, apply_batch, sort_impl: str = "xla",
                      pm_new_leaves=None, pm_dummy_leaves=None,
                      occ_impl: str = "dense", mesh=None):
    """The delayed-eviction fetch round (``evict_window`` > 1).

    Steps 1-2 as :func:`oram_round`, except that buckets tagged earlier in
    this window are stale (their live rows already moved to the buffer)
    and are invalidated like non-owner copies. Then every live
    working-set row recompacts into buffer ∪ stash (buffer first; rows
    past C + S drop into the sticky overflow count), the round's leaves
    are appended to the public window ledger, and the fetched buckets are
    tagged with the current generation. The trees, cache, nonces and
    epoch are untouched: zero tree writes, zero encryption."""
    b = idxs.shape[0]
    s, c = cfg.stash_size, cfg.evict_buffer_slots
    recursive = cfg.posmap is not None

    f = _fetch(cfg, state, idxs, new_leaves, dummy_leaves, pm_new_leaves,
               pm_dummy_leaves, sort_impl, occ_impl, mesh)
    flat_b = f["flat_b"]
    fresh = state.fetch_tag[flat_b.long()] != state.ebuf_gen
    widx, wval, outs, row_tgt = _apply(
        cfg, idxs, f["last_occ"], f["fowner"] & fresh,
        torch.cat([state.stash_idx, state.ebuf_idx]),
        torch.cat([state.stash_val, state.ebuf_val]),
        f["pidx"], f["pval"], apply_batch,
    )
    wleaf = None
    if recursive:
        wleaf = _working_leaf_plane(torch.cat([state.stash_leaf, state.ebuf_leaf]),
                                    f["pleaf"], row_tgt, new_leaves)

    # --- 3. recompact EVERYTHING into buffer ∪ stash (no eviction) -----
    with record_function("oram_evict"):
        comb_idx, comb_val, comb_leaf, dropped = _recompact(
            c + s, widx, wval, widx != SENTINEL, wleaf)

    # --- 4. window bookkeeping; the tree/cache/nonces are UNTOUCHED ----
    # the ledger row: rounds < window whenever a fetch round runs (the
    # engine flushes at the window and resets the count); the clamp
    # mirrors the reference's
    row = torch.clamp(state.ebuf_rounds, max=cfg.evict_window - 1) * b
    pos = (row + torch.arange(b, dtype=I32, device=idxs.device)).long()
    ebuf_paths = state.ebuf_paths.index_copy(0, pos, f["leaves"])
    # generations only grow, so a max over duplicate buckets is exact
    fetch_tag = state.fetch_tag.scatter_reduce(
        0, flat_b.long(), state.ebuf_gen.expand(flat_b.shape[0]), reduce="amax"
    )
    new_state = state._replace(
        stash_idx=comb_idx[c:],
        stash_val=comb_val[c:],
        stash_leaf=comb_leaf[c:] if recursive else state.stash_leaf,
        ebuf_idx=comb_idx[:c],
        ebuf_val=comb_val[:c],
        ebuf_leaf=comb_leaf[:c] if recursive else state.ebuf_leaf,
        ebuf_paths=ebuf_paths,
        ebuf_rounds=state.ebuf_rounds + 1,
        fetch_tag=fetch_tag,
        posmap=f["posmap"],
        overflow=state.overflow + dropped,
    )
    return new_state, outs, _transcript(f)


def flush_target_slots(cfg: OramConfig) -> int:
    """Write targets of one flush: the window's fetched buckets
    deduplicated — at most ``window·fetch_count·path_len``, and never
    more than the whole padded heap."""
    return min(cfg.evict_window * cfg.evict_fetch_count * cfg.path_len,
               cfg.n_buckets_padded)


def oram_flush(cfg: OramConfig, state: OramState, sort_impl: str = "xla",
               mesh=None) -> OramState:
    """Batched eviction + write-back of one delayed-eviction window (the
    reference's ``oram_flush``, single device). A recursive map's
    internal tree flushes first, inside the same call.

    1. The window's fetched paths (the public ``ebuf_paths`` ledger;
       rounds past ``ebuf_rounds`` masked) expand to bucket ids and
       deduplicate, by a sort of public data, into ``flush_target_slots``
       targets: every bucket fetched this window once.
    2. Buffer ∪ stash is greedily assigned to the deepest target bucket
       on each entry's path (the same ``_assign_evictions`` body, with a
       [target, slot] output layout).
    3. One encrypt+scatter writes every target bucket under the current
       epoch; cached top buckets go to the plaintext cache planes.
    4. Leftovers recompact into the stash, the buffer empties and the
       generation bumps (re-validating every tagged bucket).

    Deterministic given the state; the trees are updated in place.

    Under a ``mesh`` steps 1, 2 and 4 run on the replicated working set
    and only step 3's tree and nonce writes change: each shard writes the
    target rows it owns, so the union over the mesh is the one-device
    flush bit for bit. The internal tree of a recursive map is
    replicated: its flush never sees the mesh (passing it on would
    owner-mask a replicated plane against its full size)."""
    z, v, plen = cfg.bucket_slots, cfg.value_words, cfg.path_len
    s, c = cfg.stash_size, cfg.evict_buffer_slots
    f = cfg.evict_fetch_count
    ncols = cfg.evict_window * f
    pad = cfg.n_buckets_padded
    t = flush_target_slots(cfg)
    dev = state.ebuf_paths.device
    recursive = cfg.posmap is not None

    posmap = state.posmap
    if recursive:
        from .posmap import inner_oram_config

        posmap = posmap._replace(
            inner=oram_flush(inner_oram_config(cfg.posmap), posmap.inner, sort_impl))

    with record_function("oram_flush"):
        leaves = state.ebuf_paths
        active = torch.arange(ncols, dtype=I32, device=dev) // f < state.ebuf_rounds
        flat_b = path_bucket_indices(cfg, leaves).reshape(ncols * plen)
        # -- 1. public dedup: window bucket set → t compacted targets
        # (bucket ids and pad are below 2^31: a signed sort is exact)
        sb = torch.sort(torch.where(active.repeat_interleave(plen), flat_b, pad)).values
        first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           sb[1:] != sb[:-1]]) & (sb < pad)
        crank = rank_of(first)
        # target slot → bucket id (pad = unused slot)
        tgt_b = scatter_fresh(t, pad, torch.where(first, crank, t).long(), sb)
        # dense bucket id → target slot (t = not a target this window)
        dmap = scatter_fresh(pad, t, torch.where(first, sb, pad).long(), crank)

        # working set = buffer ∪ stash (the fetch round's order)
        widx = torch.cat([state.ebuf_idx, state.stash_idx])
        wval = torch.cat([state.ebuf_val, state.stash_val])
        if recursive:
            wleaf = torch.cat([state.ebuf_leaf, state.stash_leaf])
        else:
            wleaf = working_leaves(posmap, cfg, widx)
        valid = widx != SENTINEL
        slot_tgt, placed = _assign_evictions(
            cfg, valid, wleaf, dmap, t, t * z,
            lambda ts, level, rank: ts * z + rank, sort_impl,
        )
        new_pidx = scatter_fresh(t * z, SENTINEL, slot_tgt.long(), widx)
        new_pval = scatter_fresh(t * z, 0, slot_tgt.long(), wval)
        new_pleaf = (scatter_fresh(t * z, 0, slot_tgt.long(), wleaf)
                     if recursive else None)
        stash_idx, stash_val, stash_leaf, stash_dropped = _recompact(
            s, widx, wval, valid & ~placed, wleaf if recursive else None
        )

        # -- 3. write-back: every target once; cached top buckets (a heap
        # prefix) to the plaintext cache planes
        cb = cfg.cache_buckets
        is_cached = tgt_b < cb  # k = 0 → cb = 0 → all False
        tree_tgt = (tgt_b < pad) & ~is_cached
        _write_back(cfg, state, tgt_b, tree_tgt, new_pidx.view(t, z),
                    new_pval.view(t, z * v),
                    new_pleaf.view(t, z) if recursive else None, mesh)
        cache_idx, cache_val, cache_leaf = (state.cache_idx, state.cache_val,
                                            state.cache_leaf)
        if cfg.top_cache_levels:
            cache_slots = path_slot_indices(
                cfg, tgt_b.clamp(max=max(cb, 1) - 1)
            ).reshape(-1)
            slot_tgt_c = torch.where(is_cached.repeat_interleave(z), cache_slots,
                                     -1).long()
            cache_idx = scatter_drop(state.cache_idx, slot_tgt_c, new_pidx)
            cache_val = scatter_drop(
                state.cache_val, torch.where(is_cached, tgt_b, -1).long(),
                new_pval.view(t, z * v),
            )
            if recursive:
                cache_leaf = scatter_drop(state.cache_leaf, slot_tgt_c, new_pleaf)

    return state._replace(
        cache_idx=cache_idx,
        cache_val=cache_val,
        cache_leaf=cache_leaf,
        stash_idx=stash_idx,
        stash_val=stash_val,
        stash_leaf=stash_leaf if recursive else state.stash_leaf,
        ebuf_idx=torch.full((c,), SENTINEL, dtype=I32, device=dev),
        ebuf_val=torch.zeros((c, v), dtype=I32, device=dev),
        ebuf_leaf=torch.zeros_like(state.ebuf_leaf),
        posmap=posmap,
        ebuf_rounds=torch.zeros_like(state.ebuf_rounds),
        ebuf_gen=state.ebuf_gen + 1,
        overflow=state.overflow + stash_dropped,
        epoch=epoch_next(state.epoch),
    )
