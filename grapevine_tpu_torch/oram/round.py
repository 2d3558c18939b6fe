"""Batched Path-ORAM access round: one fetch, N ops, one eviction (port of
``grapevine_tpu/oram/round.py:oram_round`` at ``evict_window=1``, single
device, flat position map).

1. **Dedup + fetch**: duplicate indices after the first occurrence fetch a
   fresh dummy path; all B paths are fetched at once, and buckets shared
   by several paths are owned by the lowest column touching them. The
   top ``k`` levels come from the decrypted tree-top cache, the rest from
   the encrypted trees — through the fused gather+decrypt kernel when
   ``cipher_impl="pallas_fused_tiled"``.
2. **Apply**: the vectorized callback resolves slot-order semantics and
   returns each key's final state, committed at its last occurrence.
3. **Evict**: one leaf sort, then a level-synchronous greedy pass
   assigns entries to the deepest fetched bucket on their path;
   leftovers recompact into the stash; owned buckets are written back
   (encrypt+scatter kernel on the fused path) — write transcript ≡ read
   transcript.

The trees and nonces are updated IN PLACE (the analog of the reference's
buffer donation): the ``state`` passed in is consumed.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..oblivious.bucket_cipher import epoch_next
from ..oblivious.gather_kernels import (
    gather_decrypt_rows_tiled,
    scatter_encrypt_rows_tiled,
)
from ..oblivious.primitives import rank_of, scatter_drop, scatter_fresh
from ..u32 import SENTINEL, ult, widen
from .path_oram import (
    OramConfig,
    OramState,
    _path_gather,
    _path_scatter_,
    cipher_rows,
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


def _bucket_owner_map(cfg: OramConfig, flat_b):
    """Dense heap-bucket → owner-column map (lowest column touching the
    bucket; ``B`` = not fetched this round)."""
    plen = cfg.path_len
    b = flat_b.shape[0] // plen
    cols = torch.arange(b, dtype=I32, device=flat_b.device).repeat_interleave(plen)
    bmap = torch.full((cfg.n_buckets_padded,), b, dtype=I32, device=flat_b.device)
    return bmap.scatter_reduce_(0, flat_b.long(), cols, reduce="amin")


def _assign_evictions(cfg: OramConfig, valid, wleaf, bucket_map, n_targets: int,
                      nslots: int, slot_of):
    """Joint level-synchronous greedy eviction assignment: one stable sort
    of the working set by leaf (invalid rows last), then per level a
    segmented rank caps each bucket at Z. Returns ``(slot_tgt int32[W],
    placed bool[W])`` in working-set order; ``slot_tgt == nslots`` means
    unplaced."""
    h, z = cfg.height, cfg.bucket_slots
    w = valid.shape[0]
    dev = valid.device
    skey = torch.where(valid, wleaf, SENTINEL)
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


def oram_round(cfg: OramConfig, state: OramState, idxs, new_leaves,
               dummy_leaves, apply_batch):
    """One batched oblivious access round over this ORAM.

    ``apply_batch(vals0 int32[B,V], present0 bool[B]) -> (outs,
    final_val int32[B,V], final_alive bool[B])`` as in the reference.
    Returns ``(state', outs, leaves int32[B])``; ``leaves`` is the public
    transcript."""
    b = idxs.shape[0]
    z, v, plen = cfg.bucket_slots, cfg.value_words, cfg.path_len
    s = cfg.stash_size
    nslots = b * plen * z
    dev = idxs.device

    # --- 1. dedup, position-map read/remap, path fetch -----------------
    first_occ, last_occ, _ = occurrence_masks(idxs, cfg.dummy_index)
    posmap, leaves = lookup_remap_round(
        cfg, state.posmap, idxs, new_leaves, dummy_leaves, first_occ, last_occ
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

    fused = cfg.cipher_impl == "pallas_fused_tiled" and cfg.encrypted
    with record_function("oram_fetch"):
        if fused:
            pidx, pval = gather_decrypt_rows_tiled(
                state.cipher_key, state.tree_idx, state.tree_val,
                state.nonces, bot_b, z=z, rounds=cfg.cipher_rounds,
            )
        else:
            pidx = _path_gather(state.tree_idx.view(-1, z), bot_b)
            pval = _path_gather(state.tree_val, bot_b)
            pnonce = _path_gather(state.nonces, bot_b)
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
        # non-owner copies of shared buckets are invalidated
        pidx = torch.where(fowner[:, None], pidx, SENTINEL)

    # working set: stash ++ fetched slots ++ b rows for net inserts, plus
    # one spill row (index w) that absorbs the reference's dropped writes
    w = s + nslots + b
    widx_x = torch.cat([state.stash_idx, pidx.reshape(-1),
                        torch.full((b + 1,), SENTINEL, dtype=I32, device=dev)])
    wval_x = torch.cat([state.stash_val, pval.reshape(-1, v),
                        torch.zeros((b + 1, v), dtype=I32, device=dev)])
    widx0 = widx_x[:w]

    # --- 2. vectorized slot-order apply --------------------------------
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
        upd, pos0, torch.where(ins, s + nslots + slot_iota, w)
    ).long()
    widx_x[row_tgt] = torch.where(final_alive, idxs, SENTINEL)
    wval_x[row_tgt] = final_val
    widx, wval = widx_x[:w], wval_x[:w]
    wleaf = working_leaves(posmap, cfg, widx)

    # --- 3. joint level-synchronous greedy eviction --------------------
    with record_function("oram_evict"):
        valid = widx != SENTINEL
        slot_tgt, placed = _assign_evictions(
            cfg, valid, wleaf, bmap, b, nslots,
            lambda oc, level, rank: (oc * plen + level) * z + rank,
        )
        new_pidx = scatter_fresh(nslots, SENTINEL, slot_tgt.long(), widx)
        new_pval = scatter_fresh(nslots, 0, slot_tgt.long(), wval)

        # --- 4. stash recompaction ---------------------------------------
        leftover = valid & ~placed
        starget = torch.where(leftover, rank_of(leftover), s).long()
        stash_idx = scatter_fresh(s, SENTINEL, starget, widx)
        stash_val = scatter_fresh(s, 0, starget, wval)
        n_left = leftover.to(I32).sum()
        stash_dropped = torch.clamp(n_left - s, min=0).to(I32)

    fowner_bot = fowner.reshape(b, plen)[:, kc:].reshape(b * nbot).contiguous()
    bot_pidx = new_pidx.reshape(b, plen, z)[:, kc:].reshape(b * nbot, z).contiguous()
    bot_pval = new_pval.reshape(b, plen, z * v)[:, kc:].reshape(
        b * nbot, z * v
    ).contiguous()
    tree_idx, tree_val, nonces = state.tree_idx, state.tree_val, state.nonces
    with record_function("oram_writeback"):
        if fused:
            # encrypt + scatter + nonce commit in one pass, in place
            scatter_encrypt_rows_tiled(
                state.cipher_key, tree_idx, tree_val, nonces, bot_b,
                fowner_bot, state.epoch, bot_pidx, bot_pval,
                z=z, rounds=cfg.cipher_rounds,
            )
        else:
            epochs_w = state.epoch[None, :].expand(b * nbot, 2)
            enc_pidx, enc_pval = cipher_rows(
                cfg, state.cipher_key, bot_b, epochs_w, bot_pidx, bot_pval
            )
            _path_scatter_(tree_idx.view(-1, z), bot_b, enc_pidx, fowner_bot)
            _path_scatter_(tree_val, bot_b, enc_pval, fowner_bot)
            if cfg.encrypted:
                _path_scatter_(nonces, bot_b, epochs_w, fowner_bot)
        if kc:
            # cached levels write back plaintext, owner-masked
            fowner_top = fowner.reshape(b, plen)[:, :kc].reshape(b * kc)
            cache_idx = scatter_drop(
                state.cache_idx,
                torch.where(fowner_top.repeat_interleave(z), top_slots, -1).long(),
                new_pidx.reshape(b, plen, z)[:, :kc].reshape(-1),
            )
            cache_val = scatter_drop(
                state.cache_val,
                torch.where(fowner_top, top_b, -1).long(),
                new_pval.reshape(b, plen, z * v)[:, :kc].reshape(b * kc, z * v),
            )
        else:
            cache_idx, cache_val = state.cache_idx, state.cache_val

    new_state = state._replace(
        tree_idx=tree_idx,
        tree_val=tree_val,
        cache_idx=cache_idx,
        cache_val=cache_val,
        stash_idx=stash_idx,
        stash_val=stash_val,
        posmap=posmap,
        overflow=state.overflow + stash_dropped,
        nonces=nonces,
        epoch=epoch_next(state.epoch),
    )
    return new_state, outs, leaves
