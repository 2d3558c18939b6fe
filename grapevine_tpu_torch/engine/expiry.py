"""Expiry sweep: whole-tree timestamped eviction (port of
``grapevine_tpu/engine/expiry.py``).

One data-independent pass over both ORAMs (the access pattern is the
whole tree, so it reveals nothing): records older than the expiry period
are invalidated, their mailbox entries cleared, emptied mailboxes release
their recipient slot, and the free-block list is rebuilt. Timestamps come
from the untrusted host clock, as in the reference; a tampered clock can
evict early or late, but the sweep touches every bucket regardless.

With the at-rest bucket cipher on, each tree is walked in row chunks:
decrypt the chunk into one chunk-sized scratch buffer that every chunk
reuses, expire in that buffer, re-encrypt under the tree's next epoch
straight back into the tree rows, and zero the buffer at the end. At no
point does more than one chunk of plaintext exist in device memory (a
mid-sweep memory snapshot exposes at most ~8 M words, not the bus). The
trees are updated in place; the nonces take the old epoch and the epoch
advances only after the last chunk, as in the reference.

A recursive position map adds the per-slot leaf plane, encrypted under
the same per-bucket nonces: the sweep re-keys every nonce, so the plane
is re-keyed too (``path_oram.leaf_plane_cipher``'s plain keystream): the
new epoch's keystream and the old nonce's are XORed into the ciphertext
in place, so no leaf is ever in plaintext, in passes of up to 2^16 rows
(a plane row is Z words: the rows' chunks would make thousands of tiny
launches, and a pass's keystream temporaries, ~240 bytes a row, stay
under one chunk of the rows). Its values never change, and the internal
position tree is not swept.

The cipher is the round's (``oram/path_oram.py:cipher_rows``): every
``pallas*`` impl on CUDA tensors runs the row-cipher kernel
(``oblivious/cipher_kernels.py:cipher_rows_pallas``, B2), which raises
if it cannot launch; ``"jnp"``, and any impl on CPU tensors, runs the
plain keystream (``bucket_cipher.row_keystream``). Both give the
reference's words.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..oblivious.bucket_cipher import epoch_next
from ..oblivious.primitives import is_zero_words, u64_le, u64_sub
from ..oblivious.radix import partition_rank
from ..oram.path_oram import (
    OramConfig,
    OramState,
    ShardedPlane,
    cipher_rows,
    leaf_plane_cipher,
)
from ..u32 import SENTINEL, c32, ult
from .state import (
    ENT_SEQ,
    ENT_SEQH,
    ENT_TS,
    ENT_TSH,
    ENTRY_WORDS,
    KEY_WORDS,
    REC_TS,
    REC_TSH,
    EngineConfig,
    EngineState,
)

I32 = torch.int32


def _expired(ts_lo, ts_hi, now_lo, now_hi, period) -> torch.Tensor:
    """Strict '>' age test over u64 lane pairs (now - ts > period).

    Guarded against wraparound: a record stamped *ahead* of the sweep
    clock is never treated as ancient (the oracle's signed comparison
    keeps it, so the engine must too)."""
    le = u64_le(ts_lo, ts_hi, now_lo, now_hi)
    d_lo, d_hi = u64_sub(now_lo, now_hi, ts_lo, ts_hi)
    return le & ((d_hi != 0) | ult(period, d_lo))


#: leaf-plane rows re-keyed a pass (Z words a row; ~16 MB of keystream
#: temporaries)
_LEAF_ROWS = 1 << 16


def _chunk_rows(cfg: OramConfig) -> int:
    """Rows per chunk: power of two, ~8M words of keystream."""
    n = cfg.n_buckets_padded
    rpc = 1
    while rpc * 2 <= n and rpc * 2 * cfg.row_words <= (1 << 23):
        rpc *= 2
    return rpc


def _tree_pieces(cfg: OramConfig, oram: OramState) -> list:
    """``(first bucket id, idx rows [r, Z], val rows, nonce rows, leaf rows
    or None)`` of each device-resident piece of the tree: the whole tree,
    or under a mesh each shard's heap rows (its scratch row left out)."""
    z = cfg.bucket_slots
    planes = [oram.tree_idx.view(-1, z), oram.tree_val, oram.nonces]
    planes.append(oram.tree_leaf.view(-1, z) if cfg.posmap is not None else None)
    if not isinstance(oram.tree_val, ShardedPlane):
        return [(0, *planes)]
    n_local = oram.tree_val.n_local
    cols = [p.local() if p is not None else [None] * len(oram.tree_val.shards)
            for p in planes]
    return [(i * n_local, *piece) for i, piece in enumerate(zip(*cols))]


def _swept_nonces(oram: OramState):
    """The nonce plane after a sweep: every row the old epoch."""
    if isinstance(oram.nonces, ShardedPlane):
        return ShardedPlane([oram.epoch.to(s.device)[None, :].expand(s.shape[0], 2).contiguous()
                             for s in oram.nonces.shards], oram.nonces.n_local)
    return oram.epoch[None, :].expand(oram.nonces.shape[0], 2).contiguous()


def _chunked_tree_sweep(cfg: OramConfig, oram: OramState, carry, body):
    """Run ``body(carry, idx [rpc, Z], val [rpc, Z*V]) -> carry`` over the
    whole tree in chunks; ``body`` edits the plaintext chunk in place.
    Returns (carry, OramState with the swept tree, leaf plane, nonces and
    epoch).

    A sharded tree (``parallel/mesh.py``) is walked shard by shard, each
    shard's rows under their global bucket ids, with chunks that never
    straddle a shard; the plaintext chunk lives on the controller device
    (the epoch's), so a shard on another device ships only ciphertext."""
    z, zv = cfg.bucket_slots, cfg.bucket_slots * cfg.value_words
    n = cfg.n_buckets_padded
    dev = oram.epoch.device
    pieces = _tree_pieces(cfg, oram)
    rpc = min(_chunk_rows(cfg), pieces[0][2].shape[0])
    bids = torch.arange(n, dtype=I32, device=dev)
    new_ep = oram.epoch[None, :].expand(rpc, 2).contiguous()
    if cfg.posmap is not None and cfg.encrypted:
        # before the nonces move: the old nonce's keystream comes off
        with record_function("leaf_plane"):
            for base, _, _, nonces, tree_leaf in pieces:
                gb = bids[base:base + tree_leaf.shape[0]]
                for lo in range(0, tree_leaf.shape[0], _LEAF_ROWS):
                    rows = slice(lo, lo + _LEAF_ROWS)
                    ep = oram.epoch[None, :].expand(gb[rows].shape[0], 2)
                    tree_leaf[rows] = leaf_plane_cipher(
                        cfg, oram.cipher_key, gb[rows], nonces[rows].to(dev),
                        leaf_plane_cipher(cfg, oram.cipher_key, gb[rows], ep,
                                          tree_leaf[rows].to(dev))).to(tree_leaf.device)
    # the one chunk of plaintext every chunk reuses
    pidx = torch.empty((rpc, z), dtype=I32, device=dev)
    pval = torch.empty((rpc, zv), dtype=I32, device=dev)
    for base, tree_idx, tree_val, nonces, _ in pieces:
        gb = bids[base:base + tree_val.shape[0]]
        here = tree_val.device == dev
        for lo in range(0, tree_val.shape[0], rpc):
            rows = slice(lo, lo + rpc)
            cipher_rows(cfg, oram.cipher_key, gb[rows], nonces[rows].to(dev),
                        tree_idx[rows].to(dev), tree_val[rows].to(dev), out=(pidx, pval))
            if cfg.delayed_eviction:
                # buckets fetched since the last flush hold stale copies (their
                # live rows are in the eviction buffer, swept like the stash):
                # masking them keeps liveness and recipient counts exact, and
                # the re-encrypt below writes the cleaned rows back
                tag = oram.fetch_tag[base + lo:base + lo + rpc]
                pidx.masked_fill_((tag == oram.ebuf_gen)[:, None], SENTINEL)
            carry = body(carry, pidx, pval)
            if here:
                cipher_rows(cfg, oram.cipher_key, gb[rows], new_ep, pidx, pval,
                            out=(tree_idx[rows], tree_val[rows]))
            else:
                enc_idx, enc_val = cipher_rows(cfg, oram.cipher_key, gb[rows], new_ep,
                                               pidx, pval)
                tree_idx[rows].copy_(enc_idx)
                tree_val[rows].copy_(enc_val)
    pidx.zero_()
    pval.zero_()
    new = oram
    if cfg.encrypted:
        new = oram._replace(nonces=_swept_nonces(oram), epoch=epoch_next(oram.epoch))
    return carry, new


def _stale_cache_idx(cfg: OramConfig, oram: OramState) -> torch.Tensor:
    """The tree-top cache's slot ids as ``[cache_buckets, Z]`` (a copy),
    stale cached buckets masked to SENTINEL under delayed eviction."""
    cidx = oram.cache_idx.reshape(-1, cfg.bucket_slots).clone()
    if cfg.delayed_eviction:
        stale = oram.fetch_tag[: cfg.cache_buckets] == oram.ebuf_gen
        cidx.masked_fill_(stale[:, None], SENTINEL)
    return cidx


def expiry_sweep(ecfg: EngineConfig, state: EngineState, now, period,
                 now_hi=0) -> EngineState:
    """Expire every record with ``now - ts > period`` (u64 clock lanes
    ``now``/``now_hi``, u32 ``period``; ints or 0-d tensors). The trees
    are swept in place (consumed, like a donated buffer)."""
    dev = state.free_top.device

    def lane(x):
        if not isinstance(x, torch.Tensor) and not 0 <= int(x) < 1 << 32:
            # the reference's U32(x) raises here too; wrapping would sweep
            # with another clock or period
            raise OverflowError(f"{int(x)} does not fit in a u32 lane")
        return torch.as_tensor(c32(int(x)), dtype=I32, device=dev)

    now, now_hi, period = lane(now), lane(now_hi), lane(period)

    # --- records ORAM: invalidate expired blocks, gather liveness ------
    rcfg = ecfg.rec
    z, v = rcfg.bucket_slots, rcfg.value_words
    n_msgs = ecfg.max_messages

    def mark(present, ix):
        # slot ids >= n_msgs (SENTINEL, or garbage) land in the spill row
        present[torch.where(ult(ix, n_msgs), ix, n_msgs).reshape(-1).long()] = True
        return present

    def rec_body(present, ix, vl):
        ts_lo = vl[:, REC_TS::v][:, :z]
        ts_hi = vl[:, REC_TSH::v][:, :z]
        ix.masked_fill_((ix != SENTINEL) & _expired(ts_lo, ts_hi, now, now_hi, period),
                        SENTINEL)
        return mark(present, ix)

    def rec_private(pidx, pval):
        dead = (pidx != SENTINEL) & _expired(pval[:, REC_TS], pval[:, REC_TSH], now,
                                             now_hi, period)
        return torch.where(dead, SENTINEL, pidx)

    present = torch.zeros((n_msgs + 1,), dtype=torch.bool, device=dev)
    with record_function("sweep_records"):
        present, rec = _chunked_tree_sweep(rcfg, state.rec, present, rec_body)
        # tree-top cache: plaintext private state with the stash's
        # standing (its tree rows are stale empty ciphertext, re-keyed
        # harmlessly above): same body, no cipher
        if rcfg.top_cache_levels:
            cidx = _stale_cache_idx(rcfg, rec)
            present = rec_body(present, cidx, rec.cache_val)
            rec = rec._replace(cache_idx=cidx.reshape(-1))
    # stash and eviction buffer rows sweep directly
    stash_idx = rec_private(state.rec.stash_idx, state.rec.stash_val)
    present = mark(present, stash_idx)
    rec = rec._replace(stash_idx=stash_idx)
    if rcfg.delayed_eviction:
        ebuf_idx = rec_private(state.rec.ebuf_idx, state.rec.ebuf_val)
        present = mark(present, ebuf_idx)
        rec = rec._replace(ebuf_idx=ebuf_idx)

    # --- mailbox ORAM: clear expired entries, drop empty mailboxes -----
    k, cap = ecfg.mb_slots, ecfg.mailbox_cap
    mw = KEY_WORDS + ENTRY_WORDS * cap

    def sweep_mb_(idx, val):
        """In place over ``idx`` [...] and ``val`` (one block of K
        mailboxes per idx entry); returns the keys [..., K, 8] and the
        live key count."""
        blocks = val.view(-1, k, mw)
        keys = blocks[:, :, :KEY_WORDS]
        entries = blocks[:, :, KEY_WORDS:].unflatten(-1, (cap, ENTRY_WORDS))
        valid = (entries[..., ENT_SEQ] | entries[..., ENT_SEQH]) != 0
        dead = valid & _expired(entries[..., ENT_TS], entries[..., ENT_TSH], now,
                                now_hi, period)
        entries.masked_fill_(dead[..., None], 0)
        mbox_live = ((entries[..., ENT_SEQ] | entries[..., ENT_SEQH]) != 0).any(-1)
        keys.masked_fill_(~mbox_live[..., None], 0)
        key_live = ~is_zero_words(keys)  # [n, K]
        # blocks with no live mailbox leave the ORAM entirely
        idx.masked_fill_(~key_live.any(-1).reshape(idx.shape), SENTINEL)
        live = key_live.reshape(idx.shape + (k,)) & (idx != SENTINEL)[..., None]
        return live.sum(dtype=I32)

    def mb_body(cnt, ix, vl):
        return cnt + sweep_mb_(ix, vl)

    mcfg = ecfg.mb
    with record_function("sweep_mailbox"):
        recips, mb = _chunked_tree_sweep(
            mcfg, state.mb, torch.zeros((), dtype=I32, device=dev), mb_body)
        if mcfg.top_cache_levels:
            mcidx = _stale_cache_idx(mcfg, mb)
            mcval = mb.cache_val.clone()
            recips = recips + sweep_mb_(mcidx, mcval)
            mb = mb._replace(cache_idx=mcidx.reshape(-1), cache_val=mcval)
    mb_stash_idx, mb_stash_val = state.mb.stash_idx.clone(), state.mb.stash_val.clone()
    recipients = recips + sweep_mb_(mb_stash_idx, mb_stash_val)
    mb = mb._replace(stash_idx=mb_stash_idx, stash_val=mb_stash_val)
    if mcfg.delayed_eviction:
        # the mailbox eviction buffer sweeps exactly like the stash
        eb_idx, eb_val = state.mb.ebuf_idx.clone(), state.mb.ebuf_val.clone()
        recipients = recipients + sweep_mb_(eb_idx, eb_val)
        mb = mb._replace(ebuf_idx=eb_idx, ebuf_val=eb_val)

    # --- rebuild the free-block list from surviving record liveness ----
    # stable partition (free indices first, each side in index order):
    # two exclusive ranks and one unique scatter, O(n), no sort
    live = present[:n_msgs]
    freelist = torch.empty((n_msgs,), dtype=I32, device=dev)
    freelist[partition_rank(live).long()] = torch.arange(n_msgs, dtype=I32, device=dev)
    free_top = (n_msgs - live.sum(dtype=I32)).to(I32)

    return state._replace(rec=rec, mb=mb, freelist=freelist, free_top=free_top,
                          recipients=recipients.to(I32))
