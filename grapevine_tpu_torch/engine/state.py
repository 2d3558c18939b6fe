"""Engine state: the two ORAMs plus private scalar bookkeeping (port of
``grapevine_tpu/engine/state.py``).

Block layouts (u32 words; u64 fields as (lo, hi) lanes):

records block: id[4] | sender[8] | recipient[8] | ts[2] | payload[234]
mailbox block: K × (key[8] | entries[cap × (blk | idw | seq[2] | ts[2])])
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..config import GrapevineConfig
from ..device import resolve_device
from ..oram.posmap import derive_posmap_spec
from ..oram.path_oram import (
    OramConfig,
    OramState,
    derive_evict_buffer_slots,
    init_oram,
    random_u32,
)
from ..u32 import c32, rotl, shr
from ..wire import constants as C

I32 = torch.int32

REC_ID = slice(0, 4)
REC_SENDER = slice(4, 12)
REC_RECIPIENT = slice(12, 20)
REC_TS = 20
REC_TSH = 21
PAYLOAD_WORDS = C.PAYLOAD_SIZE // 4
REC_PAYLOAD = slice(22, 22 + PAYLOAD_WORDS)
REC_WORDS = 22 + PAYLOAD_WORDS
KEY_WORDS = 8
ID_WORDS = 4
ENTRY_WORDS = 6
ENT_BLK = 0
ENT_IDW = 1
ENT_SEQ = 2
ENT_SEQH = 3
ENT_TS = 4
ENT_TSH = 5


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine geometry derived from a GrapevineConfig."""

    max_messages: int
    max_recipients: int
    mailbox_cap: int
    batch_size: int
    rec: OramConfig
    mb: OramConfig
    mb_table_buckets: int
    mb_slots: int
    mb_choices: int = 1
    #: delayed batched eviction: a flush every E engine rounds (1 = none)
    evict_every: int = 1
    #: slot-order machinery (``engine/vphases.py``): "dense" [B,B] masks
    #: or "scan" sort + segmented scans — bit-identical semantics
    vphases_impl: str = "dense"
    #: bounded-key sort engine (``oblivious/radix.py``): "xla" comparison
    #: sorts or "radix" counting passes, the same permutations
    sort_impl: str = "xla"
    #: position map: "flat" or "recursive"; the per-tree geometry lives
    #: in rec.posmap / mb.posmap (PosMapSpec), which ``repr`` and so the
    #: checkpoint fingerprint cover
    posmap_impl: str = "flat"

    @property
    def id_bits(self) -> int:
        return max(1, self.max_messages.bit_length() - 1)

    @classmethod
    def from_config(cls, cfg: GrapevineConfig) -> "EngineConfig":
        """Resolve ``cfg`` for the port. ``cfg.shards`` stays out of the
        result, as in the reference, so journals and checkpoints replay
        across shard counts (the facade builds the mesh).

        Auto values resolve as the reference's do off the TPU, except
        the vphases: ``None`` resolves to ``"dense"`` on the card and on
        the CPU alike (the reference picks "scan" off the TPU; the
        port's default waits on a benchmark that resolves the two on the
        card). The rest: the comparison sorts, a flat position map, a
        tree-top cache of k=4 under ``commit="phase"`` and k=0 under
        ``commit="op"`` (the differential oracle stays cache-free;
        clamped per tree) and per-round eviction. Under ``evict_every`` E > 1 the records
        tree's window is E rounds of B fetched paths, the mailbox tree's
        2E rounds (rounds A and C) of B·D; buffer sizes are
        ``evict_buffer_slots`` or derived per tree. A recursive map
        derives each tree's ``PosMapSpec`` (internal tree geometry,
        cache depth and eviction window) as the reference does."""
        m = cfg.mailbox_table_buckets
        k = max(1, cfg.mailbox_slots)
        mb_value_words = k * (KEY_WORDS + ENTRY_WORDS * cfg.mailbox_cap)
        tc = cfg.tree_top_cache_levels
        if tc is None:
            tc = 4 if cfg.commit == "phase" else 0
        ee = cfg.evict_every if cfg.evict_every is not None else 1
        rec_w, mb_w = (ee, 2 * ee) if ee > 1 else (1, 1)
        rec_f = cfg.batch_size if ee > 1 else 0
        mb_f = cfg.batch_size * cfg.resolved_mailbox_choices if ee > 1 else 0
        rec_c = mb_c = 0
        if ee > 1:
            if cfg.evict_buffer_slots is not None:
                rec_c = mb_c = cfg.evict_buffer_slots
            else:
                rec_c = derive_evict_buffer_slots(cfg.max_messages, rec_w, rec_f,
                                                  cfg.bucket_slots)
                mb_c = derive_evict_buffer_slots(m, mb_w, mb_f, cfg.bucket_slots)
        vimpl = cfg.vphases_impl if cfg.vphases_impl is not None else "dense"
        simpl = cfg.sort_impl if cfg.sort_impl is not None else "xla"
        pimpl = cfg.posmap_impl if cfg.posmap_impl is not None else "flat"
        rec_pm = mb_pm = None
        if pimpl == "recursive":
            rec_pm = derive_posmap_spec(
                cfg.max_messages, stash_size=cfg.stash_size,
                cipher_rounds=cfg.bucket_cipher_rounds, top_cache_levels=tc,
                evict_window=rec_w, evict_fetch_count=rec_f,
            )
            mb_pm = derive_posmap_spec(
                m, stash_size=cfg.stash_size,
                cipher_rounds=cfg.bucket_cipher_rounds, top_cache_levels=tc,
                evict_window=mb_w, evict_fetch_count=mb_f,
            )
        return cls(
            max_messages=cfg.max_messages,
            max_recipients=cfg.max_recipients,
            mailbox_cap=cfg.mailbox_cap,
            batch_size=cfg.batch_size,
            rec=OramConfig(
                height=cfg.records_height,
                value_words=REC_WORDS,
                bucket_slots=cfg.bucket_slots,
                stash_size=cfg.stash_size,
                cipher_rounds=cfg.bucket_cipher_rounds,
                cipher_impl=cfg.bucket_cipher_impl,
                n_blocks=cfg.max_messages,
                posmap=rec_pm,
                top_cache_levels=min(tc, cfg.records_height),
                evict_window=rec_w,
                evict_fetch_count=rec_f,
                evict_buffer_slots=rec_c,
            ),
            mb=OramConfig(
                height=cfg.mailbox_height,
                value_words=mb_value_words,
                bucket_slots=cfg.bucket_slots,
                stash_size=cfg.stash_size,
                cipher_rounds=cfg.bucket_cipher_rounds,
                cipher_impl=cfg.bucket_cipher_impl,
                n_blocks=m,
                posmap=mb_pm,
                top_cache_levels=min(tc, cfg.mailbox_height),
                evict_window=mb_w,
                evict_fetch_count=mb_f,
                evict_buffer_slots=mb_c,
            ),
            mb_table_buckets=m,
            mb_slots=k,
            mb_choices=cfg.resolved_mailbox_choices,
            evict_every=ee,
            vphases_impl=vimpl,
            sort_impl=simpl,
            posmap_impl=pimpl,
        )


class EngineState(NamedTuple):
    rec: OramState
    mb: OramState
    freelist: torch.Tensor  # int32[max_messages]; [0:free_top] = free blocks
    free_top: torch.Tensor  # int32 scalar
    recipients: torch.Tensor  # int32 scalar: live recipients
    seq: torch.Tensor  # int32[2] (lo, hi): u64 global insertion counter
    hash_key: torch.Tensor  # int32[2]: keyed mailbox-bucket PRF
    id_key: torch.Tensor  # int32[4]: block-index PRP key
    rng: torch.Generator  # the engine's private random stream
    #: recursive position map only (None flat): the side stream the
    #: internal ORAMs draw from, so ``rng`` advances exactly as under the
    #: flat map (the reference folds its key with 0x504D)
    pm_rng: torch.Generator | None = None


def init_engine(ecfg: EngineConfig, seed: int = 0, device=None,
                tree_full=None) -> EngineState:
    """Fresh engine state on ``device`` (``None`` → the CUDA card; raises
    without one); every random draw comes from one generator on that
    device seeded with ``seed`` (the reference's jax.random key has the
    same standing; the two give different numbers). A recursive map's
    internal trees and leaves come from a second generator,
    :func:`side_generator` of the first, so the first draws what it
    draws under the flat map. ``tree_full`` allocates both ORAMs' tree
    planes (``path_oram.init_oram``; ``parallel.init_sharded_engine``
    shards them)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    side = side_generator(gen) if ecfg.posmap_impl == "recursive" else None
    rec = init_oram(ecfg.rec, gen, dev, side, tree_full)
    mb = init_oram(ecfg.mb, gen, dev, side, tree_full)
    return EngineState(
        rec=rec,
        mb=mb,
        freelist=torch.arange(ecfg.max_messages, dtype=I32, device=dev),
        free_top=torch.tensor(ecfg.max_messages, dtype=I32, device=dev),
        recipients=torch.tensor(0, dtype=I32, device=dev),
        seq=torch.tensor([1, 0], dtype=I32, device=dev),
        hash_key=random_u32(gen, (2,), dev),
        id_key=random_u32(gen, (4,), dev),
        rng=gen,
        pm_rng=side,
    )


#: the reference's fold_in constant for its posmap side stream ("PM")
_PM_FOLD = 0x504D


def side_generator(gen: torch.Generator) -> torch.Generator:
    """The recursive map's side stream: a generator on ``gen``'s device
    seeded from ``gen``'s seed folded with 0x504D, drawing nothing from
    ``gen`` itself."""
    side = torch.Generator(device=gen.device)
    side.manual_seed((gen.initial_seed() * 0x9E3779B97F4A7C15 + _PM_FOLD) % (1 << 63))
    return side


def mb_parse(ecfg: EngineConfig, value):
    """Split a mailbox block value into (keys [K,8], entries [K,cap,6])."""
    k, cap = ecfg.mb_slots, ecfg.mailbox_cap
    v = value.reshape(k, KEY_WORDS + ENTRY_WORDS * cap)
    keys = v[:, :KEY_WORDS]
    entries = v[:, KEY_WORDS:].reshape(k, cap, ENTRY_WORDS)
    return keys, entries


def mb_pack(ecfg: EngineConfig, keys, entries):
    """The inverse of :func:`mb_parse`: one flat mailbox block value."""
    k, cap = ecfg.mb_slots, ecfg.mailbox_cap
    flat = torch.cat([keys, entries.reshape(k, cap * ENTRY_WORDS)], dim=1)
    return flat.reshape(k * (KEY_WORDS + ENTRY_WORDS * cap))


def mb_bucket_hash(hash_key, recipient, n_buckets: int, salt: int = 0):
    """Keyed PRF: recipient (…, 8 words) → bucket index in [0, n_buckets)."""
    h = hash_key[0] ^ c32(salt * 0x9E3779B9)
    c1, c2 = c32(0xCC9E2D51), c32(0x1B873593)
    for w in range(KEY_WORDS):
        x = recipient[..., w] * c1
        x = rotl(x, 15)
        x = x * c2
        h = h ^ x
        h = rotl(h, 13)
        h = h * 5 + c32(0xE6546B64)
    h = h ^ hash_key[1]
    h = h ^ shr(h, 16)
    h = h * c32(0x85EBCA6B)
    h = h ^ shr(h, 13)
    h = h * c32(0xC2B2AE35)
    h = h ^ shr(h, 16)
    return h & (n_buckets - 1)
