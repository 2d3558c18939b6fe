"""Path-ORAM data model (port of the single-device parts of
``grapevine_tpu/oram/path_oram.py``).

The bucket tree lives in device memory as a flat slot-index plane
``tree_idx[n*Z]`` and a value plane ``tree_val[n, Z*V]``, both
ChaCha-encrypted at rest under per-bucket 64-bit write epochs
(``nonces``). The position map, stash and tree-top cache are private
working state. Threat model and algorithm as in the reference module.

The position map is either the flat private table or, with
``OramConfig.posmap`` set, a recursive position ORAM
(``oram/posmap.py``); the recursive layout adds a per-slot leaf plane
(``tree_leaf``, with its cache, stash and buffer mirrors) so eviction
never consults the map, encrypted by :func:`leaf_plane_cipher`.

Port conventions: u32 planes are int32 tensors with the same bits
(``u32.py``); the state is a NamedTuple with exactly the reference's
leaf names (unused planes zero-length), so states compare leaf by leaf;
random draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..oblivious.bucket_cipher import row_keystream
from ..oblivious.cipher_kernels import cipher_rows_pallas
from ..u32 import SENTINEL, narrow, ult

I32 = torch.int32

#: u32-lane certified geometry (the reference's OramConfig bounds)
MAX_U32_HEIGHT = 29
MAX_U32_BLOCKS = 1 << 30


@dataclasses.dataclass(frozen=True)
class OramConfig:
    """Static geometry of one bucket tree (the reference's fields)."""

    height: int  # leaves = 2**height
    value_words: int  # u32 words per block value
    bucket_slots: int = 4  # Z
    stash_size: int = 96
    #: ChaCha rounds for at-rest bucket encryption; 0 disables the cipher
    cipher_rounds: int = 0
    #: "jnp" (plain PyTorch cipher), "pallas" (the row-cipher kernel of
    #: oblivious/cipher_kernels.py), "pallas_fused" / "pallas_fused_tiled"
    #: (the one-row / tiled fused gather and scatter kernels of
    #: oblivious/gather_kernels.py)
    cipher_impl: str = "jnp"
    #: logical block index space [0, n_blocks); None = leaves
    n_blocks: int | None = None
    #: position-map geometry: None = the flat private table; a
    #: ``posmap.PosMapSpec`` = the recursive position ORAM (``state.posmap``
    #: is then a ``RecursivePosMapState`` and the leaf planes are real)
    posmap: "object | None" = None
    #: tree-top cache depth k: heap buckets [0, 2^k − 1) live decrypted in
    #: the private cache planes; only the bottom levels touch the trees
    top_cache_levels: int = 0
    #: delayed batched eviction: ``oram_round`` calls between flushes.
    #: 1 = evict and write back every round (the ``ebuf_*``/``fetch_tag``
    #: planes are zero-length); > 1 = fetch-only rounds into a private
    #: eviction buffer, drained by ``oram_flush`` every window. The engine
    #: maps ``evict_every=E`` to E on the records tree and 2E on the
    #: mailbox tree (two mailbox rounds per engine round).
    evict_window: int = 1
    #: paths fetched per ``oram_round`` (B records, B·D mailbox); sizes
    #: the public ``ebuf_paths`` ledger. Required > 0 iff window > 1.
    evict_fetch_count: int = 0
    #: eviction-buffer rows. Required > 0 iff window > 1.
    evict_buffer_slots: int = 0

    def __post_init__(self):
        k = self.top_cache_levels
        if not (0 <= k <= self.height):
            raise ValueError(
                f"top_cache_levels must be in [0, height={self.height}] "
                f"(at least the leaf level stays in the HBM tree), got {k}"
            )
        w = self.evict_window
        if w < 1:
            raise ValueError(f"evict_window must be >= 1, got {w}")
        if w > 1 and (self.evict_fetch_count < 1 or self.evict_buffer_slots < 1):
            raise ValueError(
                "evict_window > 1 (delayed batched eviction) needs "
                "evict_fetch_count and evict_buffer_slots > 0, got "
                f"fetch_count={self.evict_fetch_count}, "
                f"buffer_slots={self.evict_buffer_slots}"
            )
        if self.height > MAX_U32_HEIGHT:
            raise ValueError(
                f"height {self.height} exceeds the u32-lane certified bound "
                f"(height <= {MAX_U32_HEIGHT})"
            )
        if self.blocks > MAX_U32_BLOCKS:
            raise ValueError(
                f"blocks {self.blocks} exceeds the u32-lane certified bound "
                f"(blocks <= {MAX_U32_BLOCKS})"
            )

    @property
    def encrypted(self) -> bool:
        return self.cipher_rounds > 0

    @property
    def delayed_eviction(self) -> bool:
        """True iff rounds fetch only and ``oram_flush`` evicts in batches."""
        return self.evict_window > 1

    @property
    def cache_buckets(self) -> int:
        return (1 << self.top_cache_levels) - 1

    @property
    def row_words(self) -> int:
        return self.bucket_slots + self.bucket_slots * self.value_words

    @property
    def leaves(self) -> int:
        return 1 << self.height

    @property
    def blocks(self) -> int:
        return self.n_blocks if self.n_blocks is not None else self.leaves

    @property
    def n_buckets(self) -> int:
        return (1 << (self.height + 1)) - 1

    @property
    def n_buckets_padded(self) -> int:
        """One bucket past the heap: the junk bucket the reference's fused
        scatter (and its plain version here) redirects non-owner rows to;
        heap indices never address it."""
        return 1 << (self.height + 1)

    @property
    def path_len(self) -> int:
        return self.height + 1

    @property
    def dummy_index(self) -> int:
        return self.blocks


class OramState(NamedTuple):
    """One tree's state; leaf names and shapes are the reference's."""

    tree_idx: torch.Tensor  # int32[n_padded * Z]; SENTINEL = empty slot
    tree_val: torch.Tensor  # int32[n_padded, Z*V]
    cache_idx: torch.Tensor  # int32[cache_buckets * Z]
    cache_val: torch.Tensor  # int32[cache_buckets, Z*V]
    #: per-slot leaf planes, recursive posmap only (int32[0] flat): the
    #: tree's is encrypted by leaf_plane_cipher, its mirrors are private
    cache_leaf: torch.Tensor  # int32[cache_buckets * Z]
    tree_leaf: torch.Tensor  # int32[n_padded * Z]
    stash_idx: torch.Tensor  # int32[S]
    stash_val: torch.Tensor  # int32[S, V]
    stash_leaf: torch.Tensor  # int32[S]
    #: delayed-eviction planes (zero-length at evict_window 1): the
    #: private buffer the fetch rounds recompact into, the public window
    #: ledger of fetched leaves, the rounds buffered so far, the flush
    #: generation, and the generation each bucket was last fetched in
    #: (== ebuf_gen: its tree copy is stale until the flush)
    ebuf_idx: torch.Tensor  # int32[C]; SENTINEL = empty row
    ebuf_val: torch.Tensor  # int32[C, V]
    ebuf_leaf: torch.Tensor  # int32[C] (recursive; int32[0] flat)
    ebuf_paths: torch.Tensor  # int32[window * fetch_count]
    ebuf_rounds: torch.Tensor  # int32 scalar
    ebuf_gen: torch.Tensor  # int32 scalar (starts at 1)
    fetch_tag: torch.Tensor  # int32[n_padded] (int32[0] at window 1)
    #: int32[blocks + 1] flat private table, or a RecursivePosMapState
    posmap: torch.Tensor
    overflow: torch.Tensor  # int32 scalar, sticky count of dropped blocks
    nonces: torch.Tensor  # int32[n_padded, 2] (lo, hi) write epochs
    cipher_key: torch.Tensor  # int32[8]
    epoch: torch.Tensor  # int32[2] (lo, hi), next write epoch


def oram_leaf_shapes(cfg: OramConfig) -> dict:
    """Each ``OramState`` leaf's shape for this geometry (what
    :func:`init_oram` builds), by dotted name in the reference's pytree
    order: a recursive map's leaves are ``posmap.inner.<field>`` (the
    internal tree, recursively) and ``posmap.dummy_entry``."""
    z, v, n = cfg.bucket_slots, cfg.value_words, cfg.n_buckets_padded
    cb, s = cfg.cache_buckets, cfg.stash_size
    delayed = cfg.delayed_eviction
    c = cfg.evict_buffer_slots if delayed else 0
    rec = cfg.posmap is not None
    out = dict(
        tree_idx=(n * z,), tree_val=(n, z * v), cache_idx=(cb * z,),
        cache_val=(cb, z * v), cache_leaf=(cb * z if rec else 0,),
        tree_leaf=(n * z if rec else 0,), stash_idx=(s,),
        stash_val=(s, v), stash_leaf=(s if rec else 0,), ebuf_idx=(c,),
        ebuf_val=(c, v), ebuf_leaf=(c if rec else 0,),
        ebuf_paths=(cfg.evict_window * cfg.evict_fetch_count if delayed else 0,),
        ebuf_rounds=(), ebuf_gen=(), fetch_tag=(n if delayed else 0,),
    )
    if rec:
        from .posmap import inner_oram_config

        for f, shape in oram_leaf_shapes(inner_oram_config(cfg.posmap)).items():
            out[f"posmap.inner.{f}"] = shape
        out["posmap.dummy_entry"] = ()
    else:
        out["posmap"] = (cfg.blocks + 1,)
    out.update(overflow=(), nonces=(n, 2), cipher_key=(8,), epoch=(2,))
    return out


def oram_leaves(o: OramState) -> dict:
    """``o``'s tensors by the dotted names of :func:`oram_leaf_shapes`,
    in the same order."""
    out = {}
    for f in OramState._fields:
        x = getattr(o, f)
        if f == "posmap" and not isinstance(x, torch.Tensor):
            for g, t in oram_leaves(x.inner).items():
                out[f"posmap.inner.{g}"] = t
            out["posmap.dummy_entry"] = x.dummy_entry
        else:
            out[f] = x
    return out


def oram_from_leaves(cfg: OramConfig, get) -> OramState:
    """Rebuild an ``OramState`` of geometry ``cfg`` from ``get(dotted
    name) -> tensor`` (the inverse of :func:`oram_leaves`)."""
    fields = {}
    for f in OramState._fields:  # in leaf order: ``get`` may be a stream
        if f == "posmap" and cfg.posmap is not None:
            from .posmap import RecursivePosMapState, inner_oram_config

            inner = oram_from_leaves(inner_oram_config(cfg.posmap),
                                     lambda g: get(f"posmap.inner.{g}"))
            fields[f] = RecursivePosMapState(inner, get("posmap.dummy_entry"))
        else:
            fields[f] = get(f)
    return OramState(**fields)


def random_u32(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform u32 words (int32 bits) from ``gen``."""
    return narrow(torch.randint(0, 1 << 32, shape, generator=gen,
                                dtype=torch.int64, device=device))


def random_below(gen: torch.Generator, high: int, shape, device) -> torch.Tensor:
    """Uniform int32 values in [0, high) from ``gen``."""
    return torch.randint(0, high, shape, generator=gen, dtype=torch.int64,
                         device=device).to(I32)


def init_oram(cfg: OramConfig, gen: torch.Generator, device,
              side: torch.Generator | None = None) -> OramState:
    """Empty tree; position map drawn uniformly over the leaves from
    ``gen``; the all-zero tree is its own ciphertext (epoch 0).

    A recursive map (``cfg.posmap`` set) draws the same table from
    ``gen`` and packs it into an internal tree built from ``side``
    (``posmap.init_posmap``), so ``gen`` advances exactly as under the
    flat map; the leaf planes are allocated."""
    z, v = cfg.bucket_slots, cfg.value_words
    cb = cfg.cache_buckets
    delayed = cfg.delayed_eviction
    c = cfg.evict_buffer_slots if delayed else 0
    rec = cfg.posmap is not None

    def full(shape, val):
        return torch.full(shape, val, dtype=I32, device=device)

    table = random_below(gen, cfg.leaves, (cfg.blocks + 1,), device)
    cipher_key = random_u32(gen, (8,), device)
    if rec:
        from .posmap import init_posmap

        if side is None:
            raise ValueError("a recursive position map needs the side generator")
        posmap = init_posmap(cfg, table, side, device)
    else:
        posmap = table
    return OramState(
        tree_idx=full((cfg.n_buckets_padded * z,), SENTINEL),
        tree_val=full((cfg.n_buckets_padded, z * v), 0),
        cache_idx=full((cb * z,), SENTINEL),
        cache_val=full((cb, z * v), 0),
        cache_leaf=full((cb * z if rec else 0,), 0),
        tree_leaf=full((cfg.n_buckets_padded * z if rec else 0,), 0),
        stash_idx=full((cfg.stash_size,), SENTINEL),
        stash_val=full((cfg.stash_size, v), 0),
        stash_leaf=full((cfg.stash_size if rec else 0,), 0),
        ebuf_idx=full((c,), SENTINEL),
        ebuf_val=full((c, v), 0),
        ebuf_leaf=full((c if rec else 0,), 0),
        ebuf_paths=full((cfg.evict_window * cfg.evict_fetch_count if delayed else 0,), 0),
        ebuf_rounds=full((), 0),
        # generation 1 over an all-zero tag plane: nothing is stale
        ebuf_gen=full((), 1),
        fetch_tag=full((cfg.n_buckets_padded if delayed else 0,), 0),
        posmap=posmap,
        overflow=full((), 0),
        nonces=full((cfg.n_buckets_padded, 2), 0),
        cipher_key=cipher_key,
        epoch=torch.tensor([1, 0], dtype=I32, device=device),
    )


def cipher_rows(cfg: OramConfig, key, buckets, epochs, pidx, pval, out=None):
    """XOR bucket rows with their keystream (encrypt ≡ decrypt).

    Every ``pallas*`` impl goes through the row-cipher kernel
    (``cipher_rows_pallas``: the kernel on CUDA tensors, its plain
    version on CPU tensors), as the reference routes them all to its
    Pallas kernel; ``"jnp"`` is the plain PyTorch keystream path. Both
    give the same words. ``out=(idx, val)``, tensors that overlap
    neither input, receives the rows instead of fresh tensors (a plain
    copy without the cipher)."""
    if not cfg.encrypted:
        if out is None:
            return pidx, pval
        out[0].copy_(pidx)
        out[1].copy_(pval)
        return out
    if cfg.cipher_impl in ("pallas", "pallas_fused", "pallas_fused_tiled"):
        return cipher_rows_pallas(key, buckets.contiguous(), epochs.contiguous(),
                                  pidx.contiguous(), pval.contiguous(),
                                  cfg.cipher_rounds, out)
    z = cfg.bucket_slots
    ks = row_keystream(key, buckets, epochs, cfg.row_words, cfg.cipher_rounds)
    if out is None:
        return pidx ^ ks[:, :z], pval ^ ks[:, z:]
    torch.bitwise_xor(pidx, ks[:, :z], out=out[0])
    torch.bitwise_xor(pval, ks[:, z:], out=out[1])
    return out


def leaf_plane_cipher(cfg: OramConfig, key, buckets, epochs, pleaf):
    """XOR leaf-plane rows int32[R, Z] with their keystream (encrypt ≡
    decrypt; recursive posmap only). A slot's leaf is the block's future
    fetch path, so the plane rides the bucket cipher; its nonce's bucket
    word is offset by ``n_buckets_padded`` (heap ids never reach that
    range), which separates this stream from the row keystream under the
    same (bucket, epoch). The plain PyTorch keystream under every
    ``cipher_impl``, as the reference keeps it on jnp: the fused kernels
    cover only the idx/val planes."""
    if not cfg.encrypted:
        return pleaf
    ks = row_keystream(key, buckets + cfg.n_buckets_padded, epochs,
                       cfg.bucket_slots, cfg.cipher_rounds)
    return pleaf ^ ks


def path_bucket_indices(cfg: OramConfig, leaf) -> torch.Tensor:
    """Heap indices of the root→leaf path buckets: int32[..., path_len]."""
    depths = torch.arange(cfg.path_len, dtype=I32, device=leaf.device)
    return ((1 << depths) - 1) + (leaf[..., None] >> (cfg.height - depths))


def path_slot_indices(cfg: OramConfig, path_b) -> torch.Tensor:
    """Flat tree_idx slot indices for path buckets: [...] → [..., Z]."""
    z = cfg.bucket_slots
    return path_b[..., None] * z + torch.arange(z, dtype=I32, device=path_b.device)


def _path_gather(tree, path_b):
    """Fetch the path bucket rows (single device)."""
    return tree[path_b.long()]


def _path_scatter_(tree, path_b, new_vals, owner):
    """Write the owned path rows back in place; rows with ``owner``
    False are not written at all (the reference drops them out of
    bounds). Non-owner rows are sent to the junk bucket (the last row,
    which no heap id addresses) and the junk row is restored after, so
    the shape is fixed and no value is read back to the host."""
    junk = tree.shape[0] - 1
    saved = tree[junk].clone()
    tree[torch.where(owner, path_b, junk).long()] = new_vals
    tree[junk] = saved
    return tree


def derive_evict_buffer_slots(blocks: int, window: int, fetch_count: int,
                              z: int) -> int:
    """Auto eviction-buffer rows (the reference's sizing): ~2·Z live
    blocks per fetched path per window round plus insert slack, clamped
    by the whole block space (a buffer that holds every block cannot
    overflow)."""
    return min(blocks, 2 * z * window * fetch_count + 4 * fetch_count)


def working_leaves(posmap, cfg: OramConfig, idxs) -> torch.Tensor:
    """Leaf per working-set entry; SENTINEL/dummy rows read the throwaway
    entry ``posmap[blocks]`` (their value is never used)."""
    safe = torch.where(ult(idxs, cfg.blocks), idxs, cfg.blocks)
    return posmap[safe.long()]
