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
from torch.profiler import record_function

from ..oblivious.bucket_cipher import epoch_next, row_keystream
from ..oblivious.cipher_kernels import cipher_rows_pallas
from ..oblivious.primitives import first_true_onehot, onehot_select, rank_of, scatter_fresh
from ..u32 import SENTINEL, narrow, ult, widen

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


def RANGELINT_BOUNDS(cfg: "OramConfig", prefix: str = "state", drops: int = 0) -> dict:
    """Rangelint input-interval anchors (``analysis/rangelint.py``) for one
    ``OramState`` under ``prefix``, value for value the reference's
    (``grapevine_tpu/oram/path_oram.py:73``). Every int32 plane is a u32
    lane; the declared ones:

    - position values (stash/cache/buffer leaf mirrors, the flat table,
      the recursive map's internal table and packed entries) are leaves,
      ``< cfg.leaves``;
    - ``overflow`` carries the sticky-counter increment budget: 2^16
      below the lane, the reference's, or the power of two covering
      ``drops`` (the most blocks one call can drop, its working set
      beyond the stash) where that is more — at B=2048 one round can
      drop ~1.7e5 blocks, past the reference's 2^16; the generation
      counters step once a flush within 2^16; ``ebuf_rounds`` resets at
      every flush and counts within ``[0, evict_window]``;
    - ciphertext and sentinel-bearing planes (tree planes under the
      cipher, stash/cache/buffer idx) stay the full lane.

    Each bound is an invariant an existing test pins; the rest of the
    round is certified against them."""
    lv = cfg.leaves - 1
    budget = 1 << max(16, (max(drops, 1) - 1).bit_length())
    b = {
        f"{prefix}.stash_leaf": (0, lv),
        f"{prefix}.cache_leaf": (0, lv),
        f"{prefix}.overflow": (0, 2**32 - budget),
    }
    if cfg.delayed_eviction:
        b[f"{prefix}.ebuf_leaf"] = (0, lv)
        b[f"{prefix}.ebuf_paths"] = (0, lv)
        b[f"{prefix}.ebuf_rounds"] = (0, cfg.evict_window)
        b[f"{prefix}.ebuf_gen"] = (0, 2**32 - 2**16)
        b[f"{prefix}.fetch_tag"] = (0, 2**32 - 2**16)
    if not cfg.encrypted:
        b[f"{prefix}.tree_leaf"] = (0, lv)
    if cfg.posmap is None:
        b[f"{prefix}.posmap"] = (0, lv)
    else:
        from .posmap import inner_oram_config

        icfg = inner_oram_config(cfg.posmap)
        inner = f"{prefix}.posmap.inner"
        # the internal ORAM's block values are packed OUTER leaf entries;
        # its own flat map holds INTERNAL leaves
        b[f"{inner}.posmap"] = (0, icfg.leaves - 1)
        b[f"{inner}.stash_val"] = (0, lv)
        b[f"{inner}.cache_val"] = (0, lv)
        b[f"{inner}.overflow"] = (0, 2**32 - budget)
        if icfg.delayed_eviction:
            b[f"{inner}.ebuf_val"] = (0, lv)
            b[f"{inner}.ebuf_leaf"] = (0, icfg.leaves - 1)
            b[f"{inner}.ebuf_paths"] = (0, icfg.leaves - 1)
            b[f"{inner}.ebuf_rounds"] = (0, icfg.evict_window)
            b[f"{inner}.ebuf_gen"] = (0, 2**32 - 2**16)
            b[f"{inner}.fetch_tag"] = (0, 2**32 - 2**16)
        if not icfg.encrypted:
            b[f"{inner}.tree_val"] = (0, lv)
        b[f"{prefix}.posmap.dummy_entry"] = (0, lv)
    return b


def round_drops(cfg: OramConfig, ops: int) -> int:
    """The most blocks one ``oram_round``/``oram_flush`` of ``ops``
    accesses can drop: its working set (stash, buffer, the fetched paths'
    slots, the new blocks) beyond the stash."""
    return cfg.evict_buffer_slots + ops * (cfg.path_len * cfg.bucket_slots + 1)


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
              side: torch.Generator | None = None, tree_full=None) -> OramState:
    """Empty tree; position map drawn uniformly over the leaves from
    ``gen``; the all-zero tree is its own ciphertext (epoch 0).

    A recursive map (``cfg.posmap`` set) draws the same table from
    ``gen`` and packs it into an internal tree built from ``side``
    (``posmap.init_posmap``), so ``gen`` advances exactly as under the
    flat map; the leaf planes are allocated. ``tree_full(n_buckets,
    shape, value)``, when given, allocates the tree, leaf and nonce
    planes instead (``parallel.init_sharded_engine`` places each shard
    on its own device); every other plane stays on ``device``."""
    z, v = cfg.bucket_slots, cfg.value_words
    cb = cfg.cache_buckets
    delayed = cfg.delayed_eviction
    c = cfg.evict_buffer_slots if delayed else 0
    rec = cfg.posmap is not None

    def full(shape, val):
        return torch.full(shape, val, dtype=I32, device=device)

    def tree(shape, val):
        if tree_full is None:
            return full(shape, val)
        return tree_full(cfg.n_buckets_padded, shape, val)

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
        tree_idx=tree((cfg.n_buckets_padded * z,), SENTINEL),
        tree_val=tree((cfg.n_buckets_padded, z * v), 0),
        cache_idx=full((cb * z,), SENTINEL),
        cache_val=full((cb, z * v), 0),
        cache_leaf=full((cb * z if rec else 0,), 0),
        tree_leaf=tree((cfg.n_buckets_padded * z if rec else 0,), 0),
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
        nonces=tree((cfg.n_buckets_padded, 2), 0),
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


def _common_prefix_depth(cfg: OramConfig, leaves_a, leaf_b):
    """Deepest path level where a block with leaf ``leaves_a[i]`` may live
    on the path to ``leaf_b``: the length of the common prefix of the two
    height-bit leaf numbers, int32 in [0, height]. ``a >> s == b >> s``
    (logical shifts) iff ``(a ^ b) >> s == 0``; the XOR widens to int64,
    where every shift is logical, so working-set entries of invalid slots
    (arbitrary leaf words) count exactly as the reference's u32 lanes do."""
    x = widen(leaves_a ^ leaf_b)
    shifts = torch.arange(cfg.height - 1, -1, -1, device=x.device)  # h - j, j = 1..h
    return ((x[..., None] >> shifts) == 0).sum(dim=-1).to(I32)


class ShardedPlane:
    """A tree plane split along its bucket axis over a device mesh (the
    reference's ``P(TREE_AXIS)`` leaf; ``parallel/mesh.py``).

    Shard ``i`` holds the contiguous heap range ``[i·n_local,
    (i+1)·n_local)`` of buckets on its own device, followed by one
    scratch bucket row that absorbs the writes the shard does not own
    (:func:`_path_scatter_`): a fixed-shape drop with no host read. Heap
    ids never address the scratch row, and it is never checkpointed or
    compared. ``view`` reshapes every shard alike, so
    ``plane.view(-1, z)`` gives the bucket rows of a flat slot plane as
    it does for a tensor."""

    __slots__ = ("shards", "n_local")

    def __init__(self, shards, n_local: int):
        self.shards = tuple(shards)
        self.n_local = n_local

    def view(self, *shape) -> "ShardedPlane":
        return ShardedPlane([s.view(*shape) for s in self.shards], self.n_local)

    def local(self) -> list:
        """Each shard's heap rows (its scratch row left out), in mesh order."""
        return [s[: s.shape[0] - s.shape[0] // (self.n_local + 1)] for s in self.shards]

    def join(self, device) -> torch.Tensor:
        """The logical plane as one tensor on ``device``."""
        return torch.cat([r.to(device) for r in self.local()])


def _path_gather(tree, path_b, mesh=None):
    """Fetch the path bucket rows.

    Under a ``mesh`` (``parallel/mesh.py``) ``tree`` is a
    :class:`ShardedPlane`: each shard gathers the rows it owns (rebased
    to its ``base = shard · n_local``), masks the rest to zero, and the
    shards' rows are summed in place into one int32 buffer on the
    controller device (``path_b``'s) — the reference's ``psum`` as a
    reduce. Every bucket has one owner, so the sum is the owner's words;
    they are still ciphertext (decrypt runs after). The addresses
    touched are the public path, as on one device."""
    if mesh is None:
        return tree[path_b.long()]
    out = None
    for i, shard in enumerate(tree.shards):
        loc = path_b.to(shard.device, non_blocking=True) - i * tree.n_local
        mine = (loc >= 0) & (loc < tree.n_local)
        rows = shard[torch.where(mine, loc, 0).long()]
        rows.masked_fill_(~mine.view(-1, *(1,) * (rows.dim() - 1)), 0)
        rows = rows.to(path_b.device, non_blocking=True)
        out = rows if out is None else out.add_(rows)
    return out


def _path_scatter_(tree, path_b, new_vals, owner, mesh=None):
    """Write the owned path rows back in place; rows with ``owner``
    False are not written at all (the reference drops them out of
    bounds). Non-owner rows are sent to the junk bucket (the last row,
    which no heap id addresses) and the junk row is restored after, so
    the shape is fixed and no value is read back to the host.

    Under a ``mesh`` ``tree`` is a :class:`ShardedPlane`: each shard
    writes the rows it owns where ``owner`` holds too, and sends every
    other row to its own scratch row (the junk bucket is a real row of
    the last shard only). Owned targets are unique (one owner column a
    bucket), so only the scratch row sees duplicate writes."""
    if mesh is None:
        junk = tree.shape[0] - 1
        saved = tree[junk].clone()
        tree[torch.where(owner, path_b, junk).long()] = new_vals
        tree[junk] = saved
        return tree
    for i, shard in enumerate(tree.shards):
        dev = shard.device
        loc = path_b.to(dev, non_blocking=True) - i * tree.n_local
        mine = (loc >= 0) & (loc < tree.n_local) & owner.to(dev, non_blocking=True)
        shard[torch.where(mine, loc, tree.n_local).long()] = new_vals.to(
            dev, non_blocking=True)
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


def oram_access(cfg: OramConfig, state: OramState, idx, new_leaf, operand, fn,
                pm_leaf=None):
    """One oblivious read-modify-write access (the reference's
    ``oram_access``, single device): the op-major engine's primitive.

    ``idx`` int32 scalar block index (or ``cfg.dummy_index``), ``new_leaf``
    int32 scalar fresh uniform in [0, leaves). ``fn(value int32[V],
    present bool, operand) -> (new_value int32[V], keep bool, insert bool,
    out)``, every one a tensor: if the block is present its value becomes
    ``new_value`` (``keep`` False removes it); if absent and ``insert``,
    ``(idx, new_value)`` is added. ``fn`` must be branchless and gets the
    masked value (zeros when absent). Returns ``(state', out, leaf)``;
    ``leaf`` is the public transcript entry: an int32 scalar under a flat
    map, int32[2] (payload leaf, internal leaf) under a recursive one,
    where ``pm_leaf`` supplies the fresh internal leaf.

    The path's tree rows, nonces (and leaf plane) are written back in
    place, as ``oram_round`` writes them; every other plane is new. The
    rows go through :func:`cipher_rows` both ways, so every ``pallas*``
    impl runs the row-cipher kernel twice an access. No value is read
    back to the host."""
    from .posmap import lookup_remap_one

    z, v, plen = cfg.bucket_slots, cfg.value_words, cfg.path_len
    recursive = cfg.posmap is not None
    posmap, leaf, inner_leaf = lookup_remap_one(cfg, state.posmap, idx, new_leaf,
                                                pm_leaf)
    path_b = path_bucket_indices(cfg, leaf)  # int32[plen]

    # tree-top cache split: levels [0, kc) live decrypted in the cache
    # planes; only the bottom plen−kc levels touch the encrypted tree
    kc = cfg.top_cache_levels
    bot_b = path_b[kc:]
    bot = bot_b.long()
    top_b = torch.clamp(path_b[:kc], max=max(cfg.cache_buckets, 1) - 1)
    top_slots = path_slot_indices(cfg, top_b).reshape(-1)

    # --- fetch path ∪ stash into the working set -----------------------
    with record_function("oram_fetch"):
        pnonce = state.nonces[bot]
        pidx, pval = cipher_rows(cfg, state.cipher_key, bot_b, pnonce,
                                 state.tree_idx.view(-1, z)[bot], state.tree_val[bot])
        if kc:
            pidx = torch.cat([state.cache_idx[top_slots.long()].reshape(kc, z), pidx])
            pval = torch.cat([state.cache_val[top_b.long()], pval])
        if recursive:
            pleaf = leaf_plane_cipher(cfg, state.cipher_key, bot_b, pnonce,
                                      state.tree_leaf.view(-1, z)[bot])
            if kc:
                pleaf = torch.cat([state.cache_leaf[top_slots.long()].reshape(kc, z),
                                   pleaf])
    widx = torch.cat([state.stash_idx, pidx.reshape(-1)])
    wval = torch.cat([state.stash_val, pval.reshape(-1, v)])
    if recursive:
        # leaves ride the per-slot leaf plane (the map cannot be gathered)
        wleaf = torch.cat([state.stash_leaf, pleaf.reshape(-1)])
    else:
        # from the remapped private map: new_leaf for the accessed block
        wleaf = working_leaves(posmap, cfg, widx)

    valid = widx != SENTINEL
    match = valid & (widx == idx)
    if recursive:
        # the map's entry for idx is already new_leaf: the plane follows
        wleaf = torch.where(match, new_leaf, wleaf)
    present = torch.any(match)
    value = onehot_select(match, wval)

    new_value, keep, insert, out = fn(value, present, operand)

    # --- apply the modification obliviously ----------------------------
    wval = torch.where(match[:, None], new_value[None, :], wval)
    widx = torch.where(match & ~keep, SENTINEL, widx)
    do_insert = insert & ~present & (idx != cfg.dummy_index)
    ins_slot = first_true_onehot(widx == SENTINEL) & do_insert
    widx = torch.where(ins_slot, idx, widx)
    wleaf = torch.where(ins_slot, new_leaf, wleaf)
    wval = torch.where(ins_slot[:, None], new_value[None, :], wval)
    # a full working set on insert is an overflow (the path fetch alone
    # frees plen*z slots, so it cannot happen at a sane geometry)
    insert_dropped = do_insert & ~torch.any(ins_slot)

    # --- greedy deepest-first eviction ---------------------------------
    with record_function("oram_evict"):
        valid = widx != SENTINEL
        depth = _common_prefix_depth(cfg, wleaf, leaf)
        # deep[level]: the entry may live at that level of this path
        deep = depth[None, :] >= torch.arange(plen, dtype=I32, device=depth.device)[:, None]
        tgt = torch.full(valid.shape, plen * z, dtype=torch.int64, device=valid.device)
        unplaced = valid
        for level in range(cfg.height, -1, -1):
            eligible = unplaced & deep[level]
            # inclusive count: an eligible entry's slot is count - 1, and
            # the first z of them (in working-set order) are placed
            count = torch.cumsum(eligible, 0)
            chosen = eligible & (count <= z)
            tgt = torch.where(chosen, count + (level * z - 1), tgt)
            unplaced = unplaced ^ chosen
        # conflict-free: each (level, pos) pair is chosen at most once;
        # unplaced entries target plen*z and are dropped
        new_pidx = scatter_fresh(plen * z, SENTINEL, tgt, widx)
        new_pval = scatter_fresh(plen * z, 0, tgt, wval)
        new_pleaf = scatter_fresh(plen * z, 0, tgt, wleaf) if recursive else None

    # --- compact the leftovers back into the stash ---------------------
    s = cfg.stash_size
    leftover = unplaced
    starget = torch.where(leftover, rank_of(leftover), s).long()
    stash_idx = scatter_fresh(s, SENTINEL, starget, widx)
    stash_val = scatter_fresh(s, 0, starget, wval)
    stash_leaf = scatter_fresh(s, 0, starget, wleaf) if recursive else state.stash_leaf
    stash_dropped = torch.clamp(leftover.to(I32).sum() - s, min=0)
    overflow = (state.overflow + stash_dropped + insert_dropped.to(I32)).to(I32)

    # --- write the path back (write transcript ≡ read transcript) ------
    with record_function("oram_writeback"):
        epochs_w = state.epoch[None, :].expand(plen - kc, 2)
        enc_pidx, enc_pval = cipher_rows(
            cfg, state.cipher_key, bot_b, epochs_w,
            new_pidx.view(plen, z)[kc:], new_pval.view(plen, z * v)[kc:])
        # a path's buckets are distinct: unique targets
        state.tree_idx.view(-1, z)[bot] = enc_pidx
        state.tree_val[bot] = enc_pval
        if cfg.encrypted:
            state.nonces[bot] = epochs_w
        cache_idx, cache_val, cache_leaf = state.cache_idx, state.cache_val, state.cache_leaf
        if kc:
            # cached levels write back plaintext into the cache planes
            cache_idx = cache_idx.index_put((top_slots.long(),), new_pidx[:kc * z])
            cache_val = cache_val.index_put((top_b.long(),),
                                            new_pval.view(plen, z * v)[:kc])
        if recursive:
            enc_pleaf = leaf_plane_cipher(cfg, state.cipher_key, bot_b, epochs_w,
                                          new_pleaf.view(plen, z)[kc:])
            state.tree_leaf.view(-1, z)[bot] = enc_pleaf
            if kc:
                cache_leaf = cache_leaf.index_put((top_slots.long(),), new_pleaf[:kc * z])
    new_state = state._replace(
        cache_idx=cache_idx,
        cache_val=cache_val,
        cache_leaf=cache_leaf,
        stash_idx=stash_idx,
        stash_val=stash_val,
        stash_leaf=stash_leaf,
        posmap=posmap,
        overflow=overflow,
        epoch=epoch_next(state.epoch),
    )
    if recursive:
        leaf = torch.stack([leaf, inner_leaf])
    return new_state, out, leaf


def _take(tree, i: int):
    """Element ``i`` of every tensor of an operand pytree (dicts, tuples,
    lists, tensors)."""
    if isinstance(tree, dict):
        return {k: _take(x, i) for k, x in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_take(x, i) for x in tree)
    return tree[i]


def _stack(items: list):
    """Stack a list of like pytrees along a new leading axis."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack(list(col)) for col in zip(*items))
    return torch.stack(items)


def oram_access_batch(cfg: OramConfig, state: OramState, idxs, new_leaves,
                      operands, fn, pm_leaves=None):
    """Sequentially committed batch of :func:`oram_access` calls, in slot
    order (the reference's ``lax.scan`` as a Python loop; every access is
    branchless, so the loop reads nothing back). ``operands`` is a pytree
    with a leading batch axis. Returns ``(state', outs, leaves)`` with
    outs and leaves stacked; under a recursive map ``pm_leaves`` int32[B]
    supplies the fresh internal leaves and ``leaves`` is int32[B, 2]."""
    recursive = cfg.posmap is not None
    if recursive and pm_leaves is None:
        raise ValueError(
            "recursive posmap batch needs pm_leaves (fresh uniform "
            "internal leaves, one per access)"
        )
    outs, leaves = [], []
    for i in range(idxs.shape[0]):
        state, out, leaf = oram_access(cfg, state, idxs[i], new_leaves[i],
                                       _take(operands, i), fn,
                                       pm_leaves[i] if recursive else None)
        outs.append(out)
        leaves.append(leaf)
    return state, _stack(outs), torch.stack(leaves)


def tree_cache_private_bytes(cfg: OramConfig) -> int:
    """Decrypted-resident bytes the tree-top cache pins for this tree:
    2^k−1 bucket rows of idx + val (+ the leaf plane under a recursive
    map), plaintext private state with the stash's standing."""
    z, v = cfg.bucket_slots, cfg.value_words
    leaf = z if cfg.posmap is not None else 0
    return cfg.cache_buckets * 4 * (z + z * v + leaf)


def evict_buffer_private_bytes(cfg: OramConfig) -> int:
    """Resident plaintext bytes the eviction buffer pins for this tree:
    C rows of idx + val (+ leaf under a recursive map), plus the public
    window bookkeeping (paths plane + per-bucket fetch tags)."""
    if not cfg.delayed_eviction:
        return 0
    c, v = cfg.evict_buffer_slots, cfg.value_words
    leaf = 1 if cfg.posmap is not None else 0
    rows = c * 4 * (1 + v + leaf)
    public = 4 * (cfg.evict_window * cfg.evict_fetch_count
                  + cfg.n_buckets_padded + 2)
    return rows + public


def tree_occupancy(state: OramState) -> torch.Tensor:
    """Number of live blocks in the tree's idx plane (a test/metrics
    helper; meaningful on an unencrypted tree)."""
    return torch.sum(state.tree_idx != SENTINEL)
