"""Bucket-tree sharding over a device mesh (port of
``grapevine_tpu/parallel/mesh.py``).

Design, as in the reference:

- The two Path-ORAM bucket trees (records + mailbox, the only state that
  scales with bus capacity) are sharded along the bucket axis: each
  device owns a contiguous heap range of ``n_buckets_padded / N``
  buckets of both trees, with their nonces (and a recursive map's leaf
  plane), in its own memory.
- Per access, every shard gathers the path buckets it owns, masked to
  zero elsewhere, and one reduce assembles the full root→leaf working
  set (``oram/path_oram.py:_path_gather``); the rows are still
  ciphertext, decrypted after the reduce. Write-back is owner-masked per
  shard: each heap index has exactly one owner.
- Stash, position map, tree-top cache, eviction buffer and all scalar
  bookkeeping are replicated private state.

The port keeps ONE controller where the reference runs one SPMD program
over the mesh: the sharded planes live as per-device shards
(``path_oram.ShardedPlane``), and the replicated state and all compute
live on the mesh's first device, so "replicated" means held once there
(the reference's replicas are identical by construction). The
reference's ``psum`` becomes a sum onto that device: each shard's masked
gather is copied there (a peer copy across cards, nothing on one card)
and added in place. One facade, one journal and one checkpoint see one
logical state, as in the reference.

A mesh may repeat a device (a virtual mesh): on one card, or on the CPU,
it runs every piece of the sharded path — owner masks, the reduce,
decrypt after it, the per-shard write-back, the flush and the sweep —
the way the reference's tests run its mesh on 8 virtual CPU devices.
"""

from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..engine.round_step import engine_flush_step, engine_round_step
from ..engine.state import EngineConfig, EngineState, init_engine
from ..oram.path_oram import OramState, ShardedPlane

I32 = torch.int32

#: mesh axis across which the bucket trees are sharded
TREE_AXIS = "tree"
#: a leaf's spec: sharded along the tree axis (the reference's
#: ``P(TREE_AXIS)``) or replicated (``P()``); the same tuples as the
#: reference's ``PartitionSpec`` s
SHARDED = (TREE_AXIS,)
REPLICATED = ()

#: the OramState leaves a mesh shards
_TREE_PLANES = ("tree_idx", "tree_val", "tree_leaf", "nonces")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over ``devices`` (a device may repeat). Shard ``i`` of
    every sharded plane lives on ``devices[i]``; ``devices[0]`` is the
    controller, which holds the replicated state and runs the round."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def controller(self) -> torch.device:
        return self.devices[0]


def _device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over the given devices (default: every visible CUDA card;
    raises without one — there is no CPU mesh unless it is asked for).
    A list may repeat a device."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh's devices are all CUDA or all CPU, got {devs}")
    return Mesh(devs)


def _oram_specs() -> OramState:
    return OramState(
        tree_idx=SHARDED,
        tree_val=SHARDED,
        # tree-top cache planes: replicated private state (stash
        # standing) — the controller reads and writes them, so cache
        # accesses need no reduce (2^k−1 buckets is KBs, not the GBs the
        # sharded trees are)
        cache_idx=REPLICATED,
        cache_val=REPLICATED,
        cache_leaf=REPLICATED,
        # leaf-metadata plane (recursive posmap): sharded like tree_idx;
        # zero-length under a flat map (held whole: nothing to shard)
        tree_leaf=SHARDED,
        stash_idx=REPLICATED,
        stash_val=REPLICATED,
        stash_leaf=REPLICATED,
        # delayed-eviction buffer + window bookkeeping: REPLICATED private
        # state, the stash's standing — decided, not defaulted. The fetch
        # round reduces the full working set (_path_gather) and then runs
        # the branchless accumulation into these planes on the
        # controller; sharding them would save KBs (the buffer is E·F·≈4
        # entries, not the GB-scale trees) at the price of a reduce in
        # the flush's eviction assignment. The flush (make_sharded_flush
        # → engine_flush_step(mesh=...) → oram_flush) reads the
        # replicated buffer ∪ stash and owner-masks only the final
        # tree/nonce writes per shard, so the union across the mesh is
        # the one-device flush bit for bit.
        ebuf_idx=REPLICATED,
        ebuf_val=REPLICATED,
        ebuf_leaf=REPLICATED,
        ebuf_paths=REPLICATED,
        ebuf_rounds=REPLICATED,
        ebuf_gen=REPLICATED,
        fetch_tag=REPLICATED,
        # flat: one replicated table. Recursive: a RecursivePosMapState —
        # the spec replicates the whole internal ORAM (its own bucket
        # tree included; its rounds and flushes never see the mesh)
        posmap=REPLICATED,
        overflow=REPLICATED,
        nonces=SHARDED,
        cipher_key=REPLICATED,
        epoch=REPLICATED,
    )


def engine_state_specs() -> EngineState:
    """Spec pytree matching EngineState: trees sharded, rest replicated
    (the generators too: they draw on the controller)."""
    return EngineState(
        rec=_oram_specs(),
        mb=_oram_specs(),
        freelist=REPLICATED,
        free_top=REPLICATED,
        recipients=REPLICATED,
        seq=REPLICATED,
        hash_key=REPLICATED,
        id_key=REPLICATED,
        rng=REPLICATED,
        pm_rng=REPLICATED,
    )


def _on_mesh(x, mesh: Mesh) -> bool:
    return (isinstance(x, ShardedPlane) and len(x.shards) == mesh.size
            and all(s.device == d for s, d in zip(x.shards, mesh.devices)))


def _shard_plane(x, n_buckets: int, mesh: Mesh):
    """One sharded plane of a tree with ``n_buckets`` padded buckets: the
    heap rows split into ``mesh.size`` contiguous ranges, each with one
    scratch bucket row after it, on its device. A plane already on this
    mesh is returned as it is; a zero-length plane stays whole."""
    if _on_mesh(x, mesh):
        return x
    if isinstance(x, ShardedPlane):
        x = x.join(mesh.controller)
    if x.numel() == 0:
        return x.to(mesh.controller)
    n_local = n_buckets // mesh.size
    k = x.shape[0] // n_buckets  # leading elements a bucket (Z, or 1)
    shards = []
    for i, dev in enumerate(mesh.devices):
        part = x[i * n_local * k:(i + 1) * n_local * k].to(dev)
        shards.append(torch.cat([part, part.new_zeros((k, *x.shape[1:]))]))
    return ShardedPlane(shards, n_local)


def _shard_oram(o: OramState, mesh: Mesh) -> OramState:
    v = o.tree_val
    n = v.n_local * len(v.shards) if isinstance(v, ShardedPlane) else v.shape[0]
    return o._replace(**{f: _shard_plane(getattr(o, f), n, mesh) for f in _TREE_PLANES})


def shard_engine_state(state: EngineState, mesh: Mesh) -> EngineState:
    """Place an engine state onto the mesh per ``engine_state_specs``:
    the tree planes split into per-device shards; the replicated leaves
    stay where they are, on the controller (the engine builds and loads
    its state there). Planes already on the mesh are kept as they are,
    so a state already on the mesh comes back unchanged (no copy)."""
    return state._replace(rec=_shard_oram(state.rec, mesh), mb=_shard_oram(state.mb, mesh))


def unshard_oram(o: OramState) -> OramState:
    """``o`` with every sharded plane joined into one tensor (heap order,
    scratch rows left out) on its first shard's device."""
    return o._replace(**{f: x.join(x.shards[0].device) for f, x in zip(o._fields, o)
                         if isinstance(x, ShardedPlane)})


def unshard_engine_state(state: EngineState) -> EngineState:
    """The logical state of a sharded engine as a one-device state (the
    reference gets it from ``np.asarray`` of a sharded array): the tree
    planes joined on the controller."""
    return state._replace(rec=unshard_oram(state.rec), mb=unshard_oram(state.mb))


def init_sharded_engine(ecfg: EngineConfig, mesh: Mesh, seed: int = 0) -> EngineState:
    """Initialize engine state *directly* sharded over the mesh.

    ``init_engine`` + ``shard_engine_state`` would stage the full trees
    on the controller before copying them shard-wise; here each shard is
    allocated on its own device, so peak memory is the sharded footprint
    itself. The random draws are ``init_engine``'s (the trees' initial
    values draw nothing), so the state equals the one-device one."""
    validate_sharded_geometry(ecfg, mesh)

    def tree_full(n_buckets, shape, val):
        if shape[0] == 0:
            return torch.full(shape, val, dtype=I32, device=mesh.controller)
        n_local = n_buckets // mesh.size
        k = shape[0] // n_buckets
        return ShardedPlane(
            [torch.full(((n_local + 1) * k, *shape[1:]), val, dtype=I32, device=d)
             for d in mesh.devices], n_local)

    return init_engine(ecfg, seed, mesh.controller, tree_full=tree_full)


def validate_sharded_geometry(ecfg: EngineConfig, mesh: Mesh) -> None:
    """Directed refusal for knob combinations the sharded programs do
    not cover: raise a precise error naming the combination, or return.

    Everything the sharded step/flush pair DOES cover is silent here:
    evict_every >= 1 (the owner-masked flush), recursive position maps
    (inner trees replicated), tree-top caching (cache planes
    replicated), all cipher impls (the fused kernels give way to a
    gather, the reduce and the row cipher under a mesh), both
    sort/vphases impls.
    """
    n_dev = mesh.size
    for label, cfg in (("records", ecfg.rec), ("mailbox", ecfg.mb)):
        if cfg.n_buckets_padded % n_dev:
            raise ValueError(
                f"sharded path: {n_dev} mesh devices do not divide the "
                f"{label} tree's {cfg.n_buckets_padded} padded buckets "
                "— the bucket axis shards as contiguous equal heap "
                "ranges; use a power-of-two mesh no larger than the "
                "smaller tree"
            )


def make_sharded_step(ecfg: EngineConfig, mesh: Mesh):
    """Engine step with the bucket trees sharded over ``mesh``.

    The returned ``step(state, batch, draws=None, fast_ok=None)`` has the
    semantics of ``engine_round_step(ecfg, state, batch, ...)`` — the
    phase-major batched engine — and gives its results bit for bit. A
    state not yet on the mesh (a loaded checkpoint) is placed first, as
    the reference's jitted step reshards its input; the state is consumed
    (the trees update in place). Delayed eviction (``evict_every > 1``)
    composes: fetch-only rounds accumulate into the replicated eviction
    buffer and the owner-masked flush (:func:`make_sharded_flush`) drains
    the window.
    """
    validate_sharded_geometry(ecfg, mesh)

    def step(state, batch, draws=None, fast_ok=None):
        return engine_round_step(ecfg, shard_engine_state(state, mesh), batch,
                                 draws=draws, fast_ok=fast_ok, mesh=mesh)

    return step


def make_sharded_flush(ecfg: EngineConfig, mesh: Mesh):
    """Delayed-eviction flush with the trees sharded.

    Same semantics as ``engine_flush_step(ecfg, state)``: drains the
    accumulated window into both trees. The dedup and eviction
    assignment run on the replicated working set (buffer ∪ stash) and
    each shard's write is owner-masked to its contiguous heap range via
    the same ``_path_scatter_`` the sharded round uses — the per-shard
    write still carries all ``flush_target_slots`` rows (a static shape),
    but only owned rows land, so the union across the mesh is exactly
    the one-device flush.
    """
    if ecfg.evict_every <= 1:
        raise ValueError(
            "make_sharded_flush: evict_every=1 has no flush program — "
            "the per-round sharded step already writes back every path"
        )
    validate_sharded_geometry(ecfg, mesh)

    def flush(state):
        return engine_flush_step(ecfg, shard_engine_state(state, mesh), mesh)

    return flush
