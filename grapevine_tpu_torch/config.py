"""Configuration for the grapevine engine (PyTorch port).

A copy of ``grapevine_tpu/config.py``'s ``GrapevineConfig``: every field
name, default, derived geometry property and validation is kept, so one
config object's values drive both packages, and the port runs every
knob value the reference does (resolved in
``engine/state.py:EngineConfig.from_config``). The field comments below
describe what each knob selects; the reference's copy carries its
measurement history.

Capacity story: the records store is a Path-ORAM bucket tree with
``2**records_height`` leaves and a dense block space of the same size; the
mailbox store is a keyed two-choice hash table (K mailboxes per bucket)
over its own Path-ORAM, run at a load where bucket overflow is negligible.
Maximum in-flight messages = ``max_messages`` (bounded by the free-block
list); maximum distinct recipients with mail = ``max_recipients`` (also
soft-bounded by table load; overflow reports TOO_MANY_RECIPIENTS).
"""

from __future__ import annotations

import dataclasses
import math

from .wire import constants as C


@dataclasses.dataclass(frozen=True)
class GrapevineConfig:
    # --- semantic capacities -------------------------------------------
    #: max in-flight messages on the bus (reference README.md:75-76)
    max_messages: int = 1 << 14
    #: max distinct recipients with in-flight messages
    max_recipients: int = 1 << 12
    #: per-recipient in-flight cap (reference README.md:78-80)
    mailbox_cap: int = C.MAILBOX_CAP
    #: message expiry period in seconds; 0 disables (reference README.md:86-98)
    expiry_period: int = 0

    # --- device engine geometry ----------------------------------------
    #: Path-ORAM bucket capacity (Z); upstream mc-oblivious uses Z=4 with
    #: 4096B buckets of 1024B blocks (SURVEY.md §7.4)
    bucket_slots: int = 4
    #: fixed stash slots per ORAM (overflow is a sticky internal error)
    stash_size: int = 96
    #: client ops per engine round; the host pads with dummy ops
    batch_size: int = 8
    #: mailboxes per hash bucket (one bucket = one mailbox-ORAM block)
    mailbox_slots: int = 4
    #: within-batch commit schedule: "phase" = phase-major batched rounds
    #: (engine/round_step.py — the production path: one path fetch per
    #: ORAM round instead of one per op), "op" = op-major sequential
    #: commits (engine/step.py — the original reference-shaped engine).
    #: Identical semantics for single-op batches; batch-hazard semantics
    #: documented in round_step.py.
    commit: str = "phase"
    #: ChaCha rounds for at-rest bucket-tree encryption in device memory
    #: — the EPC analog (oblivious/bucket_cipher.py). 8 = ChaCha8
    #: (default), 20 = RFC ChaCha20, 0 = plaintext trees.
    bucket_cipher_rounds: int = 8
    #: cipher implementation: "jnp" (plain array cipher, keystream
    #: materialized), "pallas" (fused keystream+XOR kernel),
    #: "pallas_fused" (the path fetch and write-back fused with the
    #: cipher, one device-memory pass per row) or "pallas_fused_tiled"
    #: (same contract; in the port, the hand-written CUDA kernels of
    #: oblivious/gather_kernels.py). Bit-identical ciphertext in all four.
    bucket_cipher_impl: str = "jnp"
    #: per-request signature scheme: "schnorrkel" (sr25519, byte-compatible
    #: with the reference's sign_schnorrkel clients — README.md:193-199,
    #: session/schnorrkel.py) or "rfc9496" (the same-shape plain Schnorr
    #: this repo shipped first, session/ristretto.py). Server and clients
    #: must agree.
    signature_scheme: str = "schnorrkel"

    def __post_init__(self):
        if self.commit not in ("phase", "op"):
            raise ValueError(
                f"commit must be 'phase' or 'op', got {self.commit!r}"
            )
        # 0 = plaintext; otherwise an even round count ≥ 8 (ChaCha rounds
        # come in column+diagonal pairs; odd values would silently floor,
        # and rounds < 8 have no security story — a 0-round "cipher"
        # exposes 2*key in every keystream block)
        r = self.bucket_cipher_rounds
        if r != 0 and (r < 8 or r % 2 != 0):
            raise ValueError(
                f"bucket_cipher_rounds must be 0 or an even value >= 8, got {r}"
            )
        if self.bucket_cipher_impl not in (
            "jnp", "pallas", "pallas_fused", "pallas_fused_tiled"
        ):
            raise ValueError(
                f"bucket_cipher_impl must be 'jnp', 'pallas', "
                f"'pallas_fused' or 'pallas_fused_tiled', got "
                f"{self.bucket_cipher_impl!r}"
            )
        if self.signature_scheme not in ("schnorrkel", "rfc9496"):
            raise ValueError(
                f"signature_scheme must be 'schnorrkel' or 'rfc9496', got "
                f"{self.signature_scheme!r}"
            )
        if self.vphases_impl not in (None, "dense", "scan"):
            raise ValueError(
                f"vphases_impl must be None, 'dense' or 'scan', got "
                f"{self.vphases_impl!r}"
            )
        if self.sort_impl not in (None, "xla", "radix"):
            raise ValueError(
                f"sort_impl must be None, 'xla' or 'radix', got "
                f"{self.sort_impl!r}"
            )
        if self.max_messages < 2 or self.max_messages & (self.max_messages - 1):
            raise ValueError("max_messages must be a power of two >= 2")
        if self.tree_density not in (1, 2, 4):
            raise ValueError(
                f"tree_density must be 1, 2, or 4, got {self.tree_density}"
            )
        if self.mailbox_choices not in (None, 1, 2):
            raise ValueError(
                f"mailbox_choices must be None, 1 or 2, got "
                f"{self.mailbox_choices}"
            )
        if self.commit == "op" and self.mailbox_choices == 2:
            raise ValueError(
                "commit='op' (the differential-oracle engine) supports "
                "only mailbox_choices=1"
            )
        if self.posmap_impl not in (None, "flat", "recursive"):
            raise ValueError(
                f"posmap_impl must be None, 'flat' or 'recursive', got "
                f"{self.posmap_impl!r}"
            )
        if self.commit == "op" and self.posmap_impl == "recursive":
            raise ValueError(
                "commit='op' (the differential-oracle engine) supports "
                "only posmap_impl='flat' — the recursive position map "
                "rides the phase-major batched round"
            )
        tc = self.tree_top_cache_levels
        if tc is not None and (not isinstance(tc, int) or tc < 0):
            raise ValueError(
                f"tree_top_cache_levels must be None (auto) or an int "
                f">= 0, got {tc!r}"
            )
        if self.pipeline_depth not in (None, 1, 2):
            raise ValueError(
                f"pipeline_depth must be None (auto), 1 or 2, got "
                f"{self.pipeline_depth!r}"
            )
        ee = self.evict_every
        if ee is not None and (not isinstance(ee, int) or ee < 1):
            raise ValueError(
                f"evict_every must be None (auto) or an int >= 1, got "
                f"{ee!r}"
            )
        if self.commit == "op" and ee not in (None, 1):
            raise ValueError(
                "commit='op' (the differential-oracle engine) supports "
                "only evict_every=1 — delayed batched eviction rides the "
                "phase-major batched round"
            )
        ebs = self.evict_buffer_slots
        if ebs is not None and (not isinstance(ebs, int) or ebs < 1):
            raise ValueError(
                f"evict_buffer_slots must be None (auto) or an int >= 1, "
                f"got {ebs!r}"
            )
        if self.commit == "op" and tc not in (None, 0):
            raise ValueError(
                "commit='op' (the differential-oracle engine) supports "
                "only tree_top_cache_levels=0 — the tree-top cache "
                "rides the phase-major batched round, and the op-major "
                "engine stays cache-free as the differential oracle"
            )
        sh = self.shards
        if not isinstance(sh, int) or sh < 1 or sh & (sh - 1):
            raise ValueError(
                f"shards must be a power-of-two int >= 1, got {sh!r} — "
                "the bucket trees shard as contiguous equal heap ranges "
                "(parallel/mesh.py)"
            )
        if self.commit == "op" and sh != 1:
            raise ValueError(
                "commit='op' (the differential-oracle engine) supports "
                "only shards=1 — the sharded step/flush programs wrap "
                "the phase-major batched round (parallel/mesh.py "
                "make_sharded_step), and the op-major engine stays "
                "single-chip as the differential oracle"
            )
    # The knobs below select between implementations or schedules with
    # identical responses; the port runs the values its EngineConfig
    # resolves (engine/state.py:EngineConfig.from_config).

    #: slot-order machinery of the phase-major engine's vectorized phases
    #: (engine/vphases.py): "dense" = [B,B] masked matrices and one-hot
    #: matmuls, "scan" = group sort + segmented scans (no [B,B]
    #: intermediate). None = auto.
    vphases_impl: str | None = None

    #: bounded-key sort engine: "xla" = comparison sorts, "radix" =
    #: oblivious LSD counting passes for every sort whose key has a
    #: declared bit bound. None = auto.
    sort_impl: str | None = None

    #: position map for both ORAMs: "flat" = the private u32[blocks+1]
    #: table, "recursive" = one level of recursive position ORAM (a
    #: smaller internal Path ORAM holding packed entries). None = auto
    #: ("flat").
    posmap_impl: str | None = None

    #: tree-top cache depth k for every bucket tree: the top k levels
    #: (2^k − 1 buckets, on every root→leaf path, so caching them is
    #: access-pattern-neutral) live decrypted in private cache planes;
    #: only the bottom levels touch the encrypted trees. 0 = off; k is
    #: clamped to each tree's height. None = auto (4).
    tree_top_cache_levels: int | None = None

    #: dispatched-but-unresolved engine rounds a driver holds: 1 = serial,
    #: 2 = the staged pipeline (assembly and journal of round k+1 overlap
    #: round k on the device). None = auto.
    pipeline_depth: int | None = None

    #: delayed batched eviction: every E engine rounds the write-back runs
    #: once as a flush over the window's fetched paths; between flushes
    #: fetched blocks wait in a bounded private eviction buffer. 1 =
    #: evict every round. None = auto (1).
    evict_every: int | None = None

    #: eviction-buffer capacity (rows) per payload tree under
    #: evict_every > 1. None = auto per tree.
    evict_buffer_slots: int | None = None

    #: bucket-tree shard count across devices: 1 = single device; N > 1
    #: shards both payload trees as contiguous heap ranges over N devices
    #: (parallel/mesh.py). Not part of EngineConfig, so journals and
    #: checkpoints replay across shard counts.
    shards: int = 1

    #: hash choices per recipient in the mailbox table: 2 =
    #: power-of-two-choices (every op fetches both candidate paths, so the
    #: transcript hides which holds the recipient), 1 = single choice.
    #: None = auto: 2 for commit="phase", 1 for "op".
    mailbox_choices: int | None = None

    #: per-slot load target of the mailbox table: table buckets M =
    #: ceil(max_recipients / (mailbox_slots * load)). None = auto: 0.5
    #: under two choices, 0.125 under one.
    mailbox_load: float | None = None

    #: blocks per tree leaf for both ORAMs: 1 = the classic Path ORAM
    #: shape, 2 halves tree memory per block and shortens every path by
    #: one level, 4 is the aggressive setting.
    tree_density: int = 2

    @property
    def records_height(self) -> int:
        """Tree height of the records ORAM: leaves = blocks / density."""
        return max(
            1,
            math.ceil(math.log2(self.max_messages))
            - (self.tree_density.bit_length() - 1),
        )

    @property
    def records_leaves(self) -> int:
        return 1 << self.records_height

    @property
    def resolved_mailbox_choices(self) -> int:
        """1 or 2: the explicit knob, else 2 for phase / 1 for op."""
        if self.mailbox_choices is not None:
            return self.mailbox_choices
        return 2 if self.commit == "phase" else 1

    @property
    def resolved_mailbox_load(self) -> float:
        """Load target: the explicit knob, else by choice count."""
        if self.mailbox_load is not None:
            return self.mailbox_load
        return 0.5 if self.resolved_mailbox_choices == 2 else 0.125

    @property
    def mailbox_table_buckets(self) -> int:
        """Hash table size (power of two) for the mailbox map.

        Floor of 16: keeps the mailbox bucket tree shardable over an
        8-chip mesh at toy capacities and gives the two-choice hash a
        meaningful candidate space; the cost at tiny configs is a few
        KiB."""
        want = max(
            16,
            math.ceil(
                self.max_recipients
                / (self.mailbox_slots * self.resolved_mailbox_load)
            ),
        )
        return 1 << max(1, math.ceil(math.log2(want)))

    @property
    def mailbox_height(self) -> int:
        """Tree height of the mailbox ORAM: block space = hash-table buckets."""
        return max(
            1,
            math.ceil(math.log2(self.mailbox_table_buckets))
            - (self.tree_density.bit_length() - 1),
        )

    @property
    def mailbox_leaves(self) -> int:
        return 1 << self.mailbox_height


@dataclasses.dataclass(frozen=True)
class DurabilityConfig:
    """Crash-safety knobs (engine/checkpoint.py, engine/journal.py).

    With a ``state_dir`` set, the engine journals every admitted batch
    (sealed, fsync-batched) before dispatching it and periodically dumps
    a sealed whole-``EngineState`` checkpoint; restart = load the last
    checkpoint + deterministically replay the journal tail. Whole-state
    dumps and whole-batch journal records are access-pattern-free by
    construction: they are written for every round regardless of what
    the ops inside are, so durability adds no obliviousness leak.
    """

    #: directory holding checkpoints, journal segments, and (by default)
    #: the auto-generated root seal key
    state_dir: str
    #: rounds+sweeps between sealed checkpoints (RTO knob: recovery
    #: replays at most this many journal records)
    checkpoint_every_rounds: int = 64
    #: journal records per fsync. 1 (default) = every record is durable
    #: before its round dispatches (RPO 0 for acknowledged ops); larger
    #: values amortize the fsync at the cost of losing up to N-1
    #: acknowledged rounds on a *machine* crash (a process crash alone
    #: loses nothing — the page cache survives)
    journal_fsync_every: int = 1
    #: 32-byte root seal key file; None = ``<state_dir>/root.key``,
    #: auto-generated 0600 on first start. Point it at a separately
    #: mounted secret in production: a sealed checkpoint next to its
    #: key is integrity-protected but not confidential
    seal_key_file: str | None = None

    def __post_init__(self):
        if not self.state_dir:
            raise ValueError("durability requires a state_dir")
        if self.checkpoint_every_rounds < 1:
            raise ValueError("checkpoint_every_rounds must be >= 1")
        if self.journal_fsync_every < 1:
            raise ValueError("journal_fsync_every must be >= 1")


DEFAULT_CONFIG = GrapevineConfig()
