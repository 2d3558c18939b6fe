"""Static round-cost model, analytic half (port of
``grapevine_tpu/analysis/costmodel.py``).

The reference derives the compiled round's resource footprint twice —
analytically from geometry × knobs, and by walking the traced jaxpr —
and requires the two to agree bit-exactly. This module carries the
analytic derivation and the :class:`CostLedger` built from it: per-phase
HBM bytes (gather/scatter rows × row bytes), cipher rows, sort
key-volume, scatter elements, and the flush-amortized steady-state
round. The numbers equal the reference's field for field at every
geometry the port runs (``tests/test_torch_costmodel.py``); the traced
cross-validation, which walks jaxprs, is ROADMAP.md queue A item 17.

Rows are priced from the round's documented schedule: fetch moves
``B·(path_len−k)`` bucket rows per HBM plane, the tree-top cache
planes move ``B·k``, E=1 write-back mirrors the fetch, a flush scatters
exactly ``flush_target_slots`` rows with zero gathers, and the expiry
sweep streams every tree plane through its chunked pass exactly once.
A recursive position map adds the leaf plane (its own rows, a second
nonce gather for its keystream, a second cipher stream) and composes the
internal ORAM's round and flush under the ``pm_`` prefix, as the
reference does.

Consumer: ``obs/costmon.py`` exports the ledger as ``grapevine_cost_*``
gauges plus the roofline-residual pairing against the tracer's device
spans.
"""

from __future__ import annotations

import dataclasses

#: u32 word size — every HBM plane in the engine is u32-lane
WORD_BYTES = 4

#: phase labels the ledger (and the grapevine_cost_* gauges) aggregate
#: over — public schedule structure, never data
COST_PHASES = ("fetch", "writeback", "flush", "sweep")


@dataclasses.dataclass(frozen=True)
class PlaneRows:
    """One plane's predicted traffic for one program.

    ``hbm`` marks planes resident in device memory (tree/nonce planes);
    the dense ``cache_*`` planes are private working state (the stash's
    standing) — their rows are excluded from the ledger's HBM bytes."""

    shape: tuple  # operand shape the reference's trace attributes on
    divisor: int  # flat slot planes report slots/divisor
    row_words: int  # u32 words per accounted row
    gather_rows: int
    scatter_rows: int
    hbm: bool = True

    def scaled(self, g_mult: int, s_mult: int | None = None) -> "PlaneRows":
        s_mult = g_mult if s_mult is None else s_mult
        return dataclasses.replace(
            self,
            gather_rows=self.gather_rows * g_mult,
            scatter_rows=self.scatter_rows * s_mult,
        )


# -- analytic derivation: rows as a pure function of geometry × knobs ---


def oram_round_rows(cfg, b: int, prefix: str = "") -> dict:
    """Predicted rows per plane for ONE ``oram_round(cfg, ·)`` with a
    batch of ``b`` indices — the E=1 fetch+write-back round, or the
    delayed-eviction fetch-only round when ``cfg.delayed_eviction``.

    - fetch gathers ``R = b·(path_len−k)`` bucket rows per bottom HBM
      plane (idx, val, nonces);
    - the tree-top cache serves the top ``k`` levels: ``C = b·k`` rows
      per cache plane;
    - E=1 write-back scatters the same row counts back (nonces only
      when the at-rest cipher is on — plaintext trees commit no epoch);
    - E>1 rounds are HBM-read-only: zero tree/cache scatters;
    - a recursive map adds the leaf plane (and re-gathers the nonce plane
      for its keystream) and one internal round of the same ``b``,
      composed under the ``pm_`` prefix.
    """
    z, v = cfg.bucket_slots, cfg.value_words
    n = cfg.n_buckets_padded
    k = cfg.top_cache_levels
    cb = cfg.cache_buckets
    recursive = cfg.posmap is not None
    wb = 0 if cfg.delayed_eviction else 1  # write-back present?
    R = b * (cfg.path_len - k)
    C = b * k

    rows = {
        f"{prefix}tree_idx": PlaneRows((n, z), 1, z, R, wb * R),
        f"{prefix}tree_val": PlaneRows((n, z * v), 1, z * v, R, wb * R),
        # the fetch always gathers the nonce plane (the keystream input
        # precedes the encrypted? branch); the epoch commit scatter only
        # exists under the cipher. The leaf plane's keystream re-gathers it.
        f"{prefix}nonces": PlaneRows(
            (n, 2), 1, 2, R * (2 if recursive else 1),
            wb * R if cfg.encrypted else 0,
        ),
    }
    if recursive:
        rows[f"{prefix}tree_leaf"] = PlaneRows((n, z), 1, z, R, wb * R)
    if cb:
        rows[f"{prefix}cache_idx"] = PlaneRows(
            (cb * z,), z, z, C, wb * C, hbm=False
        )
        rows[f"{prefix}cache_val"] = PlaneRows(
            (cb, z * v), 1, z * v, C, wb * C, hbm=False
        )
        if recursive:
            rows[f"{prefix}cache_leaf"] = PlaneRows(
                (cb * z,), z, z, C, wb * C, hbm=False
            )
    if recursive:
        from ..oram.posmap import inner_oram_config

        rows.update(oram_round_rows(
            inner_oram_config(cfg.posmap), b, prefix=f"{prefix}pm_"
        ))
    return rows


def flush_target_rows(cfg) -> int:
    """The analytic flush write-target count (``round.flush_target_slots``;
    the ``min`` is the 1/E amortization past tree saturation)."""
    return min(cfg.evict_window * cfg.evict_fetch_count * cfg.path_len,
               cfg.n_buckets_padded)


def oram_flush_rows(cfg, prefix: str = "") -> dict:
    """Predicted rows per plane for ONE ``oram_flush(cfg, ·)``: every
    plane scatters exactly ``t = flush_target_rows`` rows (the window's
    fetched buckets, deduplicated), zero gathers anywhere — the window's
    live rows were pulled into the private buffer at fetch time. A
    recursive map's internal tree flushes inside the same call."""
    z, v = cfg.bucket_slots, cfg.value_words
    n = cfg.n_buckets_padded
    cb = cfg.cache_buckets
    recursive = cfg.posmap is not None
    t = flush_target_rows(cfg)

    rows = {
        f"{prefix}tree_idx": PlaneRows((n, z), 1, z, 0, t),
        f"{prefix}tree_val": PlaneRows((n, z * v), 1, z * v, 0, t),
        f"{prefix}nonces": PlaneRows(
            (n, 2), 1, 2, 0, t if cfg.encrypted else 0
        ),
    }
    if recursive:
        rows[f"{prefix}tree_leaf"] = PlaneRows((n, z), 1, z, 0, t)
    if cb:
        rows[f"{prefix}cache_idx"] = PlaneRows(
            (cb * z,), z, z, 0, t, hbm=False
        )
        rows[f"{prefix}cache_val"] = PlaneRows(
            (cb, z * v), 1, z * v, 0, t, hbm=False
        )
        if recursive:
            rows[f"{prefix}cache_leaf"] = PlaneRows(
                (cb * z,), z, z, 0, t, hbm=False
            )
    if recursive:
        from ..oram.posmap import inner_oram_config

        rows.update(oram_flush_rows(
            inner_oram_config(cfg.posmap), prefix=f"{prefix}pm_"
        ))
    return rows


def _sharded_plane(name: str) -> bool:
    """True for planes a bucket-axis mesh shards: the outer tree/nonce
    planes of either engine tree (the tree-top cache planes replicate)."""
    if "pm_" in name:
        return False
    base = (name.split("_", 1)[1]
            if name.startswith(("rec_", "mb_")) else name)
    return base.startswith(("tree_", "nonces"))


def engine_round_rows(ecfg) -> dict:
    """One engine round = mailbox round A (``B·D`` fetches) + records
    round B (``B``) + mailbox round C (``B·D``), so the mailbox tree's
    per-round traffic is exactly twice its per-``oram_round`` traffic."""
    b, d = ecfg.batch_size, ecfg.mb_choices
    rows = {
        name: pr.scaled(1)
        for name, pr in oram_round_rows(ecfg.rec, b, "rec_").items()
    }
    for name, pr in oram_round_rows(ecfg.mb, b * d, "mb_").items():
        rows[name] = pr.scaled(2)
    return rows


def engine_flush_rows(ecfg) -> dict:
    """One ``engine_flush_step`` = records flush + mailbox flush (every
    ``evict_every`` engine rounds; both windows drain on one cadence)."""
    return {**oram_flush_rows(ecfg.rec, "rec_"),
            **oram_flush_rows(ecfg.mb, "mb_")}


def expiry_sweep_rows(ecfg) -> dict:
    """Predicted full-pass rows per tree plane for one expiry sweep:
    every chunked plane is read once and the idx/val (and, under a
    recursive map with the cipher on, leaf) planes are written once —
    ``n_buckets_padded`` rows each. The nonce plane is re-keyed by a
    broadcast store outside the chunk pass (counted in the ledger's sweep
    bytes)."""
    out = {}
    for prefix, cfg in (("rec_", ecfg.rec), ("mb_", ecfg.mb)):
        n = cfg.n_buckets_padded
        z, v = cfg.bucket_slots, cfg.value_words
        out[f"{prefix}tree_idx"] = PlaneRows((n, z), 1, z, n, n)
        out[f"{prefix}tree_val"] = PlaneRows((n, z * v), 1, z * v, n, n)
        out[f"{prefix}nonces"] = PlaneRows((n, 2), 1, 2, n, n)
        if cfg.posmap is not None and cfg.encrypted:
            out[f"{prefix}tree_leaf"] = PlaneRows((n, z), 1, z, n, n)
    return out


# -- the ledger: bytes, cipher rows, sort volume, steady state ----------


@dataclasses.dataclass
class PhaseCost:
    """One phase's modeled resource footprint (all integers: counts)."""

    gather_rows: int = 0
    scatter_rows: int = 0
    gather_bytes: int = 0
    scatter_bytes: int = 0
    cipher_rows: int = 0  # rows through the bucket-cipher keystream
    sort_keys: int = 0  # keys entering sort/rank machinery
    scatter_elems: int = 0  # scattered u32 elements
    #: the subset of scatter_bytes landing in mesh-SHARDED planes (outer
    #: tree/nonce planes): under a sharded engine these partition by the
    #: owner mask, while the remainder lands in full on every chip
    sharded_scatter_bytes: int = 0

    @property
    def hbm_bytes(self) -> int:
        return self.gather_bytes + self.scatter_bytes

    def per_chip_bytes(self, shards: int) -> float:
        """Device-memory bytes ONE chip of a ``shards``-way mesh moves for
        this phase: gathers keep their full uniform per-chip count,
        owner-masked scatters partition (modeled uniform), replicated-
        plane scatters land in full."""
        repl = self.scatter_bytes - self.sharded_scatter_bytes
        return (self.gather_bytes + repl
                + self.sharded_scatter_bytes / shards)

    def add_rows(self, rows: dict) -> "PhaseCost":
        """Accumulate the device-resident planes (private ``cache_*``
        planes carry no HBM traffic)."""
        for name, pr in rows.items():
            if not pr.hbm:
                continue
            self.gather_rows += pr.gather_rows
            self.scatter_rows += pr.scatter_rows
            self.gather_bytes += pr.gather_rows * pr.row_words * WORD_BYTES
            self.scatter_bytes += (
                pr.scatter_rows * pr.row_words * WORD_BYTES
            )
            if _sharded_plane(name):
                self.sharded_scatter_bytes += (
                    pr.scatter_rows * pr.row_words * WORD_BYTES
                )
            self.scatter_elems += pr.scatter_rows * pr.row_words
        return self


@dataclasses.dataclass
class CostLedger:
    """Per-phase modeled costs for one engine geometry × knob setting,
    plus the flush-amortized steady-state round aggregate."""

    phases: dict  # phase name -> PhaseCost
    evict_every: int
    #: bucket-tree shard count the per-chip views divide over; 1 = one
    #: device. Power of two, like the mesh it models.
    shards: int = 1

    @property
    def steady_round_bytes(self) -> float:
        """Device-memory bytes per steady-state engine round: fetch +
        write-back (E=1) + flush/E (E>1). The sweep is operator-cadenced
        and excluded — it has its own phase entry."""
        total = (self.phases["fetch"].hbm_bytes
                 + self.phases["writeback"].hbm_bytes)
        return total + self.phases["flush"].hbm_bytes / max(
            1, self.evict_every
        )

    @property
    def steady_round_cipher_rows(self) -> float:
        total = (self.phases["fetch"].cipher_rows
                 + self.phases["writeback"].cipher_rows)
        return total + self.phases["flush"].cipher_rows / max(
            1, self.evict_every
        )

    @property
    def steady_round_sort_keys(self) -> float:
        total = (self.phases["fetch"].sort_keys
                 + self.phases["writeback"].sort_keys)
        return total + self.phases["flush"].sort_keys / max(
            1, self.evict_every
        )

    @property
    def per_shard_steady_round_bytes(self) -> float:
        """Device-memory bytes ONE chip of the ``shards``-way mesh moves
        per steady-state round; ``shards=1`` is :attr:`steady_round_bytes`
        exactly."""
        total = (self.phases["fetch"].per_chip_bytes(self.shards)
                 + self.phases["writeback"].per_chip_bytes(self.shards))
        return total + self.phases["flush"].per_chip_bytes(
            self.shards
        ) / max(1, self.evict_every)

    def floor_ms(self, gbytes_per_s: float) -> float:
        """Roofline round-time floor at a calibrated achieved bandwidth:
        modeled per-chip steady-state bytes / bandwidth."""
        return self.per_shard_steady_round_bytes / (gbytes_per_s * 1e6)


def _round_sort_keys(cfg, b: int, occ_impl: str) -> int:
    """Sort key-volume of one oram_round: the eviction leaf argsort over
    the working set (E=1 only — fetch rounds recompact with rank_of,
    sort-free) plus the dedup group sort under the scan occurrence
    machinery, composed recursively for the internal map round."""
    z = cfg.bucket_slots
    plen = cfg.path_len
    keys = 0
    if not cfg.delayed_eviction:
        w = cfg.stash_size + b * plen * z + b  # E=1 working set
        keys += w
    if occ_impl == "scan":
        keys += b  # occurrence group sort
    if cfg.posmap is not None:
        from ..oram.posmap import inner_oram_config

        if occ_impl == "scan":
            keys += b  # recursive group-last-slot sort
        keys += _round_sort_keys(inner_oram_config(cfg.posmap), b, occ_impl)
    return keys


def _flush_sort_keys(cfg) -> int:
    """One flush: the public window dedup sort plus the eviction
    argsort over buffer ∪ stash (recursing into the internal map)."""
    keys = (cfg.evict_window * cfg.evict_fetch_count * cfg.path_len
            + cfg.evict_buffer_slots + cfg.stash_size)
    if cfg.posmap is not None:
        from ..oram.posmap import inner_oram_config

        keys += _flush_sort_keys(inner_oram_config(cfg.posmap))
    return keys


def _round_cipher_rows(cfg, b: int) -> int:
    """Keystream rows of one oram_round: decrypt the fetched bottom
    rows (+ the recursive leaf plane's stream), and under E=1 encrypt the
    same counts back; plus the internal map round's."""
    rows = 0
    if cfg.encrypted:
        R = b * (cfg.path_len - cfg.top_cache_levels)
        streams = 2 if cfg.posmap is not None else 1  # idx/val + leaf
        passes = 1 if cfg.delayed_eviction else 2  # fetch (+ write-back)
        rows = R * streams * passes
    if cfg.posmap is not None:
        from ..oram.posmap import inner_oram_config

        rows += _round_cipher_rows(inner_oram_config(cfg.posmap), b)
    return rows


def _flush_cipher_rows(cfg) -> int:
    rows = 0
    if cfg.encrypted:
        rows = flush_target_rows(cfg) * (2 if cfg.posmap is not None else 1)
    if cfg.posmap is not None:
        from ..oram.posmap import inner_oram_config

        rows += _flush_cipher_rows(inner_oram_config(cfg.posmap))
    return rows


def engine_cost_ledger(ecfg, occ_impl: str | None = None,
                       shards: int = 1) -> CostLedger:
    """The full modeled ledger for one engine geometry × knob setting —
    the object obs/costmon.py exports. ``occ_impl`` defaults to the
    engine's occurrence machinery (``"dense"``, the only one the port
    runs); ``shards`` is the bucket-tree mesh width."""
    if shards < 1 or shards & (shards - 1):
        raise ValueError(f"shards={shards}: want a power of two >= 1")
    occ = occ_impl if occ_impl is not None else "dense"
    b, d = ecfg.batch_size, ecfg.mb_choices
    round_rows = engine_round_rows(ecfg)
    fetch = PhaseCost().add_rows({
        n: dataclasses.replace(pr, scatter_rows=0)
        for n, pr in round_rows.items()
    })
    wb = PhaseCost().add_rows({
        n: dataclasses.replace(pr, gather_rows=0)
        for n, pr in round_rows.items()
    })
    flush = PhaseCost()
    if ecfg.evict_every > 1:
        flush.add_rows(engine_flush_rows(ecfg))
        flush.sort_keys = (_flush_sort_keys(ecfg.rec)
                           + _flush_sort_keys(ecfg.mb))
        flush.cipher_rows = (_flush_cipher_rows(ecfg.rec)
                             + _flush_cipher_rows(ecfg.mb))
    sweep = PhaseCost().add_rows(expiry_sweep_rows(ecfg))
    # the sweep's nonce re-key is a broadcast store over each tree's
    # whole nonce plane (outside the chunk pass)
    for cfg in (ecfg.rec, ecfg.mb):
        if cfg.encrypted:
            n = cfg.n_buckets_padded
            sweep.scatter_rows += n
            sweep.scatter_bytes += n * 2 * WORD_BYTES
            sweep.scatter_elems += n * 2
            sweep.cipher_rows += 2 * n * (2 if cfg.posmap is not None else 1)
    # round-phase cipher/sort volumes: records once, mailbox twice
    dec_total = (_round_cipher_rows(ecfg.rec, b)
                 + 2 * _round_cipher_rows(ecfg.mb, b * d))
    sort_total = (_round_sort_keys(ecfg.rec, b, occ)
                  + 2 * _round_sort_keys(ecfg.mb, b * d, occ))
    if ecfg.evict_every > 1:
        fetch.cipher_rows = dec_total
        fetch.sort_keys = sort_total
    else:
        # E=1: the fetch/write-back split of the joint round program is
        # half decrypt, half re-encrypt; the eviction sort rides the
        # write-back half
        fetch.cipher_rows = dec_total // 2
        wb.cipher_rows = dec_total - dec_total // 2
        wb.sort_keys = sort_total
    return CostLedger(
        phases={"fetch": fetch, "writeback": wb, "flush": flush,
                "sweep": sweep},
        evict_every=ecfg.evict_every,
        shards=shards,
    )


def oram_steady_bytes(cfg, b: int) -> float:
    """Amortized device-memory bytes per round of one isolated ORAM: the
    round's gather (+ E=1 write-back) bytes plus flush bytes / E."""
    total = PhaseCost().add_rows(oram_round_rows(cfg, b)).hbm_bytes
    if cfg.delayed_eviction:
        total += (PhaseCost().add_rows(oram_flush_rows(cfg)).hbm_bytes
                  / cfg.evict_window)
    return float(total)


def oram_sharded_steady_bytes(cfg, b: int, shards: int) -> float:
    """Per-CHIP amortized bytes per round of one isolated ORAM on a
    ``shards``-way mesh: gathers at the full uniform per-chip count,
    owner-masked scatters into the sharded planes divided. ``shards=1``
    equals :func:`oram_steady_bytes` exactly."""
    if shards < 1 or shards & (shards - 1):
        raise ValueError(f"shards={shards}: want a power of two >= 1")
    pc = PhaseCost().add_rows(oram_round_rows(cfg, b))
    total = pc.per_chip_bytes(shards)
    if cfg.delayed_eviction:
        fl = PhaseCost().add_rows(oram_flush_rows(cfg))
        total += fl.per_chip_bytes(shards) / cfg.evict_window
    return float(total)
