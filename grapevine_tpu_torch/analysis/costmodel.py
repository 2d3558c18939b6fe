"""Static round-cost model (port of ``grapevine_tpu/analysis/costmodel.py``):
two independent derivations of the round's resource footprint, required
to agree bit-exactly.

1. **Analytic** (:func:`oram_round_rows`, :func:`oram_flush_rows`,
   :func:`engine_round_rows`, :func:`expiry_sweep_rows`): a pure function
   of geometry × knobs, and the :class:`CostLedger` built from it —
   per-phase device-memory bytes (gather/scatter rows × row bytes),
   cipher rows, sort key-volume, scatter elements, and the
   flush-amortized steady-state round. It equals the reference's field
   for field (``tests/test_torch_obs.py``).
2. **Traced** (:func:`traced_access_rows`, :func:`traced_scan_rows`): the
   rows the captured graph moves (:func:`.fx_walk.plane_rows`, the
   census core the obliviousness analyzer reads), per operand shape
   class. A kernel node (B3-B6) moves ``flat_b``'s rows of the slot,
   value and nonce planes, as the plain path's three gathers do.

:func:`cross_validate_round` and friends require the two to agree per
shape class; the seeded undercount mutants (:func:`run_cost_mutants`)
corrupt the analytic side one defect at a time, and each must raise
:class:`CostModelMismatch` of its kind. :func:`ab_verdict` is the model's
pick for each knob A/B, a pure function of geometry.

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
spans; :mod:`.check_cost_model` is the gate. The traced half imports
torch when it is called: importing this module does not.
"""

from __future__ import annotations

import dataclasses

#: u32 word size — every HBM plane in the engine is u32-lane
WORD_BYTES = 4

#: phase labels the ledger (and the grapevine_cost_* gauges) aggregate
#: over — public schedule structure, never data
COST_PHASES = ("fetch", "writeback", "flush", "sweep")


class CostModelMismatch(AssertionError):
    """The analytic model and the traced census disagree. ``kind`` is the
    defect class (``gather-undercount``, ``scatter-undercount``,
    ``gather-overcount``, ``scatter-overcount``, ``arithmetic``) the
    mutant controls match on."""

    def __init__(self, msg: str, kind: str):
        super().__init__(msg)
        self.kind = kind


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


def oram_planes(cfg, prefix: str = "") -> dict:
    """Every plane one ``oram_round``/``oram_flush`` at geometry ``cfg``
    can touch, as ``plane_rows`` declarations (name -> (shape,
    divisor)): the slot planes as ``[n, Z]`` bucket rows (the port's
    flat ``tree_idx`` is indexed through that view), the flat cache slot
    planes in slots / Z, and the internal map's planes under ``pm_``."""
    z, v = cfg.bucket_slots, cfg.value_words
    n = cfg.n_buckets_padded
    cb = cfg.cache_buckets
    planes = {
        f"{prefix}tree_idx": ((n, z), 1),
        f"{prefix}tree_val": ((n, z * v), 1),
        f"{prefix}nonces": ((n, 2), 1),
    }
    if cfg.posmap is not None:
        planes[f"{prefix}tree_leaf"] = ((n, z), 1)
    if cb:
        planes[f"{prefix}cache_idx"] = ((cb * z,), z)
        planes[f"{prefix}cache_val"] = ((cb, z * v), 1)
        if cfg.posmap is not None:
            planes[f"{prefix}cache_leaf"] = ((cb * z,), z)
    if cfg.posmap is not None:
        from ..oram.posmap import inner_oram_config

        planes.update(oram_planes(inner_oram_config(cfg.posmap), prefix=f"{prefix}pm_"))
    return planes


def engine_planes(ecfg) -> dict:
    """Both trees' plane declarations for one engine round or flush."""
    return {**oram_planes(ecfg.rec, "rec_"), **oram_planes(ecfg.mb, "mb_")}


def sweep_chunk_planes(cfg, prefix: str = "") -> dict:
    """The planes one tree's expiry sweep streams through its chunk
    passes: name -> (plane shape, rows a full pass). The port's sweep is
    an unrolled loop over row chunks (``engine/expiry.py``), so a pass is
    the sum of its chunks' slices of the whole plane (the reference keys
    the same passes by its scan's ``[n_chunks, rows, ·]`` chunk shape)."""
    z, v = cfg.bucket_slots, cfg.value_words
    n = cfg.n_buckets_padded
    planes = {
        f"{prefix}tree_idx": ((n, z), n),
        f"{prefix}tree_val": ((n, z * v), n),
        f"{prefix}nonces": ((n, 2), n),
    }
    if cfg.posmap is not None and cfg.encrypted:
        planes[f"{prefix}tree_leaf"] = ((n, z), n)
    return planes


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


def shard_local_rows(rows: dict, shards: int) -> dict:
    """The analytic rows of one program on a ``shards``-way virtual mesh
    as the port captures it: every sharded plane becomes its shards'
    ``[n / shards + 1, ·]`` planes (each shard's heap range and its
    scratch row, ``oram/path_oram.py:ShardedPlane``) and, since the one
    captured graph holds every shard's program, its rows count once per
    shard — each shard dispatches the full uniform scatter; the owner
    mask bounds which rows land, never the op's shape. Replicated planes
    (cache, inner posmap trees) keep their shape and count."""
    if shards < 1 or shards & (shards - 1):
        raise ValueError(f"shards={shards}: want a power of two >= 1")
    out = {}
    for name, pr in rows.items():
        if pr.hbm and _sharded_plane(name):
            n = pr.shape[0]
            if n % shards:
                raise ValueError(f"{name}: {n} rows do not divide over {shards} shards")
            pr = dataclasses.replace(
                pr, shape=(n // shards + 1,) + tuple(pr.shape[1:]),
                gather_rows=pr.gather_rows * shards, scatter_rows=pr.scatter_rows * shards)
        out[name] = pr
    return out


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
    engine's occurrence machinery (``ecfg.vphases_impl``); ``shards`` is
    the bucket-tree mesh width."""
    if shards < 1 or shards & (shards - 1):
        raise ValueError(f"shards={shards}: want a power of two >= 1")
    occ = occ_impl if occ_impl is not None else (
        "scan" if ecfg.vphases_impl == "scan" else "dense")
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


# -- traced derivation: the captured graph's rows -----------------------


def _shape_classes(planes: dict) -> dict:
    """Collapse plane declarations to unique (shape, divisor) classes —
    the granularity at which attribution is exact (``tree_idx`` and
    ``tree_leaf`` share ``[n, Z]``)."""
    uniq = {(tuple(shape), int(div)) for shape, div in planes.values()}
    return {f"{s}/{d}": (s, d) for s, d in sorted(uniq)}


#: the OramState fields that are tree planes (the ledger's rows)
TREE_PLANES = ("tree_idx", "tree_val", "nonces", "tree_leaf", "cache_idx", "cache_val",
               "cache_leaf")


def _plane_sources(cap):
    """A capture's placeholders holding a tree plane (a sharded plane's
    label ends ``<plane>.shards.<i>``)."""
    phs = [n for n in cap.gm.graph.nodes if n.op == "placeholder"]
    out = []
    for lb, n in zip(cap.labels, phs):
        parts = lb.split(".")
        if len(parts) > 2 and parts[-2] == "shards":
            parts = parts[:-2]
        if parts[-1] in TREE_PLANES:
            out.append(n)
    return out


def traced_access_rows(cap, planes: dict) -> dict:
    """Derivation 2: gather/scatter rows per shape class of a capture
    (:func:`.fx_walk.plane_rows`), counting only operands that hold an
    input's tree plane — a private array that shares a plane's shape
    (``[B, 2]`` at B equal to a tree's bucket count) is not a plane.
    Returns ``{(shape, divisor): (gather_rows, scatter_rows)}``."""
    from .fx_walk import plane_rows

    classes = _shape_classes(planes)
    moved = plane_rows(cap.gm, classes, _plane_sources(cap))
    out = {}
    for cname, (shape, div) in classes.items():
        g = sum(r for op, r in moved[cname] if _is_gather(op))
        out[(shape, div)] = (g, sum(r for op, r in moved[cname] if not _is_gather(op)))
    return out


def _is_gather(op: str) -> bool:
    return op.startswith(("aten.index.", "aten.index_select", "aten.gather",
                          "gv.gather_decrypt_rows"))


def predicted_access_rows(rows: dict) -> dict:
    """The analytic side of the same aggregation: per shape class, summed
    over the planes that share it."""
    out: dict = {}
    for pr in rows.values():
        key = (tuple(pr.shape), int(pr.divisor))
        g, s = out.get(key, (0, 0))
        out[key] = (g + pr.gather_rows, s + pr.scatter_rows)
    return out


def traced_scan_rows(cap, chunk_planes: dict) -> dict:
    """Sweep derivation 2: rows the chunk passes stream per plane-shape
    class — every slice of a plane-shaped tensor along its bucket axis
    that an op reads (``slice``; a copy's destination is not a read), and
    every one written back (``slice_scatter``), summed over the unrolled
    chunks. Returns ``{plane shape: (read_rows,
    write_rows)}``."""
    from .fx_walk import derived_planes, op_name, walk_nodes

    keep = derived_planes(cap.gm, _plane_sources(cap))
    shapes = {tuple(shape) for shape, _ in chunk_planes.values()}
    out = {shape: [0, 0] for shape in shapes}
    for node in walk_nodes(cap.gm):
        name = op_name(node.target)
        if name not in ("aten.slice.Tensor", "aten.slice_scatter.default") \
                or node.args[0] not in keep:
            continue
        base = node.args[0].meta.get("val")
        dim = node.args[2] if name == "aten.slice_scatter.default" and len(node.args) > 2 \
            else node.args[1] if name == "aten.slice.Tensor" and len(node.args) > 1 else 0
        if base is None or tuple(base.shape) not in out or dim != 0:
            continue
        if name == "aten.slice.Tensor":
            # a view nothing reads, or only a copy writes into, is the
            # write-back's target, not a read
            if any(not (op_name(u.target) == "aten.copy.default" and u.args[0] is node)
                   for u in node.users):
                out[tuple(base.shape)][0] += node.meta["val"].shape[0]
        else:
            out[tuple(base.shape)][1] += node.args[1].meta["val"].shape[0]
    return {shape: (r, w) for shape, (r, w) in out.items()}


# -- trace builders (fake captures: nothing runs, nothing is allocated) --


def _apply_noop(vals0, present0):
    return vals0.sum(dim=1), vals0, present0


def trace_oram_round(cfg, b: int, device=None):
    """The capture of one ``oram_round`` (fake: index values cannot matter
    to the op shapes)."""
    from ..device import resolve_device
    from ..oram.round import oram_round
    from .check_oblivious import oram_state
    from .fx_walk import capture, fake_inputs

    dev = resolve_device(device)
    recursive = cfg.posmap is not None

    def build():
        return oram_state(cfg, dev), *(_zeros(b, dev) for _ in range(5))

    def run(st, idxs, nl, dl, pm_nl, pm_dl):
        return oram_round(cfg, st, idxs, nl, dl, _apply_noop, "xla",
                          *((pm_nl, pm_dl) if recursive else ()))

    return capture(run, *fake_inputs(build), name="oram_round")


def _zeros(n: int, dev):
    import torch

    return torch.zeros(n, dtype=torch.int32, device=dev)


def trace_oram_flush(cfg, device=None, shards: int = 1):
    """The capture of one ``oram_flush``; ``shards > 1`` on a
    virtual mesh of that many shards of ``device`` (every shard's
    owner-masked program in the one graph)."""
    from ..device import resolve_device
    from ..oram.round import oram_flush
    from .check_oblivious import oram_state
    from .fx_walk import capture, fake_inputs

    dev = resolve_device(device)
    mesh = None
    if shards > 1:
        from ..parallel.mesh import make_mesh

        mesh = make_mesh([dev] * shards)

    def build():
        st = oram_state(cfg, dev)
        if mesh is not None:
            from ..parallel.mesh import _shard_oram

            st = _shard_oram(st, mesh)
        return st

    return capture(lambda st: oram_flush(cfg, st, "xla", mesh), fake_inputs(build),
                   name="oram_flush")


def trace_engine_round(ecfg, device=None):
    from ..device import resolve_device
    from ..engine.round_step import engine_round_step
    from ..engine.state import init_engine
    from .check_oblivious import batch_spec, engine_draws
    from .fx_walk import capture, fake_inputs

    dev = resolve_device(device)

    def build():
        st = init_engine(ecfg, 0, device=dev)
        return st, batch_spec(ecfg, dev), engine_draws(ecfg, st, dev)

    return capture(lambda st, ba, dr: engine_round_step(ecfg, st, ba, draws=dr, fast_ok=True),
                   *fake_inputs(build), name="engine_round")


def trace_engine_flush(ecfg, device=None):
    from ..device import resolve_device
    from ..engine.round_step import engine_flush_step
    from ..engine.state import init_engine
    from .fx_walk import capture, fake_inputs

    dev = resolve_device(device)
    return capture(lambda st: engine_flush_step(ecfg, st),
                   fake_inputs(lambda: init_engine(ecfg, 0, device=dev)),
                   name="engine_flush")


def trace_expiry_sweep(ecfg, device=None):
    """The captured sweep, its chunk loop unrolled as the engine runs it."""
    from ..device import resolve_device
    from ..engine.expiry import expiry_sweep
    from ..engine.state import init_engine
    from .fx_walk import capture, fake_inputs

    dev = resolve_device(device)

    def build():
        return init_engine(ecfg, 0, device=dev), *(_zeros(1, dev)[0] for _ in range(3))

    return capture(lambda st, now, per, nh: expiry_sweep(ecfg, st, now, per, nh),
                   *fake_inputs(build), name="expiry_sweep")


# -- cross-validation: the two derivations must agree bit-exactly -------


def _compare(predicted: dict, traced: dict, context: str) -> dict:
    """Exact per-shape-class comparison; raises :class:`CostModelMismatch`
    with the first defect class. Returns the agreed rows."""
    diffs, kind = [], None
    for key in sorted(set(predicted) | set(traced), key=repr):
        pg, ps = predicted.get(key, (0, 0))
        tg, ts = traced.get(key, (0, 0))
        if (pg, ps) == (tg, ts):
            continue
        if pg < tg:
            kind = kind or "gather-undercount"
        elif pg > tg:
            kind = kind or "gather-overcount"
        elif ps < ts:
            kind = kind or "scatter-undercount"
        else:
            kind = kind or "scatter-overcount"
        diffs.append(f"  shape {key}: model (g={pg}, s={ps}) != trace (g={tg}, s={ts})")
    if diffs:
        raise CostModelMismatch(f"{context}: the analytic cost model and the traced census "
                                "disagree on rows:\n" + "\n".join(diffs), kind=kind)
    return predicted


def cross_validate_round(cfg, b: int, *, device=None, cap=None, _corrupt=None) -> dict:
    """One ``oram_round``: analytic rows == traced rows per shape class.
    ``cap`` a capture of that round (else one is made); ``_corrupt`` is
    the mutant hook (a transform of the predicted rows)."""
    pred = oram_round_rows(cfg, b)
    if _corrupt is not None:
        pred = _corrupt(pred)
    cap = cap if cap is not None else trace_oram_round(cfg, b, device)
    return _compare(predicted_access_rows(pred), traced_access_rows(cap, oram_planes(cfg)),
                    f"oram_round(b={b}, plen={cfg.path_len}, k={cfg.top_cache_levels}, "
                    f"E={cfg.evict_window}, recursive={cfg.posmap is not None})")


def cross_validate_flush(cfg, *, device=None, cap=None, _corrupt=None) -> dict:
    """One ``oram_flush``: analytic == traced, plus the arithmetic
    identity of :func:`flush_target_rows` against the shipped
    ``round.flush_target_slots``."""
    from ..oram.round import flush_target_slots

    t_model = flush_target_rows(cfg)
    if _corrupt is None and t_model != flush_target_slots(cfg):
        raise CostModelMismatch(f"flush_target_rows={t_model} != shipped "
                                f"flush_target_slots={flush_target_slots(cfg)}",
                                kind="arithmetic")
    pred = oram_flush_rows(cfg)
    if _corrupt is not None:
        pred = _corrupt(pred)
    cap = cap if cap is not None else trace_oram_flush(cfg, device)
    return _compare(predicted_access_rows(pred), traced_access_rows(cap, oram_planes(cfg)),
                    f"oram_flush(E={cfg.evict_window}, F={cfg.evict_fetch_count}, "
                    f"t={t_model}, recursive={cfg.posmap is not None})")


def cross_validate_sharded_flush(cfg, shards: int, *, device=None, cap=None,
                                 _corrupt=None) -> dict:
    """One owner-masked sharded ``oram_flush`` on a virtual mesh: the
    shard-local analytic rows (:func:`shard_local_rows`) against the
    captured graph. A model that prices each shard's scatter at its owned
    share (t / shards) fails as a scatter-undercount."""
    t = flush_target_rows(cfg)
    n_local = cfg.n_buckets_padded // shards
    # shape classes are exact only while no private array has a local
    # plane's leading dim
    if t in (n_local, n_local + 1) or cfg.evict_buffer_slots in (n_local, n_local + 1):
        raise ValueError(f"sharded-flush audit geometry ambiguity: t={t}, buffer="
                         f"{cfg.evict_buffer_slots} vs n_local={n_local}")
    local = shard_local_rows(oram_flush_rows(cfg), shards)
    pred = _corrupt(local) if _corrupt is not None else local
    planes = {name: (pr.shape, pr.divisor) for name, pr in local.items()}
    cap = cap if cap is not None else trace_oram_flush(cfg, device, shards)
    return _compare(predicted_access_rows(pred), traced_access_rows(cap, planes),
                    f"sharded_oram_flush(shards={shards}, E={cfg.evict_window}, "
                    f"F={cfg.evict_fetch_count}, t={t}, n_local={n_local}, "
                    f"recursive={cfg.posmap is not None})")


def cross_validate_engine_round(ecfg, *, device=None, cap=None, _corrupt=None) -> dict:
    """One engine round (rounds A+B+C): mailbox twice at ``B·D``, records
    once at ``B``, against the captured ``engine_round_step``."""
    pred = engine_round_rows(ecfg)
    if _corrupt is not None:
        pred = _corrupt(pred)
    cap = cap if cap is not None else trace_engine_round(ecfg, device)
    return _compare(predicted_access_rows(pred), traced_access_rows(cap, engine_planes(ecfg)),
                    f"engine_round(B={ecfg.batch_size}, D={ecfg.mb_choices}, "
                    f"E={ecfg.evict_every})")


def cross_validate_engine_flush(ecfg, *, device=None, cap=None, _corrupt=None) -> dict:
    pred = engine_flush_rows(ecfg)
    if _corrupt is not None:
        pred = _corrupt(pred)
    cap = cap if cap is not None else trace_engine_flush(ecfg, device)
    return _compare(predicted_access_rows(pred), traced_access_rows(cap, engine_planes(ecfg)),
                    f"engine_flush(E={ecfg.evict_every})")


def sweep_predicted_rows(ecfg, rows: dict | None = None) -> dict:
    """The analytic sweep in plane-shape space: a read pass over every
    chunked plane, a write pass over each plane the passes write back
    (all but the nonces, re-keyed by one broadcast store)."""
    chunk = {**sweep_chunk_planes(ecfg.rec, "rec_"), **sweep_chunk_planes(ecfg.mb, "mb_")}
    rows = expiry_sweep_rows(ecfg) if rows is None else rows
    predicted: dict = {}
    for name, (shape, _) in chunk.items():
        pr = rows.get(name)
        if pr is None:
            continue
        g, s = predicted.get(tuple(shape), (0, 0))
        writes = 0 if name.endswith("nonces") else pr.scatter_rows
        predicted[tuple(shape)] = (g + pr.gather_rows, s + writes)
    return predicted


def cross_validate_sweep(ecfg, *, device=None, cap=None, _corrupt=None) -> dict:
    """The expiry sweep: per plane-shape class, the chunk passes stream
    one full read pass over each tree plane and one write pass over the
    slot/value/leaf planes (the nonce re-key is priced in the ledger)."""
    rows = expiry_sweep_rows(ecfg)
    if _corrupt is not None:
        rows = _corrupt(rows)
    chunk = {**sweep_chunk_planes(ecfg.rec, "rec_"), **sweep_chunk_planes(ecfg.mb, "mb_")}
    cap = cap if cap is not None else trace_expiry_sweep(ecfg, device)
    return _compare(sweep_predicted_rows(ecfg, rows), traced_scan_rows(cap, chunk),
                    "expiry_sweep")


# -- knob A/B verdicts (the model's picks) ------------------------------


def machinery_oram_cfg(cap_n: int, b: int, *, k: int = 0, e: int = 1):
    """The records-shaped single-ORAM geometry the machinery A/Bs price
    (density-2 payload shape, 64-word values, cipher on): the reference's
    ``costmodel.py:981``."""
    from ..oram.path_oram import OramConfig, derive_evict_buffer_slots

    height = max(1, cap_n.bit_length() - 2)
    return OramConfig(
        height=height, value_words=64, n_blocks=cap_n, cipher_rounds=8,
        stash_size=max(96, b // 2 + 96), top_cache_levels=min(k, height), evict_window=e,
        evict_fetch_count=b if e > 1 else 0,
        evict_buffer_slots=derive_evict_buffer_slots(cap_n, e, b, 4) if e > 1 else 0,
    )


def sweep_engine_ecfg(batch: int, *, cap_log2: int = 12, recipients_log2: int = 9,
                      mailbox_cap: int = 8, **knobs):
    """The engine geometry the whole-round sweeps price."""
    from ..config import GrapevineConfig
    from ..engine.state import EngineConfig

    return EngineConfig.from_config(GrapevineConfig(
        max_messages=1 << cap_log2, max_recipients=1 << recipients_log2, batch_size=batch,
        mailbox_cap=mailbox_cap, stash_size=max(128, batch // 2 + 96), tree_density=2,
        **knobs))


#: arms whose modeled bytes sit within this fraction of the best arm are a
#: byte-tie: the verdict then prefers the arm with less machinery
TIE_BAND = 0.02


def _pick(arms: dict, order) -> str:
    """argmin bytes with the tie band: among arms within TIE_BAND of the
    minimum, the first in ``order`` (least machinery) wins."""
    best = min(arms[a]["modeled_bytes"] for a in arms)
    for a in order:
        if arms[a]["modeled_bytes"] <= best * (1.0 + TIE_BAND):
            return a
    raise AssertionError("unreachable: some arm attains the minimum")


def ab_verdict(kind: str, *, scope: str = "machinery", cap_n: int = 65536, batch: int = 256,
               arms=None, backend: str = "cpu", shards: int = 1) -> dict:
    """The model's pick for one knob A/B, a pure function of geometry
    (the reference's ``costmodel.py:1061``): modeled amortized bytes with
    the :data:`TIE_BAND` preference for less machinery. ``sort`` and
    ``pipeline`` swap machinery without changing plane traffic, so their
    verdicts are structural (``basis`` says so)."""
    out: dict = {"kind": kind, "scope": scope, "arms": {}}
    if kind == "tree_cache":
        ks = tuple(arms) if arms else (0, 2, 4, 8)
        for k in ks:
            if scope == "machinery":
                nbytes = oram_steady_bytes(machinery_oram_cfg(cap_n, batch, k=k), batch)
            else:
                nbytes = engine_cost_ledger(sweep_engine_ecfg(
                    batch, tree_top_cache_levels=k)).steady_round_bytes
            out["arms"][f"k{k}"] = {"modeled_bytes": int(nbytes)}
        out["winner"] = _pick(out["arms"], [f"k{k}" for k in ks])
        out["basis"] = ("each cached level converts B device path rows a plane to private "
                        "rows both directions; bytes fall monotonically in k, so the "
                        "deepest arm wins unless the cut is inside the tie band")
    elif kind == "evict":
        es = tuple(arms) if arms else (1, 2, 4, 8)
        for e in es:
            if scope == "machinery":
                nbytes = oram_steady_bytes(machinery_oram_cfg(cap_n, batch, e=e), batch)
            else:
                nbytes = engine_cost_ledger(sweep_engine_ecfg(
                    batch, evict_every=e)).steady_round_bytes
            out["arms"][f"e{e}"] = {"modeled_bytes": int(nbytes)}
        out["winner"] = _pick(out["arms"], [f"e{e}" for e in es])
        out["basis"] = ("amortized flush rows = min(E·F·path_len, n_buckets)/E: below "
                        "saturation that equals the E=1 write-back exactly (a byte-tie, so "
                        "E=1 wins); past saturation the min clamps and larger E drops bytes")
    elif kind == "sharded_evict":
        es = tuple(arms) if arms else (1, 2, 4)
        out["shards"] = shards
        for e in es:
            nbytes = oram_sharded_steady_bytes(machinery_oram_cfg(cap_n, batch, e=e), batch,
                                               shards)
            out["arms"][f"e{e}"] = {"modeled_bytes": int(nbytes)}
        out["winner"] = _pick(out["arms"], [f"e{e}" for e in es])
        out["basis"] = ("per-shard bytes: gathers at the full uniform count, owner-masked "
                        "scatters partition over the shards; the shard count scales only "
                        "the scatter half, so the E verdict keeps the one-device structure")
    elif kind == "sort":
        out["arms"] = {"xla": {"model": "W·log2(W) compare sort"},
                       "radix": {"model": "ceil(key_bits/bpp) serial scatter passes over "
                                          "W keys"}}
        out["winner"] = "xla" if backend == "cpu" else "defer"
        out["basis"] = ("bytes-identical machinery swap: the CPU verdict is the compare sort; "
                        "on an accelerator the verdict defers to a measured A/B")
    elif kind == "pipeline":
        out["arms"] = {"depth1": {"model": "host + device serialized"},
                       "depth2": {"model": "max(host, device) overlap"}}
        out["winner"] = "depth2"
        out["basis"] = ("overlap is never negative: depth-2 throughput >= depth-1 whenever "
                        "the host collection window is nonzero")
    else:
        raise ValueError(f"unknown A/B kind {kind!r}")
    return out


# -- seeded undercount mutants (the checker's positive controls) --------

#: name -> (corruption of the predicted rows, validator context, expected kind)
_COST_MUTANTS: dict = {}


def _cost_mutant(name: str, context: str, kind: str):
    def deco(fn):
        _COST_MUTANTS[name] = (fn, context, kind)
        return fn
    return deco


def _scale_plane(rows, suffix, *, g=None, s=None):
    out = dict(rows)
    for name, pr in rows.items():
        if name.endswith(suffix):
            out[name] = dataclasses.replace(
                pr, gather_rows=pr.gather_rows if g is None else int(pr.gather_rows * g),
                scatter_rows=pr.scatter_rows if s is None else int(pr.scatter_rows * s))
    return out


@_cost_mutant("halve_fetch_rows", "round", "gather-undercount")
def _halve_fetch(rows):
    """A model that forgets half the fetched path."""
    return _scale_plane(rows, "tree_val", g=0.5)


@_cost_mutant("drop_recursive_nonce_regather", "round_recursive", "gather-undercount")
def _drop_nonce_regather(rows):
    """A model unaware the recursive leaf plane re-gathers the nonce plane
    for its own keystream."""
    return _scale_plane(rows, "nonces", g=0.5)


@_cost_mutant("forget_cache_planes", "round_cached", "gather-undercount")
def _forget_cache(rows):
    """A model that prices the cached top levels as free."""
    for suffix in ("cache_idx", "cache_val", "cache_leaf"):
        rows = _scale_plane(rows, suffix, g=0, s=0)
    return rows


@_cost_mutant("forget_writeback_half", "round", "scatter-undercount")
def _forget_writeback(rows):
    """A model that treats the E=1 round as fetch-only."""
    return {name: dataclasses.replace(pr, scatter_rows=0) for name, pr in rows.items()}


@_cost_mutant("halve_flush_targets", "flush", "scatter-undercount")
def _halve_flush(rows):
    """A model that halves the flush's deduplicated write set."""
    return _scale_plane(rows, "tree_val", s=0.5)


@_cost_mutant("halve_sharded_flush_scatter", "flush_sharded", "scatter-undercount")
def _halve_sharded_flush(rows):
    """A model that prices each shard's flush scatter at its owned share
    (t / shards): the owner mask bounds which rows land, never the
    uniform scatter every shard dispatches."""
    return _scale_plane(rows, "tree_val", s=0.5)


@_cost_mutant("forget_inner_posmap_round", "round_recursive", "gather-undercount")
def _forget_inner(rows):
    """A model that prices the recursive map's internal round as free."""
    return {name: dataclasses.replace(pr, gather_rows=0, scatter_rows=0)
            if "pm_" in name else pr for name, pr in rows.items()}


@_cost_mutant("forget_mailbox_double_round", "engine", "gather-undercount")
def _forget_mb_double(rows):
    """A model that counts the mailbox tree once per engine round (round
    A + round C missed)."""
    return {name: dataclasses.replace(pr, gather_rows=pr.gather_rows // 2,
                                      scatter_rows=pr.scatter_rows // 2)
            if name.startswith("mb_") else pr for name, pr in rows.items()}


@_cost_mutant("forget_sweep_value_pass", "sweep", "gather-undercount")
def _forget_sweep_val(rows):
    """A model that forgets the sweep streams the value planes."""
    return _scale_plane(rows, "tree_val", g=0, s=0)


def cost_mutant_names() -> tuple:
    return tuple(_COST_MUTANTS)


def audit_oram_configs():
    """The trace-only knob matrix the gate cross-validates
    ``oram_round``/``oram_flush`` over: (name, cfg, b), spanning cache-k
    × posmap × evict_every, the reference's geometries. Batch sizes keep
    ``b·(path_len−k)`` off every padded bucket count and windows keep
    ``flush_target_rows`` below ``n_buckets_padded``, so shape-class
    attribution is exact."""
    from ..oram.path_oram import OramConfig
    from ..oram.posmap import derive_posmap_spec

    geo = dict(height=5, value_words=8, n_blocks=32)
    evict = dict(height=7, value_words=8, n_blocks=128, cipher_rounds=8, top_cache_levels=2,
                 evict_window=2, evict_fetch_count=8, evict_buffer_slots=64)
    return [
        ("flat_k0_e1", OramConfig(**geo, cipher_rounds=8, top_cache_levels=0), 8),
        ("flat_k2_e1", OramConfig(**geo, cipher_rounds=8, top_cache_levels=2), 8),
        ("flat_k2_e1_plaintext", OramConfig(**geo, top_cache_levels=2), 8),
        ("recursive_k2_e1", OramConfig(**geo, cipher_rounds=8, top_cache_levels=2,
                                       posmap=derive_posmap_spec(32, top_cache_levels=2)), 6),
        ("flat_k2_e2_fetch", OramConfig(**evict), 8),
        ("recursive_k2_e2_fetch", OramConfig(**evict, posmap=derive_posmap_spec(
            128, top_cache_levels=2, evict_window=2, evict_fetch_count=8)), 6),
    ]


def audit_sharded_flush_configs():
    """The sharded-flush geometries, flat and recursive, on a 2-shard
    virtual mesh: ``F=6`` keeps the dedup bound ``t = 2·6·8 = 96`` off the
    local bucket count."""
    from ..oram.path_oram import OramConfig
    from ..oram.posmap import derive_posmap_spec

    geo = dict(height=7, value_words=8, n_blocks=128, cipher_rounds=8, top_cache_levels=2,
               evict_window=2, evict_fetch_count=6, evict_buffer_slots=64)
    rec = OramConfig(**geo, posmap=derive_posmap_spec(128, top_cache_levels=2,
                                                      evict_window=2, evict_fetch_count=6))
    return [("sharded_flush_flat", OramConfig(**geo), 2), ("sharded_flush_recursive", rec, 2)]


def audit_engine_configs():
    """The engine geometries: E=1 (the joint round) and E=2 (fetch-only
    rounds and the flush), both trees' flush targets unsaturated."""
    from ..config import GrapevineConfig
    from ..engine.state import EngineConfig

    e1 = EngineConfig.from_config(GrapevineConfig(
        max_messages=1 << 8, max_recipients=1 << 7, batch_size=4))
    e2 = EngineConfig.from_config(GrapevineConfig(
        max_messages=1 << 8, max_recipients=1 << 8, batch_size=2, evict_every=2))
    return [("engine_e1", e1), ("engine_e2", e2)]


def _mutant_fixtures():
    """One trace-only geometry per validator context."""
    by_name = {name: (cfg, b) for name, cfg, b in audit_oram_configs()}
    engines = dict(audit_engine_configs())
    _, sh_cfg, sh_n = audit_sharded_flush_configs()[0]
    return {
        "round": (cross_validate_round, dict(zip(("cfg", "b"), by_name["flat_k0_e1"]))),
        "round_cached": (cross_validate_round, dict(zip(("cfg", "b"), by_name["flat_k2_e1"]))),
        "round_recursive": (cross_validate_round,
                            dict(zip(("cfg", "b"), by_name["recursive_k2_e1"]))),
        "flush": (cross_validate_flush, {"cfg": by_name["flat_k2_e2_fetch"][0]}),
        "flush_sharded": (cross_validate_sharded_flush, {"cfg": sh_cfg, "shards": sh_n}),
        "engine": (cross_validate_engine_round, {"ecfg": engines["engine_e1"]}),
        "sweep": (cross_validate_sweep, {"ecfg": engines["engine_e1"]}),
    }


class _MutantReport:
    """The report shape :func:`.mutants.control_failures` reads."""

    def __init__(self, findings):
        self.findings = findings


def run_cost_mutants(device=None) -> dict:
    """Run every undercount mutant through the cross-validator the gate
    runs; returns ``name -> (report, expected_kind, failed_as_expected)``.
    Each context's graph is captured once and shared by its mutants."""
    fixtures = _mutant_fixtures()
    graphs: dict = {}
    out = {}
    for name, (corrupt, context, kind) in _COST_MUTANTS.items():
        validator, kw = fixtures[context]
        if context not in graphs:
            graphs[context] = _trace_for(validator, kw, device)
        try:
            validator(**kw, device=device, cap=graphs[context], _corrupt=corrupt)
            findings, hit = [], False
        except CostModelMismatch as m:
            findings, hit = [m], m.kind == kind
        out[name] = (_MutantReport(findings), kind, hit)
    return out


def _trace_for(validator, kw: dict, device):
    """The capture ``validator`` checks at ``kw``'s geometry."""
    if validator is cross_validate_round:
        return trace_oram_round(kw["cfg"], kw["b"], device)
    if validator is cross_validate_flush:
        return trace_oram_flush(kw["cfg"], device)
    if validator is cross_validate_sharded_flush:
        return trace_oram_flush(kw["cfg"], device, kw["shards"])
    if validator is cross_validate_engine_round:
        return trace_engine_round(kw["ecfg"], device)
    if validator is cross_validate_engine_flush:
        return trace_engine_flush(kw["ecfg"], device)
    return trace_expiry_sweep(kw["ecfg"], device)


def _memo(trace):
    """Keep each fake capture by its geometry (configs are frozen
    dataclasses; ``repr`` is the key): the gate's identity matrix and its
    mutants cross-validate the same graphs."""
    import functools

    cache: dict = {}

    @functools.wraps(trace)
    def traced(*args, **kw):
        key = repr((args, sorted(kw.items())))
        if key not in cache:
            cache[key] = trace(*args, **kw)
        return cache[key]

    traced.cache = cache
    return traced


trace_oram_round = _memo(trace_oram_round)
trace_oram_flush = _memo(trace_oram_flush)
trace_engine_round = _memo(trace_engine_round)
trace_engine_flush = _memo(trace_engine_flush)
trace_expiry_sweep = _memo(trace_expiry_sweep)
