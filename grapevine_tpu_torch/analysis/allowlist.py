"""The reviewed allowlist: every secret-indexed sink the port's engine is
allowed to contain, each with its one-line leak argument (counterpart of
the oblint half of ``grapevine_tpu/analysis/allowlist.py``).

Contract (enforced by :mod:`.check_oblivious`):

- any taint-flagged sink not listed here fails the audit;
- any entry never reached in the swept knob combinations fails the audit
  — dead entries rot into blanket permissions.

Entries are keyed ``aten_op@file.py:function`` (the op's overload packet
covers its overloads: ``aten.index_put`` is ``aten.index_put.default``);
a kernel node is keyed by its op (``gv.gather_decrypt_rows_tiled``) at
the call site of its wrapper. Each argument names the reference entry it
stands for ("ref ..."), or says why there is none. The standings are the
reference's, rooted in its threat model: the public transcript is the
HBM bucket-tree access sequence; the stash, position map, tree-top
cache, eviction buffer and per-round working set are private working
memory, whose *contents* are secret and whose access schedule is a
constant of the geometry (the census gates pin it).

1. one-time uniform paths: tree accesses indexed by leaves that are read
   once then remapped to fresh uniform draws;
2. private working memory: fixed-shape accesses into stash, map, cache
   and working rows;
3. oblivious permutation plumbing: sort/rank/scan data movement over
   fixed [B]/[W] arrays, every row moved exactly once per pass;
4. fixed full sweeps: walks that touch every row whatever the data.
"""

from __future__ import annotations

import dataclasses

from .oblint import AllowEntry

_A = AllowEntry

#: one ORAM access round (oram/round.py and everything under it)
_ORAM_CORE = (
    _A("aten.index", "oram/path_oram.py:_path_gather",
       "ref gather@oram/path_oram.py:_path_gather — path fetch indexed by "
       "one-time leaves: each position is read once then remapped, so every "
       "fetched path is an independent uniform draw (Path-ORAM invariant)"),
    _A("aten.index_put", "oram/path_oram.py:_path_scatter_",
       "ref scatter@oram/path_oram.py:_path_scatter — write-back of exactly "
       "the fetched paths, owner-masked: the write transcript is the read "
       "transcript"),
    _A("aten.index", "oram/path_oram.py:working_leaves",
       "ref gather@oram/path_oram.py:working_leaves — leaf lookup in the flat "
       "position table, private working memory, one fixed [W] gather a round"),
    _A("gv.gather_decrypt_rows", "oram/round.py:_fetch",
       "no ref entry (the reference's Pallas kernel sits inside its jaxpr): "
       "B3's address operand flat_b is the fetched paths' bucket ids, one-time "
       "uniform leaves as in _path_gather"),
    _A("gv.gather_decrypt_rows_tiled", "oram/round.py:_fetch",
       "no ref entry (a kernel op): B4's address operand flat_b is the fetched "
       "paths' bucket ids, one-time uniform leaves as in _path_gather"),
    _A("gv.scatter_encrypt_rows_tiled", "oram/round.py:_write_back",
       "no ref entry (a kernel op): B6 writes exactly the fetched paths, "
       "owner-masked (flat_b, owner), as _path_scatter_ does"),
    _A("aten.index", "oram/round.py:_fetch",
       "ref gather@oram/round.py:oram_round — owner-map and tree-top cache "
       "reads over the fetched paths: private planes, fixed [B·path_len] "
       "schedule"),
    _A("aten.index", "oram/round.py:_apply",
       "ref gather@oram/round.py:oram_round — private working-set reads "
       "(block->row map, initial-value rows) on a fixed per-round schedule"),
    _A("aten.index_put", "oram/round.py:_apply",
       "ref scatter@oram/round.py:oram_round — per-key commits into private "
       "working rows, fixed [B] shape, a spill row absorbing uncommitted ops"),
    _A("aten.index_put", "oram/round.py:oram_round",
       "ref scatter@oram/round.py:oram_round — eviction slots and tree-top "
       "cache write-back into private planes, unique in-bounds targets"),
    _A("aten.index_put", "oram/round.py:_recompact",
       "ref scatter@oram/round.py:oram_round and @oram_flush — stash / "
       "buffer recompaction by rank into fresh private planes, every kept "
       "row written once"),
    _A("aten.index_put", "oram/round.py:_working_leaf_plane",
       "ref scatter@oram/round.py:oram_round — committed rows take their "
       "key's fresh leaf in the private working leaf plane, fixed [B] shape"),
    _A("aten.scatter_reduce", "oram/round.py:_bucket_owner_map",
       "ref scatter@oram/round.py:_bucket_owner_map — owner election: one "
       "scatter-min over exactly B·path_len heap slots into a private map"),
    _A("aten.index", "oram/round.py:occurrence_masks_sorted",
       "ref gather@oram/round.py:occurrence_masks_sorted — sorted dedup: "
       "permutation/boundary gathers over fixed [B] arrays"),
    _A("aten.index", "oram/round.py:_assign_evictions",
       "ref gather@oram/round.py:_assign_evictions — sort-permutation and "
       "bucket-map gathers over the fixed working set (round and flush)"),
    _A("aten.scatter", "oram/round.py:_assign_evictions",
       "ref scatter@oram/round.py:_assign_evictions — inverse-permutation "
       "scatters over the fixed working set, every row written once"),
    _A("aten.index", "oram/round.py:_oram_fetch_round",
       "ref gather@oram/round.py:_oram_fetch_round — fetch-tag reads indexed "
       "by one-time uniform leaves and private working-set reads"),
    _A("aten.index_copy", "oram/round.py:_oram_fetch_round",
       "ref dynamic_update_slice@oram/round.py:_oram_fetch_round — window "
       "ledger append at the public round counter; flagged only under the "
       "recursive map's blanket state.posmap taint"),
    _A("aten.scatter_reduce", "oram/round.py:_oram_fetch_round",
       "ref scatter@oram/round.py:_oram_fetch_round — fetch-tag mark over "
       "exactly B·path_len one-time-leaf slots; no tree write"),
    _A("aten.index_put", "oram/round.py:oram_flush",
       "ref scatter@oram/round.py:oram_flush — flush write-back into exactly "
       "the window's fetched buckets plus private stash recompaction"),
)

#: position-map resolution (flat table and recursive internal ORAM)
_POSMAP = (
    _A("aten.index", "oram/posmap.py:lookup_remap_round",
       "ref gather@oram/posmap.py:lookup_remap_round — flat map read: private "
       "table, exactly one [B] gather a round"),
    _A("aten.index_put", "oram/posmap.py:lookup_remap_round",
       "ref scatter@oram/posmap.py:lookup_remap_round — flat map remap write, "
       "one [B] scatter a round, non-winners dropped"),
    _A("aten.gather", "oram/posmap.py:apply_pm",
       "ref gather@oram/posmap.py:apply_pm — recursive map entry extract "
       "inside the internal round's private working set"),
    _A("aten.index_put", "oram/posmap.py:apply_pm",
       "ref scatter@oram/posmap.py:apply_pm — recursive map entry writes onto "
       "committed internal rows, unique in-bounds targets"),
    _A("aten.index", "oram/posmap.py:_group_last_slot",
       "ref gather@oram/posmap.py:_group_last_slot — sorted last-occurrence "
       "dedup, permutation gathers over fixed [B] arrays"),
)

#: oblivious sort/scan machinery (bit-identity with the reference's is
#: pinned by tests/test_torch_radix.py and test_torch_segmented.py)
_SORTS = (
    _A("aten.gather", "oblivious/primitives.py:lex_argsort",
       "ref gather@oblivious/primitives.py:lex_argsort — two-pass stable "
       "64-bit argsort, every row moves once a pass"),
    _A("aten.index", "oblivious/radix.py:_rank_pass",
       "ref gather@oblivious/radix.py:_rank_pass — per-digit histogram reads, "
       "all B rows touched once a pass"),
    _A("aten.scatter", "oblivious/radix.py:_rank_pass",
       "ref scatter@oblivious/radix.py:_rank_pass — counting-sort one-hot "
       "scatter into a fixed bin table, every row once a pass"),
    _A("aten.index_put", "oblivious/radix.py:_passes",
       "ref scatter@oblivious/radix.py:radix_rank — rank-targeted permutation "
       "scatter over [B] after each pass"),
    _A("aten.index", "oblivious/radix.py:radix_group_sort",
       "ref gather@oblivious/radix.py:radix_group_sort — permutation gathers "
       "over fixed [B] arrays"),
    _A("aten.index_put", "oblivious/radix.py:radix_group_sort",
       "ref scatter@oblivious/radix.py:radix_group_sort — inverse permutation "
       "of [B], every row written once"),
    _A("aten.index", "oblivious/segmented.py:multiword_group_sort",
       "ref gather@oblivious/segmented.py:group_sort — wide-key sort "
       "permutation gathers over fixed [B]"),
    _A("aten.index_put", "oblivious/segmented.py:multiword_group_sort",
       "ref scatter@oblivious/segmented.py:multiword_group_sort — inverse "
       "permutation scatter over fixed [B]"),
    _A("aten.index", "oblivious/segmented.py:segment_bounds",
       "no ref entry of that name (the reference derives segment bounds "
       "inside group_sort and its scans): first/last-of-segment reads by "
       "segment id over fixed [B]"),
    _A("aten.index_put", "oblivious/segmented.py:segment_bounds",
       "no ref entry of that name (as above): one segment-id-indexed write "
       "a row over fixed [B]"),
    _A("aten.index", "oblivious/segmented.py:segmented_sum_before",
       "ref gather@oblivious/segmented.py:segmented_sum_before — permutation "
       "-indexed scan boundary reads over fixed [B]"),
    _A("aten.index", "oblivious/segmented.py:segmented_sum_total",
       "ref gather@oblivious/segmented.py:segmented_sum_total — segment totals "
       "broadcast back by segment id over fixed [B]"),
)

#: slot-order semantics + admission (engine/vphases.py): per-op [B]
#: working rows, a per-round schedule that is a constant of the geometry
_VPHASES = (
    _A("aten.index", "engine/vphases.py:_admission_fast",
       "ref gather@engine/vphases.py:_admission_fast — rank/slot gathers over "
       "[B] counters in private working memory"),
    _A("aten.index", "engine/vphases.py:_admission_slow",
       "ref dynamic_slice@engine/vphases.py:step — the exact-admission walk's "
       "per-op counter reads by 1-element slot index, trip count B"),
    _A("aten.index_put", "engine/vphases.py:_admission_slow",
       "ref scatter@engine/vphases.py:step — the walk's per-op counter "
       "updates, private [B] state, fixed trip count B"),
    _A("aten.gather", "engine/vphases.py:apply_batch",
       "ref gather@engine/vphases.py:apply_batch — sorted-entry selection "
       "over the fixed [B, cap] working rows"),
    _A("aten.index", "engine/vphases.py:apply_batch",
       "ref gather@engine/vphases.py:apply_batch — same-key row gathers over "
       "the fixed [B] working set"),
    _A("aten.index_add", "engine/vphases.py:apply_batch",
       "ref scatter@engine/vphases.py:apply_batch — bucket-table aggregation "
       "over fixed [B·D] rows, every row added once"),
    _A("aten.index_put", "engine/vphases.py:apply_batch",
       "ref scatter@engine/vphases.py:apply_batch — chain commits into "
       "private working rows, unique in-bounds targets"),
    _A("aten.scatter_reduce", "engine/vphases.py:apply_batch",
       "ref scatter@engine/vphases.py:apply_batch — group min/max reductions "
       "over the fixed [B] working set"),
    _A("aten.index", "engine/vphases.py:select_by_rank",
       "ref gather@engine/vphases.py:select_by_rank — rank-indexed gather "
       "over fixed [B]"),
    _A("aten.index_put", "engine/vphases.py:select_by_rank",
       "ref scatter@engine/vphases.py:select_by_rank — rank scatter over "
       "fixed [B]"),
    _A("aten.index", "engine/vphases.py:group_first",
       "ref gather@engine/vphases.py:group_first — group-boundary gather over "
       "the sorted [B] slot order"),
    _A("aten.index", "engine/vphases.py:group_last",
       "ref gather@engine/vphases.py:group_last — group-boundary gather over "
       "the sorted [B] slot order"),
    _A("aten.index", "engine/vphases.py:first_flag_index",
       "ref gather@engine/vphases.py:first_flag_index — first-flag rank "
       "gather over fixed [B]"),
    _A("aten.index", "engine/vphases.py:last_flag_index",
       "ref gather@engine/vphases.py:last_flag_index — last-flag rank gather "
       "over fixed [B]"),
    _A("aten.index", "engine/vphases.py:_to",
       "ref gather@engine/vphases.py:_to — scan-impl permutation into sorted "
       "order, fixed [B]"),
    _A("aten.index", "engine/vphases.py:_back",
       "ref gather@engine/vphases.py:_back — scan-impl permutation out of "
       "sorted order, fixed [B]"),
)

#: engine round glue + expiry sweep
_ENGINE = (
    _A("aten.index_put", "engine/round_step.py:engine_round_step",
       "ref scatter@engine/round_step.py:engine_round_step — freed-block "
       "push: rank-compaction scatter into the private freelist, at most B "
       "unique in-bounds targets"),
    _A("aten.index_put", "engine/expiry.py:expiry_sweep",
       "ref scatter@engine/expiry.py:expiry_sweep — freelist rebuild by rank "
       "into the private table after the full-tree walk"),
    _A("aten.index_put", "engine/expiry.py:mark",
       "ref scatter@engine/expiry.py:rec_body (mark is its helper) — "
       "liveness bits by private block id into a private [max_messages] "
       "table; every tree row is visited on the fixed chunk schedule"),
)

#: the one reviewed list the gate sweeps (check_oblivious.py)
ENGINE_ALLOWLIST: tuple = _ORAM_CORE + _POSMAP + _SORTS + _VPHASES + _ENGINE



@dataclasses.dataclass(frozen=True)
class RangeEntry(AllowEntry):
    """One reviewed range site (:mod:`.rangelint`): ``wraps`` True for
    arithmetic that is mod 2^32 by definition (the result is any value of
    the lane); False for an invariant-backed site whose wrap cannot
    happen (the value then stays inside its interval and its lane)."""

    wraps: bool = True


_R = RangeEntry

#: Rangelint's reviewed allowlist (swept by :mod:`.check_ranges` with the
#: same dead-entry rule as the taint list): every intentionally mod-2^32
#: operation of the round, and each invariant-backed site, with its
#: one-line range argument and the reference entry it stands for
#: (``grapevine_tpu/analysis/allowlist.py:227-302``). Reference entries
#: with no port counterpart:
#:
#: - ``shift_left@oblivious/bucket_cipher.py:_rotl``,
#:   ``shift_left@engine/state.py:mb_bucket_hash`` and
#:   ``shift_left@oblivious/prp.py:_f``: every rotate of the port is
#:   ``u32.rotl``, which the domain reads as a rotation (its left shift
#:   loses no bit), so no rotate flags;
#: - ``reduce_sum@engine/vphases.py:apply_batch`` and ``:select_by_rank``:
#:   the port sums one-hot selects in int64 (no overflow) and narrows the
#:   sum, so its entries are the narrows (``aten._to_copy``) at the same
#:   sites;
#: - ``convert_element_type@oram/path_oram.py:_path_scatter``: the port's
#:   owner-masked scatter indexes with int64 (``widen``), which has no
#:   narrowing cast.
RANGE_ALLOWLIST: tuple = (
    # ChaCha (oblivious/bucket_cipher.py): ARX is arithmetic mod 2^32 by
    # RFC 7539 — the keystream is defined over the wrapped lanes
    _R("aten.add", "oblivious/bucket_cipher.py:_qr",
       "ref add@oblivious/bucket_cipher.py:_qr — ChaCha quarter-round addition is "
       "mod-2^32 by cipher definition"),
    _R("aten.add", "oblivious/bucket_cipher.py:chacha_blocks",
       "ref add@oblivious/bucket_cipher.py:chacha_blocks — the state+init "
       "feedforward of the ChaCha block function, mod-2^32 by RFC 7539"),
    _R("aten.add", "oblivious/bucket_cipher.py:epoch_next",
       "ref add@oblivious/bucket_cipher.py:epoch_next — u64 write epoch as (lo, hi) "
       "u32 lanes: lo wraps by design and the explicit carry feeds hi; the pair is "
       "the counter"),
    # u64 two-lane helpers (oblivious/primitives.py)
    _R("aten.add", "oblivious/primitives.py:u64_add_u32",
       "ref add@oblivious/primitives.py:u64_add_u32 — u64 carry arithmetic in u32 "
       "lanes: lo wraps mod 2^32, the comparison-derived carry moves the overflow "
       "into hi"),
    _R("aten.sub", "oblivious/primitives.py:u64_sub",
       "ref sub@oblivious/primitives.py:u64_sub — u64 borrow arithmetic in u32 "
       "lanes: lo wraps mod 2^32, the comparison-derived borrow moves the underflow "
       "into hi"),
    # keyed mixers: mb_bucket_hash and the Feistel PRP round function —
    # murmur-style ARX whose output is masked to the table/domain width
    _R("aten.mul", "engine/state.py:mb_bucket_hash",
       "ref mul@engine/state.py:mb_bucket_hash — keyed bucket-hash multiplies are "
       "mod-2^32 by design; the result is masked to the power-of-two table width"),
    _R("aten.add", "engine/state.py:mb_bucket_hash",
       "ref add@engine/state.py:mb_bucket_hash — keyed bucket-hash adds are mod-2^32 "
       "by design; the result is masked to the power-of-two table width"),
    _R("aten.mul", "oblivious/prp.py:_f",
       "ref mul@oblivious/prp.py:_f — Feistel round-function multiplies are mod-2^32 "
       "by design; the half is masked to its domain width after each round"),
    # invariant-backed sites: the wrap is impossible by a reviewed program
    # invariant an oracle-equality suite pins, which a non-relational
    # interval domain cannot express
    _R("aten.sub", "engine/round_step.py:engine_round_step",
       "ref sub@engine/round_step.py:engine_round_step — free_top - n_allocs: phase-A "
       "admission never allocates more blocks than the freelist holds (quota "
       "invariant, oracle-pinned)", wraps=False),
    _R("aten._to_copy", "engine/vphases.py:apply_batch",
       "ref reduce_sum@engine/vphases.py:apply_batch — narrow of masked one-hot row "
       "selects (at most one key matches per bucket, mailbox uniqueness invariant): "
       "the int64 sum IS the selected u32 row, never an accumulation", wraps=False),
    _R("aten._to_copy", "engine/vphases.py:select_by_rank",
       "ref reduce_sum@engine/vphases.py:select_by_rank — narrow of a rank-equality "
       "one-hot select: at most one lane of a group has rank q, so the int64 sum is a "
       "private row select", wraps=False),
    _R("aten.index_put", "engine/expiry.py:expiry_sweep",
       "ref add@oblivious/radix.py:_rank_pass — the freelist rebuild scatters by "
       "partition_rank: zeros-rank + ones-rank of one stable partition is a "
       "permutation of [0, n) (below n pointwise, 2n only in interval arithmetic)",
       wraps=False),
    _R("aten._to_copy", "engine/expiry.py:expiry_sweep",
       "ref add@oblivious/radix.py:_rank_pass — the same partition_rank positions "
       "widened to int64 indices: a permutation of [0, n), below 2^31 at every "
       "certified n (2^31 only in interval arithmetic)", wraps=False),
    _R("aten.index_put", "oblivious/radix.py:_passes",
       "ref add@oblivious/radix.py:_rank_pass — each counting pass scatters by its "
       "stable ranks, offset + within-bin rank: a permutation of [0, B) (below B "
       "pointwise, up to 2B only in interval arithmetic)", wraps=False),
    _R("aten.index", "oblivious/segmented.py:segment_bounds",
       "no ref entry (the reference takes a cummax/cummin): seg_id = cumsum(seg_start) "
       "- 1 reads its segment's ends; element 0 always starts a segment, so every "
       "seg_id is >= 0 (-1 only in interval arithmetic)", wraps=False),
    # the owner-masked sharded write-back (parallel/mesh.py): each shard
    # rebases global heap rows into its own range before the scatter
    _R("aten.sub", "oram/path_oram.py:_path_scatter_",
       "ref sub@oram/path_oram.py:_path_scatter — path_b - i*n_local rebase: rows "
       "another shard owns wrap mod 2^32 by construction, and the (loc >= 0) & "
       "(loc < n_local) & owner mask sends exactly those to the scratch row — a "
       "wrapped value is never a landing address"),
)
