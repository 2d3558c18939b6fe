"""Plain-Python Path ORAM mirror: independent double-entry bookkeeping
(the port's own copy of ``grapevine_tpu/testing/ref_oram.py``).

Implements the *same algorithm* as ``oram/path_oram.py:oram_access``
(same eviction policy, same insertion slot choice, same stash compaction
order) with dicts and loops instead of vector ops. Given the same inputs
(block index, fresh leaf, operation) it must produce bit-identical public
transcripts and results — the build's strongest correctness check
(SURVEY.md §4: "access-pattern transcripts bit-identical to a CPU
reference implementation"). Any divergence means one of the two
implementations mis-translates the algorithm.

Kept deliberately naive: readability over speed.
"""

from __future__ import annotations

import dataclasses

from ..oram.path_oram import OramConfig

_SENTINEL = 0xFFFFFFFF


@dataclasses.dataclass
class _Slot:
    idx: int = _SENTINEL
    leaf: int = 0
    val: tuple = ()


class RefPathOram:
    """Reference Path ORAM over Python lists. Same API shape, scalar ops."""

    def __init__(self, cfg: OramConfig, posmap_init: list[int]):
        self.cfg = cfg
        self.tree: list[list[_Slot]] = [
            [_Slot() for _ in range(cfg.bucket_slots)] for _ in range(cfg.n_buckets)
        ]
        self.stash: list[_Slot] = [_Slot() for _ in range(cfg.stash_size)]
        assert len(posmap_init) == cfg.blocks + 1
        self.posmap = list(posmap_init)
        self.overflow = 0

    def path_buckets(self, leaf: int) -> list[int]:
        cfg = self.cfg
        return [
            ((1 << d) - 1) + (leaf >> (cfg.height - d)) for d in range(cfg.path_len)
        ]

    def access(self, idx: int, new_leaf: int, fn):
        """fn(value_tuple, present) -> (new_value_tuple, keep, insert, out)."""
        cfg = self.cfg
        leaf = self.posmap[idx]
        self.posmap[idx] = new_leaf
        path = self.path_buckets(leaf)

        # working set: stash first, then path slots in bucket order —
        # identical ordering to the vectorized concatenate
        work: list[_Slot] = [dataclasses.replace(s) for s in self.stash]
        for b in path:
            work.extend(dataclasses.replace(s) for s in self.tree[b])

        present = False
        value = (0,) * cfg.value_words
        for s in work:
            if s.idx != _SENTINEL and s.idx == idx:
                present = True
                value = s.val

        new_value, keep, insert, out = fn(value, present)

        for s in work:
            if s.idx != _SENTINEL and s.idx == idx:
                s.val = new_value
                s.leaf = new_leaf
                if not keep:
                    s.idx = _SENTINEL

        if insert and not present and idx != cfg.dummy_index:
            placed = False
            for s in work:
                if s.idx == _SENTINEL:
                    s.idx, s.leaf, s.val = idx, new_leaf, new_value
                    placed = True
                    break
            if not placed:
                self.overflow += 1

        # greedy deepest-first eviction, rank order = working-set order
        def depth_of(l: int) -> int:
            d = 0
            for j in range(1, cfg.height + 1):
                if (l >> (cfg.height - j)) == (leaf >> (cfg.height - j)):
                    d += 1
            return d

        assign: dict[int, list[_Slot]] = {lvl: [] for lvl in range(cfg.path_len)}
        leftovers: list[_Slot] = []
        placed_ids = set()
        for level in range(cfg.height, -1, -1):
            for i, s in enumerate(work):
                if i in placed_ids or s.idx == _SENTINEL:
                    continue
                if depth_of(s.leaf) >= level and len(assign[level]) < cfg.bucket_slots:
                    assign[level].append(s)
                    placed_ids.add(i)
        for i, s in enumerate(work):
            if i not in placed_ids and s.idx != _SENTINEL:
                leftovers.append(s)

        # write back path
        for lvl, b in enumerate(path):
            bucket = [dataclasses.replace(s) for s in assign[lvl]]
            while len(bucket) < cfg.bucket_slots:
                bucket.append(_Slot())
            self.tree[b] = bucket

        # compact leftovers into the stash
        self.stash = [_Slot() for _ in range(cfg.stash_size)]
        for i, s in enumerate(leftovers):
            if i < cfg.stash_size:
                self.stash[i] = s
            else:
                self.overflow += 1

        return out, leaf

    def stash_occupancy(self) -> int:
        return sum(1 for s in self.stash if s.idx != _SENTINEL)
