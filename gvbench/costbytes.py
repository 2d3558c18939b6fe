"""Bytes a round's path fetches and write-backs move, from a configuration's
sizes alone: a frozen copy of the program's cost-model arithmetic (the
analytic ledger of ``grapevine_tpu_torch/analysis/costmodel.py``), so a
change to the program cannot move the yardstick. ``test_gvbench_costbytes.py``
holds :func:`round_rows` and the ledger's bytes summed from it equal to
that ledger, and :func:`kernel_bytes` equal to a count over drawn paths.

Geometry, as the program derives it from its configuration: the records
tree has ``2**h`` leaves for ``max_messages`` blocks at ``tree_density``
blocks a leaf, and one bucket row holds ``Z`` slot ids and ``Z`` values of
``22 + payload_words`` words; the mailbox tree holds the recipient
table's buckets, ``mailbox_slots`` mailboxes of ``8 + 6 * mailbox_cap``
words each. The top ``k`` levels live in a private cache; a fetch reads
the other ``path_len - k`` levels of each path. One engine round is a
mailbox round of ``B * choices`` paths, a records round of ``B`` paths and
a second mailbox round.

The kernels' bytes (:func:`kernel_bytes`) take each plane's row width and
fetched rows from :func:`round_rows`, and count each byte the device's
memory has to serve once: each input byte read once and each output byte
written once, for paths whose leaves are uniform
(Path ORAM draws them so): a fetch reads each distinct bucket row with its
two-word nonce once and the public bucket id of every fetched row, and
writes every decrypted row; a write-back reads each fetched row's bucket
id and one-byte owner flag, and each owner's plaintext row, and writes
each distinct bucket row with its nonce once. (The ledger counts a row
that several paths share once a path, as the program addresses it; the
card's cache serves the repeats, so the ledger's bytes over the kernels'
time would read above the memory's peak.) Distinct rows at level ``l``
for ``b`` paths are ``2**l * (1 - (1 - 2**-l) ** b)``, their expectation.

A recursive position map (``posmap_impl: "recursive"``, upstream's
mechanism) leaves the two trees' geometry, and so :func:`kernel_bytes`,
as they are. It adds, as ``grapevine_tpu_torch/oram/posmap.py`` derives
them, one smaller internal tree a payload tree (:func:`posmap_trees`:
``entries_per_block`` positions packed into each internal block, the
internal round fetching as many paths as the payload round, on the
plain keystream) and a per-slot leaf plane beside each payload tree's
rows, ``Z`` words a bucket row, encrypted. :func:`posmap_bytes` counts
their bytes a round as :func:`kernel_bytes` counts the payload trees'.
Delayed eviction (``evict_every`` > 1) is outside this arithmetic.
"""

from __future__ import annotations

import math

WORD = 4
ENTRY_WORDS = 6
KEY_WORDS = 8
RECORD_HEAD_WORDS = 22
#: the program's cap on positions packed into one internal block (2**10)
#: and the internal trees' bucket slots, whatever the payload trees' Z
MAX_ENTRIES_PER_BLOCK_LOG2 = 10
INNER_Z = 4
MIN_RECURSIVE_BLOCKS = 8


def _log2_ceil(n: int) -> int:
    return math.ceil(math.log2(n))


def trees(engine: dict, record_size: int) -> dict:
    """The two trees' geometry and paths a round from a configuration's
    ``engine`` knobs: name -> dict(height, k, z, value_words, paths,
    rounds, encrypted, blocks); ``k`` is the cached top levels, ``blocks``
    the block space a position map covers. Refuses knobs the arithmetic
    does not cover."""
    if int(engine["evict_every"]) != 1:
        raise ValueError("the frozen arithmetic covers evict_every=1 rounds")
    if engine["posmap_impl"] not in ("flat", "recursive"):
        raise ValueError(f"unknown position map {engine['posmap_impl']!r}")
    density_shift = int(engine["tree_density"]).bit_length() - 1
    z = int(engine["bucket_slots"])
    b = int(engine["batch_size"])
    k_top = int(engine["tree_top_cache_levels"])
    encrypted = int(engine["bucket_cipher_rounds"]) > 0
    payload_words = (record_size - 88) // WORD
    rec_h = max(1, _log2_ceil(int(engine["max_messages"])) - density_shift)
    slots = max(1, int(engine["mailbox_slots"]))
    want = max(16, math.ceil(int(engine["max_recipients"])
                             / (slots * float(engine["mailbox_load"]))))
    table = 1 << max(1, _log2_ceil(want))
    mb_h = max(1, _log2_ceil(table) - density_shift)
    choices = int(engine["mailbox_choices"])
    return {
        "rec": dict(height=rec_h, k=min(k_top, rec_h), z=z, encrypted=encrypted,
                    value_words=RECORD_HEAD_WORDS + payload_words, paths=b, rounds=1,
                    blocks=int(engine["max_messages"])),
        "mb": dict(height=mb_h, k=min(k_top, mb_h), z=z, encrypted=encrypted,
                   value_words=slots * (KEY_WORDS + ENTRY_WORDS * int(engine["mailbox_cap"])),
                   paths=b * choices, rounds=2, blocks=table),
    }


def posmap_trees(engine: dict, record_size: int) -> dict:
    """The internal trees of a recursive position map, one a payload tree
    (none for the flat map): name -> dict(entries_per_block, blocks,
    height, k, z, value_words, paths, rounds, encrypted), with ``k`` the
    cached top levels as in :func:`trees`. ``entries_per_block`` is about
    the square root of the payload tree's blocks, at most ``2**10`` and
    halved while fewer than 4 internal blocks would hold them; two
    internal blocks a leaf; the internal round fetches as many paths as
    the payload tree's round."""
    if engine["posmap_impl"] != "recursive":
        return {}
    k_top = int(engine["tree_top_cache_levels"])
    out = {}
    for name, t in trees(engine, record_size).items():
        blocks = t["blocks"]
        if blocks < MIN_RECURSIVE_BLOCKS or blocks & (blocks - 1):
            raise ValueError(f"a recursive position map needs a power-of-two block space "
                             f">= {MIN_RECURSIVE_BLOCKS}, got {blocks}")
        k = 1 << max(1, min(MAX_ENTRIES_PER_BLOCK_LOG2, (blocks.bit_length() - 1) // 2))
        while blocks // k < 4:
            k >>= 1
        inner = blocks // k
        h = max(1, inner.bit_length() - 2)
        out[f"{name}_pm"] = dict(entries_per_block=k, blocks=inner, height=h,
                                 k=min(k_top, h), z=INNER_Z, value_words=k,
                                 paths=t["paths"], rounds=t["rounds"],
                                 encrypted=t["encrypted"])
    return out


def _fetched_rows(t: dict) -> int:
    return t["paths"] * (t["height"] + 1 - t["k"])


def round_rows(engine: dict, record_size: int) -> dict:
    """Rows per device-memory plane one engine round gathers and scatters:
    plane -> (row_words, gather_rows, scatter_rows), the cost model's
    ``engine_round_rows`` for the planes in device memory."""
    recursive = engine["posmap_impl"] == "recursive"
    ts = trees(engine, record_size)
    out = {}
    for name, t in {**ts, **posmap_trees(engine, record_size)}.items():
        r = _fetched_rows(t) * t["rounds"]
        z = t["z"]
        # a payload tree's leaf plane, whose keystream gathers the nonces a
        # second time
        leaf = recursive and name in ts
        out[f"{name}_tree_idx"] = (z, r, r)
        out[f"{name}_tree_val"] = (z * t["value_words"], r, r)
        out[f"{name}_nonces"] = (2, 2 * r if leaf else r, r if t["encrypted"] else 0)
        if leaf:
            out[f"{name}_tree_leaf"] = (z, r, r)
    return out


def distinct_rows(t: dict) -> float:
    """Expected distinct bucket rows among one fetch's paths."""
    b = t["paths"]
    return sum(2.0 ** lv * -math.expm1(b * math.log1p(-(2.0 ** -lv)))
               for lv in range(t["k"], t["height"] + 1))


def _path_bytes(ts: dict) -> dict:
    """Bytes the fetches and write-backs of the trees ``ts`` need in one
    engine round (see the module docstring)."""
    fetch = writeback = 0.0
    for t in ts.values():
        row = (t["z"] + t["z"] * t["value_words"]) * WORD
        nonce = 2 * WORD
        r = _fetched_rows(t)
        d = distinct_rows(t)
        fetch += t["rounds"] * (d * (row + nonce) + r * WORD + r * row)
        writeback += t["rounds"] * (r * (WORD + 1) + d * row + d * (row + nonce))
    return {"fetch": fetch, "writeback": writeback}


def kernel_bytes(engine: dict, record_size: int) -> dict:
    """Bytes one engine round's fetch kernels and write-back kernels need:
    {"fetch": ..., "writeback": ...} (see the module docstring)."""
    return _path_bytes(trees(engine, record_size))


def posmap_bytes(engine: dict, record_size: int) -> dict:
    """Bytes a recursive position map's work needs in one engine round,
    counted as :func:`kernel_bytes` counts: {"fetch", "writeback"} of the
    internal trees' paths, and "leaf_plane", the payload trees' leaf
    planes: each distinct leaf row read once and every fetched row's
    plaintext leaves written, then each owner's plaintext leaves read and
    each distinct leaf row written once. The bucket ids, the owner flags
    and the nonces the leaf plane's keystream takes are the payload
    fetch's own bytes, in :func:`kernel_bytes`. All 0 for the flat map."""
    out = _path_bytes(posmap_trees(engine, record_size))
    leaf = 0.0
    if engine["posmap_impl"] == "recursive":
        for t in trees(engine, record_size).values():
            row = t["z"] * WORD
            d = distinct_rows(t)
            leaf += t["rounds"] * (d * row + _fetched_rows(t) * row + 2 * d * row)
    out["leaf_plane"] = leaf
    return out


def tree_bytes(engine: dict, record_size: int) -> dict:
    """Resident bytes of each tree's row and nonce planes; under a
    recursive map also each internal tree's (``<tree>_pm``) and each
    payload tree's leaf plane (``<tree>_leaf``)."""
    out = {}
    ts = trees(engine, record_size)
    for name, t in {**ts, **posmap_trees(engine, record_size)}.items():
        n = 1 << (t["height"] + 1)
        out[name] = n * (t["z"] + t["z"] * t["value_words"] + 2) * WORD
    if engine["posmap_impl"] == "recursive":
        for name, t in ts.items():
            out[f"{name}_leaf"] = (1 << (t["height"] + 1)) * t["z"] * WORD
    return out
