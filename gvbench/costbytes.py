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
"""

from __future__ import annotations

import math

WORD = 4
ENTRY_WORDS = 6
KEY_WORDS = 8
RECORD_HEAD_WORDS = 22


def _log2_ceil(n: int) -> int:
    return math.ceil(math.log2(n))


def trees(engine: dict, record_size: int) -> dict:
    """The two trees' geometry and paths a round from a configuration's
    ``engine`` knobs: name -> dict(height, k, z, value_words, paths,
    rounds, encrypted)."""
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
    if int(engine["evict_every"]) != 1:
        raise ValueError("the frozen arithmetic covers evict_every=1 rounds")
    if engine["posmap_impl"] != "flat":
        raise ValueError("the frozen arithmetic covers the flat position map")
    return {
        "rec": dict(height=rec_h, k=min(k_top, rec_h), z=z, encrypted=encrypted,
                    value_words=RECORD_HEAD_WORDS + payload_words, paths=b, rounds=1),
        "mb": dict(height=mb_h, k=min(k_top, mb_h), z=z, encrypted=encrypted,
                   value_words=slots * (KEY_WORDS + ENTRY_WORDS * int(engine["mailbox_cap"])),
                   paths=b * choices, rounds=2),
    }


def _fetched_rows(t: dict) -> int:
    return t["paths"] * (t["height"] + 1 - t["k"])


def round_rows(engine: dict, record_size: int) -> dict:
    """Rows per device-memory plane one engine round gathers and scatters:
    plane -> (row_words, gather_rows, scatter_rows), the cost model's
    ``engine_round_rows`` for the planes in device memory."""
    out = {}
    for name, t in trees(engine, record_size).items():
        r = _fetched_rows(t) * t["rounds"]
        z = t["z"]
        out[f"{name}_tree_idx"] = (z, r, r)
        out[f"{name}_tree_val"] = (z * t["value_words"], r, r)
        out[f"{name}_nonces"] = (2, r, r if t["encrypted"] else 0)
    return out


def distinct_rows(t: dict) -> float:
    """Expected distinct bucket rows among one fetch's paths."""
    b = t["paths"]
    return sum(2.0 ** lv * -math.expm1(b * math.log1p(-(2.0 ** -lv)))
               for lv in range(t["k"], t["height"] + 1))


def kernel_bytes(engine: dict, record_size: int) -> dict:
    """Bytes one engine round's fetch kernels and write-back kernels need:
    {"fetch": ..., "writeback": ...} (see the module docstring)."""
    rows = round_rows(engine, record_size)
    fetch = writeback = 0.0
    for name, t in trees(engine, record_size).items():
        idx_words, fetched, _ = rows[f"{name}_tree_idx"]
        row = (idx_words + rows[f"{name}_tree_val"][0]) * WORD
        nonce = rows[f"{name}_nonces"][0] * WORD
        r = fetched // t["rounds"]
        d = distinct_rows(t)
        fetch += t["rounds"] * (d * (row + nonce) + r * WORD + r * row)
        writeback += t["rounds"] * (r * (WORD + 1) + d * row + d * (row + nonce))
    return {"fetch": fetch, "writeback": writeback}


def tree_bytes(engine: dict, record_size: int) -> dict:
    """Resident bytes of each tree's row and nonce planes."""
    out = {}
    for name, t in trees(engine, record_size).items():
        n = 1 << (t["height"] + 1)
        out[name] = n * (t["z"] + t["z"] * t["value_words"] + 2) * WORD
    return out
