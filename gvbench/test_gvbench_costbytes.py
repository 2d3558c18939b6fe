"""The frozen byte arithmetic against the program's cost model: the rows a
round gathers and scatters per plane, and the ledger's fetch and write-back
bytes summed from them, equal ``grapevine_tpu_torch/analysis/costmodel.py``'s
at the cells' own sizes and at a small geometry, for both record sizes and
both position maps; a recursive map's internal trees and leaf planes equal
the program's own geometry, keystream rows and resident bytes
(``oram/posmap.py``); the kernels' bytes the rooflines divide by, and the
recursive map's, against a count over paths drawn at random; and the
cells' bytes pinned where the rooflines have read them."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gvbench import costbytes

ROOT = Path(__file__).resolve().parent.parent

PROBE = r"""
import json, sys
from grapevine_tpu_torch.analysis import costmodel
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.oram.posmap import posmap_hbm_bytes
knobs = json.loads(sys.argv[1])
ecfg = EngineConfig.from_config(GrapevineConfig(**knobs))
rows = {n: (pr.row_words, pr.gather_rows, pr.scatter_rows)
        for n, pr in costmodel.engine_round_rows(ecfg).items() if pr.hbm}
led = costmodel.engine_cost_ledger(ecfg)
pm = {name: [s.entries_per_block, s.inner_blocks, s.inner_height, s.inner_top_cache_levels,
             s.inner_bucket_slots, s.inner_cipher_rounds > 0]
      for name, s in (("rec_pm", ecfg.rec.posmap), ("mb_pm", ecfg.mb.posmap)) if s is not None}
print(json.dumps({"rows": rows, "fetch": led.phases["fetch"].hbm_bytes,
                  "writeback": led.phases["writeback"].hbm_bytes,
                  "cipher_rows": led.phases["fetch"].cipher_rows
                  + led.phases["writeback"].cipher_rows,
                  "pm": pm, "pm_hbm": {"rec": posmap_hbm_bytes(ecfg.rec),
                                       "mb": posmap_hbm_bytes(ecfg.mb)}}))
"""

SMALL = dict(max_messages=2**14, max_recipients=2**10, batch_size=64)
TINY = dict(max_messages=2**10, max_recipients=2**7, batch_size=32)
RECURSIVE = dict(posmap_impl="recursive")


@pytest.mark.parametrize("config,overrides", [
    ("bus_1kb", {}), ("bus_1kb", SMALL), ("bus_2kb", {}),
    ("bus_2kb", dict(SMALL, tree_top_cache_levels=2, mailbox_choices=1)),
    ("bus_1kb", RECURSIVE), ("bus_1kb", dict(TINY, **RECURSIVE)), ("bus_2kb", RECURSIVE),
    ("bus_2kb", dict(SMALL, tree_top_cache_levels=2, mailbox_choices=1, **RECURSIVE)),
])
def test_frozen_bytes_equal_the_cost_model(config, overrides):
    cfile = json.loads((ROOT / "gvbench" / "configs" / f"{config}.json").read_text())
    knobs = dict(cfile["engine"], **overrides)
    rs = cfile["record_size"]
    env = dict(os.environ, GRAPEVINE_RECORD_SIZE=str(rs))
    out = subprocess.run([sys.executable, "-c", PROBE, json.dumps(knobs)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    model = json.loads(out.stdout.strip().splitlines()[-1])
    rows = costbytes.round_rows(knobs, rs)
    assert {k: list(v) for k, v in rows.items()} == model["rows"]
    fetch = sum(w * g * costbytes.WORD for w, g, _ in rows.values())
    writeback = sum(w * s * costbytes.WORD for w, _, s in rows.values())
    assert (fetch, writeback) == (model["fetch"], model["writeback"])
    # the internal trees' geometry, and the keystream rows a round: each
    # fetched row decrypted and encrypted back, a payload tree's leaf plane
    # a second stream under the recursive map
    recursive = knobs["posmap_impl"] == "recursive"
    pm = costbytes.posmap_trees(knobs, rs)
    assert {n: [t["entries_per_block"], t["blocks"], t["height"], t["k"], t["z"],
                t["encrypted"]] for n, t in pm.items()} == model["pm"]
    streams = 2 if recursive else 1
    cipher = sum(2 * t["rounds"] * t["paths"] * (t["height"] + 1 - t["k"]) * s
                 for ts, s in ((costbytes.trees(knobs, rs), streams), (pm, 1))
                 for t in ts.values())
    assert cipher == model["cipher_rows"]
    tb = costbytes.tree_bytes(knobs, rs)
    for tree in ("rec", "mb"):
        added = tb[f"{tree}_pm"] + tb[f"{tree}_leaf"] if recursive else 0
        assert added == model["pm_hbm"][tree]


def test_cell_geometry():
    for name, rec_rows, rec_words, mb_rows, mb_words in (
            ("bus_1kb", 2**23, 1028, 2**16, 6084), ("bus_2kb", 2**22, 2052, 2**15, 6084)):
        cfile = json.loads((ROOT / "gvbench" / "configs" / f"{name}.json").read_text())
        t = costbytes.trees(cfile["engine"], cfile["record_size"])
        rec, mb = t["rec"], t["mb"]
        assert (1 << (rec["height"] + 1), rec["z"] * (1 + rec["value_words"])) == (rec_rows, rec_words)
        assert (1 << (mb["height"] + 1), mb["z"] * (1 + mb["value_words"])) == (mb_rows, mb_words)


def test_distinct_rows():
    t = dict(height=10, k=4, z=4, value_words=256, paths=1, rounds=1, encrypted=True)
    assert costbytes.distinct_rows(t) == pytest.approx(7.0)
    t["paths"] = 1 << 20
    assert costbytes.distinct_rows(t) == pytest.approx(sum(2**lv for lv in range(4, 11)),
                                                       rel=1e-9)
    t["paths"] = 2048
    assert 0 < costbytes.distinct_rows(t) < 2048 * 7


@pytest.mark.parametrize("config", ["bus_1kb", "bus_2kb"])
def test_kernel_bytes_against_drawn_paths(config):
    """The kernels' bytes at a small geometry against the mean over drawn
    rounds of an exact count: every path a uniform leaf, each bucket a
    level ``leaf >> (height - level)``; distinct buckets read and written
    with their two-word nonce once, every fetched row's id read and its
    plaintext row written, every fetched row's id and owner flag read."""
    cfile = json.loads((ROOT / "gvbench" / "configs" / f"{config}.json").read_text())
    knobs = dict(cfile["engine"], **SMALL, tree_top_cache_levels=2)
    rs = cfile["record_size"]
    value_words = {"rec": 22 + (rs - 88) // 4, "mb": 4 * (8 + 6 * 62)}
    rng = np.random.default_rng(7)
    trials = 400
    fetch = writeback = 0.0
    for name, t in costbytes.trees(knobs, rs).items():
        row = 4 * (t["z"] + t["z"] * value_words[name])
        levels = range(t["k"], t["height"] + 1)
        for _ in range(trials * t["rounds"]):
            leaves = rng.integers(0, 1 << t["height"], t["paths"])
            distinct = sum(len(np.unique(leaves >> (t["height"] - lv))) for lv in levels)
            fetched = t["paths"] * len(levels)
            fetch += distinct * (row + 8) + fetched * (4 + row)
            writeback += fetched * 5 + distinct * (2 * row + 8)
    want = costbytes.kernel_bytes(knobs, rs)
    assert fetch / trials == pytest.approx(want["fetch"], rel=2e-3)
    assert writeback / trials == pytest.approx(want["writeback"], rel=2e-3)


@pytest.mark.parametrize("config", ["bus_1kb", "bus_2kb"])
def test_posmap_bytes_against_drawn_paths(config):
    """A recursive map's bytes at a small geometry against the mean over
    drawn rounds of an exact count, as for the kernels' bytes: each
    internal tree's paths as a tree's, and each payload tree's leaf plane
    (Z words a bucket row) read and written at its distinct rows once,
    every fetched row's plaintext leaves written and each owner's read."""
    cfile = json.loads((ROOT / "gvbench" / "configs" / f"{config}.json").read_text())
    knobs = dict(cfile["engine"], **SMALL, tree_top_cache_levels=2, **RECURSIVE)
    rs = cfile["record_size"]
    rng = np.random.default_rng(11)
    trials = 400
    got = {"fetch": 0.0, "writeback": 0.0, "leaf_plane": 0.0}
    pm = costbytes.posmap_trees(knobs, rs)
    for ts, inner in ((costbytes.trees(knobs, rs), False), (pm, True)):
        for t in ts.values():
            levels = range(t["k"], t["height"] + 1)
            for _ in range(trials * t["rounds"]):
                leaves = rng.integers(0, 1 << t["height"], t["paths"])
                distinct = sum(len(np.unique(leaves >> (t["height"] - lv))) for lv in levels)
                fetched = t["paths"] * len(levels)
                if inner:
                    row = 4 * t["z"] * (1 + t["entries_per_block"])
                    got["fetch"] += distinct * (row + 8) + fetched * (4 + row)
                    got["writeback"] += fetched * 5 + distinct * (2 * row + 8)
                else:
                    leaf = 4 * t["z"]
                    got["leaf_plane"] += (distinct + fetched + 2 * distinct) * leaf
    want = costbytes.posmap_bytes(knobs, rs)
    for key in got:
        assert got[key] / trials == pytest.approx(want[key], rel=2e-3)


def test_the_flat_map_adds_nothing():
    cfile = json.loads((ROOT / "gvbench" / "configs" / "bus_1kb.json").read_text())
    assert costbytes.posmap_trees(cfile["engine"], 1024) == {}
    assert costbytes.posmap_bytes(cfile["engine"], 1024) == {
        "fetch": 0.0, "writeback": 0.0, "leaf_plane": 0.0}


@pytest.mark.parametrize("config,fetch,writeback,trees", [
    ("bus_1kb", 3486178486.3382874, 1866809313.4418242, {"rec": 34561064960, "mb": 1595408384}),
    ("bus_2kb", 3326585287.919931, 1661305510.9541664, {"rec": 34460401664, "mb": 797704192}),
])
def test_the_cells_bytes_stay_as_the_rooflines_read_them(config, fetch, writeback, trees):
    """The bytes the cells' rooflines have divided by, and the trees'
    resident bytes, to the last bit; the recursive map moves neither the
    payload trees nor their kernels' bytes, and adds its internal trees
    (a 4,100-word row on bus_1kb's records map) and leaf planes."""
    cfile = json.loads((ROOT / "gvbench" / "configs" / f"{config}.json").read_text())
    rs = cfile["record_size"]
    for knobs in (cfile["engine"], dict(cfile["engine"], **RECURSIVE)):
        assert costbytes.kernel_bytes(knobs, rs) == {"fetch": fetch, "writeback": writeback}
        tb = costbytes.tree_bytes(knobs, rs)
        assert {k: tb[k] for k in trees} == trees
    if config == "bus_1kb":
        pm = costbytes.posmap_trees(dict(cfile["engine"], **RECURSIVE), rs)
        rec, mb = pm["rec_pm"], pm["mb_pm"]
        assert (rec["entries_per_block"], rec["blocks"], rec["height"], rec["k"]) == (
            1024, 8192, 12, 4)
        assert rec["z"] * (1 + rec["value_words"]) == 4100
        assert (mb["entries_per_block"], mb["blocks"], mb["height"], mb["k"]) == (256, 256, 7, 4)
        assert mb["z"] * (1 + mb["value_words"]) == 1028


def test_knobs_outside_the_arithmetic_are_refused():
    cfile = json.loads((ROOT / "gvbench" / "configs" / "bus_1kb.json").read_text())
    with pytest.raises(ValueError, match="evict_every=1"):
        costbytes.trees(dict(cfile["engine"], evict_every=4), 1024)
    with pytest.raises(ValueError, match="position map"):
        costbytes.trees(dict(cfile["engine"], posmap_impl="oblivious"), 1024)
    with pytest.raises(ValueError, match="power-of-two"):
        costbytes.posmap_trees(dict(cfile["engine"], max_messages=3 << 20, **RECURSIVE), 1024)
