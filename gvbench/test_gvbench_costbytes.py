"""The frozen byte arithmetic against the program's cost model: the rows a
round gathers and scatters per plane, and the ledger's fetch and write-back
bytes summed from them, equal ``grapevine_tpu_torch/analysis/costmodel.py``'s
at the cells' own sizes and at a small geometry, for both record sizes; and
the kernels' bytes the rooflines divide by, against a count over paths
drawn at random."""

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
knobs = json.loads(sys.argv[1])
ecfg = EngineConfig.from_config(GrapevineConfig(**knobs))
rows = {n: (pr.row_words, pr.gather_rows, pr.scatter_rows)
        for n, pr in costmodel.engine_round_rows(ecfg).items() if pr.hbm}
led = costmodel.engine_cost_ledger(ecfg)
print(json.dumps({"rows": rows, "fetch": led.phases["fetch"].hbm_bytes,
                  "writeback": led.phases["writeback"].hbm_bytes}))
"""

SMALL = dict(max_messages=2**14, max_recipients=2**10, batch_size=64)


@pytest.mark.parametrize("config,overrides", [
    ("bus_1kb", {}), ("bus_1kb", SMALL), ("bus_2kb", {}),
    ("bus_2kb", dict(SMALL, tree_top_cache_levels=2, mailbox_choices=1)),
])
def test_frozen_bytes_equal_the_cost_model(config, overrides):
    cfile = json.loads((ROOT / "gvbench" / "configs" / f"{config}.json").read_text())
    knobs = dict(cfile["engine"], **overrides)
    env = dict(os.environ, GRAPEVINE_RECORD_SIZE=str(cfile["record_size"]))
    out = subprocess.run([sys.executable, "-c", PROBE, json.dumps(knobs)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    model = json.loads(out.stdout.strip().splitlines()[-1])
    rows = costbytes.round_rows(knobs, cfile["record_size"])
    assert {k: list(v) for k, v in rows.items()} == model["rows"]
    fetch = sum(w * g * costbytes.WORD for w, g, _ in rows.values())
    writeback = sum(w * s * costbytes.WORD for w, _, s in rows.values())
    assert (fetch, writeback) == (model["fetch"], model["writeback"])


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
