"""The tree-top-cache census gate (``analysis/check_tree_cache_oblivious.py``)
against the reference tool (``tools/check_tree_cache_oblivious.py``): the
flat map's row accounting at k ∈ {0, 2} and the k=0 recursive cell, row for
row at the same geometry."""

from __future__ import annotations

from test_torch_census_posmap import reference_tool

from grapevine_tpu_torch.analysis import check_tree_cache_oblivious as ctc
from _torch_threads import one_torch_thread  # noqa: F401


def test_flat_schedule_equals_the_reference():
    ref = reference_tool("check_tree_cache_oblivious").check_tree_cache_schedule(b=8, height=5)
    port = ctc.check_tree_cache_schedule(b=8, height=5, device="cpu")
    assert port == ref
    assert port["k0"]["tree_val"] == [48]
    assert port["k2"]["tree_val"] == [32] and port["k2"]["cache_val"] == [16]
    assert "cache_idx" not in port["k0"]


def test_k0_recursive_cell_equals_the_reference():
    ref = reference_tool("check_tree_cache_oblivious").check_k0_recursive_census(b=4, height=5)
    port = ctc.check_k0_recursive_census(b=4, height=5, device="cpu")
    assert port == ref == {p: [24] for p in ("tree_idx", "tree_val", "nonces", "tree_leaf")}
