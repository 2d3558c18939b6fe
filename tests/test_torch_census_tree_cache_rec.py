"""The tree-top-cache census gate on a recursive map (the internal map's
own planes are not tree traffic of the outer tree), against the reference
tool at a small geometry; the reference's own geometry rides ``-m slow``."""

from __future__ import annotations

import pytest
from test_torch_census_posmap import reference_tool

from grapevine_tpu_torch.analysis import check_tree_cache_oblivious as ctc
from _torch_threads import one_torch_thread  # noqa: F401


def test_recursive_schedule_equals_the_reference_small():
    ref = reference_tool("check_tree_cache_oblivious").check_tree_cache_schedule(
        b=4, height=5, recursive=True)
    port = ctc.check_tree_cache_schedule(b=4, height=5, recursive=True, device="cpu")
    assert port == ref
    assert port["k2"]["tree_leaf"] == [16] and port["k2"]["cache_leaf"] == [8]


@pytest.mark.slow
def test_recursive_schedule_equals_the_reference():
    ref = reference_tool("check_tree_cache_oblivious").check_tree_cache_schedule(
        b=8, height=5, recursive=True)
    assert ctc.check_tree_cache_schedule(b=8, height=5, recursive=True, device="cpu") == ref
