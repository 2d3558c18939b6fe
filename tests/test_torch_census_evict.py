"""The delayed-eviction half of the tree-cache census gate against the
reference tool: fetch rounds read-only on the trees, a flush writing
``flush_target_slots`` rows a plane and reading none."""

from __future__ import annotations

import pytest
from test_torch_census_posmap import reference_tool

from grapevine_tpu_torch.analysis import check_tree_cache_oblivious as ctc
from _torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("recursive", [False, True])
def test_evict_accounting_equals_the_reference(recursive):
    ref = reference_tool("check_tree_cache_oblivious").check_evict_round_accounting(
        b=8, height=7, k=2, window=2, recursive=recursive)
    port = ctc.check_evict_round_accounting(b=8, height=7, k=2, window=2,
                                            recursive=recursive, device="cpu")
    assert port == ref
    assert port["want_flush_rows"] == 128 and port["fetch"]["tree_val"] == [48]
