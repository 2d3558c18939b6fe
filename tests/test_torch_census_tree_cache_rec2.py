"""The tree-top-cache census gate counts only operands derived from the
outer state's planes (``plane_rows(..., sources=...)``), where the
reference's shape-only attribution takes the internal map's planes for
the outer tree's."""

from __future__ import annotations

import pytest
from test_torch_census_posmap import reference_tool

from grapevine_tpu_torch.analysis import check_tree_cache_oblivious as ctc
from _torch_threads import one_torch_thread  # noqa: F401


def test_sources_keep_the_inner_tree_out():
    """At height 4 the internal map's planes share the outer planes'
    shapes: the reference's shape-only attribution counts the inner round
    as tree traffic and fails; the port counts only operands derived from
    the outer state's planes."""
    from grapevine_tpu_torch.oram.path_oram import OramConfig
    from grapevine_tpu_torch.oram.posmap import derive_posmap_spec

    with pytest.raises(AssertionError, match="k=0: tree_idx moves"):
        reference_tool("check_tree_cache_oblivious").check_tree_cache_schedule(
            b=4, height=4, recursive=True)
    cfg = OramConfig(height=4, value_words=8, n_blocks=16, cipher_rounds=8,
                     posmap=derive_posmap_spec(16, top_cache_levels=0))
    rows = ctc.round_accounting(cfg, 4, "cpu")["rows"]
    assert rows == {p: [20] for p in ("tree_idx", "tree_val", "nonces", "tree_leaf")}
