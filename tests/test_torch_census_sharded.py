"""The sharded half of the tree-cache census gate against the reference
tool: the per-shard shapes on a 2-shard virtual mesh; at run time the
owner partition holds and the seeded unmasked-scatter mutant is caught."""

from __future__ import annotations

import pytest
from test_torch_census_posmap import reference_tool

from grapevine_tpu_torch.analysis import check_tree_cache_oblivious as ctc
from _torch_threads import one_torch_thread  # noqa: F401


def test_sharded_trace_accounting_equals_the_reference():
    """The reference's one-chip ``shard_map`` body against one shard of the
    port's virtual mesh: the same per-shard rows (the port's local plane
    carries a scratch row, ``[n/2 + 1, ·]``)."""
    import os

    flags = os.environ.get("XLA_FLAGS", "")
    assert "xla_force_host_platform_device_count" in flags  # tests/conftest.py
    ref = reference_tool("check_tree_cache_oblivious").check_sharded_evict_accounting(
        runtime=False)
    port = ctc.check_sharded_evict_accounting(runtime=False, device="cpu")
    assert port == ref
    assert port["shards"] == 2 and port["flush"]["nonces"] == [96]


def test_owner_partition_holds_at_run_time():
    out = ctc.check_sharded_evict_accounting(runtime=True, device="cpu")
    assert sum(out["per_shard_written"]) == out["oracle_written"] > 0
    assert all(n > 0 for n in out["per_shard_written"])


def test_unmasked_scatter_mutant_is_caught():
    from grapevine_tpu_torch.oram import round as round_mod

    from grapevine_tpu_torch.parallel.mesh import make_mesh

    orig = round_mod._path_scatter_
    cfg = ctc.evict_cfg(6, 7, 2, 2)
    with pytest.raises(AssertionError, match="owner partition violated"):
        ctc.owner_partition(cfg, 6, make_mesh(["cpu", "cpu"]), "cpu", _unmasked_scatter=True)
    assert round_mod._path_scatter_ is orig  # the mutant is patched out again
