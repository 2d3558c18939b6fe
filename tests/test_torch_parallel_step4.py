"""The port's sharded step and flush at ``evict_every=2`` against the JAX
package's single-chip ``engine_round_step`` and ``engine_flush_step``:
two whole windows, each flush owner-masked per shard, then the sweep
mid-window and one more round (``test_torch_parallel_step.py`` says what
each campaign compares)."""

import pytest

from test_torch_parallel_step import run_sharded_campaign
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401


@pytest.mark.parametrize("impl,shards", [("pallas_fused", 2), ("pallas", 4)])
@pytest.mark.parametrize("seed", [3, 8])
def test_sharded_flush_matches_single_chip(seed, impl, shards, monkeypatch):
    assert len(run_sharded_campaign("g1", seed, impl, shards, monkeypatch,
                                    evict_every=2)) > 0
