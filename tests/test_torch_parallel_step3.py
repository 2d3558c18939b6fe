"""The port's sharded step with the recursive position map and a k=2
tree-top cache (geometry ``g2``) against the JAX package's single-chip
step: the leaf plane is sharded like the trees, the internal ORAM and the
cache planes stay replicated, and the internal leaves are injected from
the JAX draws (``test_torch_parallel_step.py`` says what each campaign
compares)."""

import pytest

from test_torch_parallel_step import run_sharded_campaign


@pytest.mark.parametrize("seed,impl,shards", [(2, "pallas", 2), (7, "pallas_fused", 4)])
def test_sharded_recursive_step_matches_single_chip(seed, impl, shards, monkeypatch):
    assert len(run_sharded_campaign("g2", seed, impl, shards, monkeypatch,
                                    recursive=True)) > 0
