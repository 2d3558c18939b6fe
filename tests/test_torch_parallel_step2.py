"""The port's sharded step against the JAX package's single-chip step at
geometry ``g2`` (a taller records tree, a k=2 tree-top cache, one mailbox
choice): shards 2 and 4, ``"pallas"`` and ``"pallas_fused"``, two seeds
(``test_torch_parallel_step.py`` says what each campaign compares)."""

import pytest

from test_torch_parallel_step import run_sharded_campaign
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401


@pytest.mark.parametrize("impl,shards", [("pallas_fused", 2), ("pallas", 4)])
@pytest.mark.parametrize("seed", [5, 6])
def test_sharded_step_matches_single_chip_g2(seed, impl, shards, monkeypatch):
    assert len(run_sharded_campaign("g2", seed, impl, shards, monkeypatch)) > 0
