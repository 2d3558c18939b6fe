"""The recursive position map and the radix sort through the engine
against the JAX package: E=2 (a flush every second round, the internal
trees' inner flush) at ``g1``, the port on ``"pallas_fused"``'s plain
versions (the campaign and its
checks are ``test_torch_posmap_engine_jax.py``'s)."""

import pytest

from test_torch_posmap_engine_jax import run_recursive_campaign
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401


@pytest.mark.parametrize("seed", [3, 5])
def test_recursive_radix_campaign_matches_jax_g1_e2(seed):
    assert len(run_recursive_campaign("g1", seed, 2, "pallas_fused")) > 0
