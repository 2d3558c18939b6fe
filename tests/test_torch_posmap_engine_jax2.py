"""The recursive position map and the radix sort through the engine
against the JAX package: E=1 at the wider geometry ``g2`` (k=2 cache), the port on
``"pallas_fused_tiled"``'s plain versions (the campaign and its
checks are ``test_torch_posmap_engine_jax.py``'s)."""

import pytest

from test_torch_posmap_engine_jax import run_recursive_campaign


@pytest.mark.parametrize("seed", [2, 7])
def test_recursive_radix_campaign_matches_jax_g2_e1(seed):
    assert len(run_recursive_campaign("g2", seed, 1, "pallas_fused_tiled")) > 0
