"""The recursive position map and the radix sort through the engine
against the JAX package: E=2 at the wider geometry ``g2`` under the jnp
cipher (the campaign and its
checks are ``test_torch_posmap_engine_jax.py``'s)."""

import pytest

from test_torch_posmap_engine_jax import run_recursive_campaign


@pytest.mark.parametrize("seed", [3, 5])
def test_recursive_radix_campaign_matches_jax_g2_e2(seed):
    assert len(run_recursive_campaign("g2", seed, 2, "jnp")) > 0
