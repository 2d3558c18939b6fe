"""The port's expiry sweep against the JAX package: ``"jnp"`` cipher, ``evict_every=4``, a
4-level tree-top cache; the sweep runs mid-window with the eviction
buffer not empty
(``test_torch_expiry.py`` has the harness and the clocks)."""

import pytest

from test_torch_expiry import run_expiry_case


@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("geo", ["g1", "g2"])
def test_expiry_matches_jax(geo, seed):
    run_expiry_case(geo, seed, 4, "jnp", 4)
