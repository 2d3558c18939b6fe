"""The port's expiry sweep against the JAX package: ``"pallas_fused"`` (interpret
mode / plain versions; junk bucket masked), ``evict_every=4`` mid-window
with the buffer not empty, no tree-top cache
(``test_torch_expiry.py`` has the harness and the clocks)."""

import pytest

from test_torch_expiry import run_expiry_case
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401


@pytest.mark.parametrize("seed", [2, 3])
@pytest.mark.parametrize("geo", ["g1", "g2"])
def test_expiry_matches_jax(geo, seed):
    run_expiry_case(geo, seed, 0, "pallas_fused", 4)
