"""The CRUD campaign of tests/test_torch_engine.py under
``bucket_cipher_impl="pallas_fused_tiled"``: the JAX engine runs its
fused Pallas gather/scatter kernels in interpret mode, the port runs the
plain versions of its Hopper kernels (CPU tensors). Responses and
transcripts are equal bit for bit; full state too, with the padded junk
bucket masked (non-owner rows race there by design). Kept in its own
file so the interpret-mode compiles run beside the jnp campaigns."""

import pytest

from test_torch_engine import GEOMETRIES, run_campaign


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_campaign_matches_jax_fused_tiled(geo, seed):
    assert len(run_campaign(geo, seed, "pallas_fused_tiled")) > 0
