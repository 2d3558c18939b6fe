"""The delayed-eviction CRUD campaign of tests/test_torch_engine_evict.py
at ``evict_every=4`` (records window 4, mailbox window 8), two
geometries × two seeds, ``"jnp"`` cipher: responses, transcripts and full
state equal the JAX package's after every round and flush (tolerance 0).
Kept in its own file so its reference compiles run beside the others."""

import pytest

from test_torch_engine import GEOMETRIES
from test_torch_engine_evict import run_evict_campaign


@pytest.mark.parametrize("seed", [3, 4])
@pytest.mark.parametrize("geo", sorted(GEOMETRIES))
def test_campaign_e4_matches_jax_jnp(geo, seed):
    assert len(run_evict_campaign(geo, seed, "jnp", 4)) > 0
