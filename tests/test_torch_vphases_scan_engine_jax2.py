"""The scan vphases through the engine against the JAX package:
``max_messages`` 2^7, B=16, E=2 with ``sort_impl="radix"`` (the radix
branches of the dedup and index group sorts), under the jnp cipher and,
for the port, ``"pallas_fused"``'s plain versions (junk masked). The
campaign and its checks are ``test_torch_vphases_scan_engine_jax.py``'s."""

import pytest

from grapevine_tpu_torch.wire import constants as C
from test_torch_vphases_scan_engine_jax import SCAN_GEOS, run_scan_campaign
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401


@pytest.mark.parametrize("seed,impl", [(2, "jnp"), (6, "pallas_fused")])
def test_scan_campaign_matches_jax_radix_e2(seed, impl):
    st = run_scan_campaign(SCAN_GEOS["radix_e2"], seed, n_rounds=4, impl=impl)
    assert any((s == C.STATUS_CODE_SUCCESS).any() for s in st)
