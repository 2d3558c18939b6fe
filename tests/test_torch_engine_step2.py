"""The port's op-major ``engine_step`` against the JAX package's at the
second geometry, ``g2`` (a taller records tree with two blocks a leaf, a
wider mailbox, B=12), under ``bucket_cipher_impl="pallas"``: the
reference runs its Pallas row cipher in interpret mode, the port's
``cipher_rows_pallas`` takes its plain version on CPU tensors. Responses,
``[B, 3]`` transcripts and every state leaf equal after every round
(tolerance 0); the campaign is ``test_torch_engine_step.py``'s."""

import pytest

from test_torch_engine_step import _check_coverage, run_step_campaign
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401


@pytest.mark.parametrize("seed", [5, 6])
def test_engine_step_matches_jax_g2_pallas(seed):
    _check_coverage(run_step_campaign("g2", seed, "pallas"))
