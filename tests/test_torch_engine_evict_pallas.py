"""The delayed-eviction CRUD campaign at ``evict_every=2`` under
``bucket_cipher_impl="pallas"``: the JAX engine runs its row-cipher
Pallas kernel (``cipher_rows_pallas``) in interpret mode for every fetch
and flush, the port runs its Hopper row-cipher kernel's plain version
(CPU tensors). Responses, transcripts and full state are equal bit for
bit after every round and flush. Kept in its own file so the
interpret-mode compiles run beside the other campaigns."""

from test_torch_engine_evict import run_evict_campaign


def test_campaign_e2_matches_jax_pallas():
    assert len(run_evict_campaign("g1", 3, "pallas", 2)) > 0
