"""The delayed-eviction CRUD campaign at ``evict_every=2`` under
``bucket_cipher_impl="pallas_fused"``: the JAX engine runs its one-row
fused gather and scatter Pallas kernels (``gather_decrypt_rows``,
``scatter_encrypt_rows``) in interpret mode, in the fetch rounds and the
flush, the port runs its one-row-a-step Hopper kernels' plain versions
(CPU tensors). Responses and transcripts are equal bit for bit, full
state too with the padded junk bucket masked. Kept in its own file so the
interpret-mode compiles run beside the other campaigns."""

from test_torch_engine_evict import run_evict_campaign


def test_campaign_e2_matches_jax_pallas_fused():
    assert len(run_evict_campaign("g1", 3, "pallas_fused", 2)) > 0
