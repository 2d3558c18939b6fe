"""The port's one-word PRP (``oblivious/prp.py:prp_encrypt`` /
``prp_decrypt``) held against the JAX package's at tolerance 0: the same
key and inputs give the same u32 words, decrypt inverts, and the map is a
bijection on [0, 2**bits) — including keys and inputs with the top bit
set and inputs with bits above the domain (ignored on input)."""

import jax.numpy as jnp
import numpy as np
import pytest

from grapevine_tpu.oblivious import prp as jprp
from grapevine_tpu_torch.oblivious import prp as tprp
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.u32 import to_numpy as t2n
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401


@pytest.mark.parametrize("bits", [1, 2, 3, 7, 13, 16, 21, 31, 32])
def test_prp_equals_reference_and_inverts(bits):
    rng = np.random.default_rng(bits)
    key = rng.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
    key[0] |= 0x80000000
    x = rng.integers(0, 2**32, 512, dtype=np.uint64).astype(np.uint32)
    tk, tx = from_numpy(key, "cpu"), from_numpy(x, "cpu")
    y = tprp.prp_encrypt(tk, tx, bits)
    np.testing.assert_array_equal(t2n(y), np.asarray(jprp.prp_encrypt(
        jnp.asarray(key), jnp.asarray(x), bits)))
    mask = np.uint32((1 << bits) - 1) if bits < 32 else np.uint32(0xFFFFFFFF)
    back = tprp.prp_decrypt(tk, y, bits)
    np.testing.assert_array_equal(t2n(back), x & mask)
    np.testing.assert_array_equal(t2n(back), np.asarray(jprp.prp_decrypt(
        jnp.asarray(key), jnp.asarray(t2n(y)), bits)))


def test_prp_full_domain_permutation():
    bits = 10
    key = from_numpy(np.array([7, 0x9E3779B9, 0xFFFFFFFF, 3], np.uint32), "cpu")
    y = t2n(tprp.prp_encrypt(key, from_numpy(np.arange(1 << bits, dtype=np.uint32), "cpu"),
                             bits))
    assert sorted(y.tolist()) == list(range(1 << bits))
