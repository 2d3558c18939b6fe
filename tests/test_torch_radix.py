"""The port's radix rank and grouping sorts
(``grapevine_tpu_torch/oblivious/radix.py``, ``segmented.group_sort``)
held against ``grapevine_tpu/oblivious/radix.py`` and
``segmented.group_sort`` (models: the reference's ``tests/test_radix.py``
and ``tests/test_sort_radix.py``): over random keys at several declared
bounds and lengths, all-equal keys and keys at the bound's top, the
permutations, inverses and segment starts are equal (tolerance 0) and
equal a stable argsort. The card-only case (``-k cuda``, run with
``--noconftest``; the JAX imports are lazy) holds the rank against
``torch.argsort(stable=True)`` at 2^20 keys."""

import numpy as np
import pytest
import torch

from grapevine_tpu_torch.oblivious import radix as tradix
from grapevine_tpu_torch.oblivious.segmented import group_sort
from grapevine_tpu_torch.u32 import from_numpy

LENGTHS = (1, 2, 7, 64, 513, 3000)
BITS = (1, 3, 8, 9, 16, 21, 32)


def _keys(rng, n, kb, kind):
    top = (1 << kb) - 1
    if kind == "random":
        return rng.integers(0, top + 1, n, dtype=np.uint64).astype(np.uint32)
    if kind == "equal":
        return np.full(n, rng.integers(0, top + 1), np.uint32)
    # the bound's top (the eviction sentinel's role) mixed with small keys
    return np.where(rng.random(n) < 0.5, top, rng.integers(0, min(4, top), n)).astype(np.uint32)


@pytest.mark.parametrize("kind", ["random", "equal", "top"])
@pytest.mark.parametrize("kb", BITS)
def test_radix_rank_matches_jax_and_stable_argsort(kb, kind):
    import jax.numpy as jnp

    from grapevine_tpu.oblivious.radix import radix_rank as jrank

    rng = np.random.default_rng(kb * 7 + len(kind))
    for n in LENGTHS:
        k = _keys(rng, n, kb, kind)
        got = tradix.radix_rank(from_numpy(k, "cpu"), kb).numpy()
        np.testing.assert_array_equal(got, np.argsort(k, kind="stable"), f"n={n}")
        np.testing.assert_array_equal(got, np.asarray(jrank(jnp.asarray(k), kb)), f"n={n}")


@pytest.mark.parametrize("bpp", [1, 4, 5, 8, 11])
def test_radix_rank_every_pass_width(bpp):
    rng = np.random.default_rng(bpp)
    k = rng.integers(0, 1 << 21, 777, dtype=np.uint64).astype(np.uint32)
    got = tradix.radix_rank(from_numpy(k, "cpu"), 21, bits_per_pass=bpp).numpy()
    np.testing.assert_array_equal(got, np.argsort(k, kind="stable"))


def test_eviction_key_form_equals_the_sentinel_argsort():
    """``where(valid, leaf, 2^h)`` at h + 1 bits ranks the working set as
    the comparison sort of ``where(valid, leaf, 0xFFFFFFFF)`` does."""
    from grapevine_tpu_torch.u32 import SENTINEL, widen

    rng = np.random.default_rng(5)
    for h in (1, 5, 19):
        leaf = from_numpy(rng.integers(0, 1 << h, 4000).astype(np.uint32), "cpu")
        valid = torch.from_numpy(rng.random(4000) < 0.3)
        got = tradix.radix_rank(torch.where(valid, leaf, 1 << h), h + 1)
        want = torch.sort(widen(torch.where(valid, leaf, SENTINEL)), stable=True).indices
        assert torch.equal(got, want)


@pytest.mark.parametrize("bits", [[5], [3, 7], [1, 16, 2], [32, 32]])
def test_radix_group_sort_matches_jax_and_group_sort(bits):
    import jax.numpy as jnp

    from grapevine_tpu.oblivious.radix import radix_group_sort as jgroup

    rng = np.random.default_rng(sum(bits))
    for n in (1, 9, 300):
        # few distinct values per column, so groups have members
        cols = [rng.integers(0, min(1 << kb, 5), n).astype(np.uint32) for kb in bits]
        got = tradix.radix_group_sort([from_numpy(c, "cpu") for c in cols], bits)
        want = jgroup([jnp.asarray(c) for c in cols], bits)
        for g, w, name in zip(got, want, ("perm", "inv", "seg_start")):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype),
                                          f"{name} n={n}")
        order = np.lexsort(cols[::-1])
        np.testing.assert_array_equal(got[0].numpy(), order)


@pytest.mark.parametrize("kb", [1, 4, 11])
def test_group_sort_radix_matches_jax_and_xla(kb):
    import jax.numpy as jnp

    from grapevine_tpu.oblivious.segmented import group_sort as jgroup_sort

    rng = np.random.default_rng(kb)
    for n in (1, 16, 2048):
        g = rng.integers(0, min(1 << kb, n), n).astype(np.uint32)
        tg = from_numpy(g, "cpu")
        radix = group_sort(tg, sort_impl="radix", key_bits=kb)
        xla = group_sort(tg)
        jr = jgroup_sort(jnp.asarray(g), sort_impl="radix", key_bits=kb)
        for a, b, c in zip(radix, xla, jr):
            assert torch.equal(a, b)
            np.testing.assert_array_equal(a.numpy().astype(np.asarray(c).dtype),
                                          np.asarray(c))
    # without a declared bound the comparison sort is kept
    assert all(torch.equal(a, b) for a, b in zip(
        group_sort(tg, sort_impl="radix"), group_sort(tg)))


def test_radix_refusals_match_jax():
    from grapevine_tpu.oblivious import radix as jradix

    k = from_numpy(np.array([0, 9, 3], np.uint32), "cpu")
    for mod, keys in ((tradix, k), (jradix, np.array([0, 9, 3], np.uint32))):
        with pytest.raises(ValueError, match="exceeds the declared"):
            mod.radix_rank(keys, 3)
        for bad in (0, 33, 2.0):
            with pytest.raises(ValueError, match="key_bits"):
                mod.radix_rank(keys, bad)
        with pytest.raises(ValueError, match="bits_per_pass"):
            mod.radix_rank(keys, 8, bits_per_pass=17)
        with pytest.raises(ValueError, match="MAX_RADIX_BITS"):
            mod.radix_group_sort([keys] * 3, [32, 32, 1])
        with pytest.raises(ValueError, match="per column"):
            mod.radix_group_sort([keys, keys], [8])
    assert tradix.MAX_RADIX_BITS == jradix.MAX_RADIX_BITS


def test_partition_rank_is_the_one_bit_pass():
    rng = np.random.default_rng(2)
    flags = torch.from_numpy(rng.random(999) < 0.4)
    pos = tradix.partition_rank(flags).long()
    perm = torch.empty_like(pos).index_put_((pos,), torch.arange(999))
    assert torch.equal(perm, tradix.radix_rank(flags.to(torch.int32), 1))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's radix passes run only there "
                    "(python -m pytest --noconftest tests/test_torch_radix.py -k cuda)")
    return torch.device("cuda")


def test_cuda_radix_rank_matches_stable_argsort_at_2_20(cuda_device):
    """At 2^20 keys on the card (the eviction sort's scale: h + 1 = 21
    declared bits), with a sentinel share, the rank equals
    ``torch.argsort(stable=True)`` and the rank makes no host sync."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    n, h = 1 << 20, 20
    leaf = torch.randint(0, 1 << h, (n,), generator=gen, device=cuda_device,
                         dtype=torch.int64).to(torch.int32)
    valid = torch.rand(n, generator=gen, device=cuda_device) < 0.2
    keys = torch.where(valid, leaf, 1 << h)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tradix.radix_rank(keys, h + 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, torch.argsort(keys, stable=True))
    grp = torch.randint(0, 2048, (2048,), generator=gen, device=cuda_device).to(torch.int32)
    for a, b in zip(group_sort(grp, sort_impl="radix", key_bits=11), group_sort(grp)):
        assert torch.equal(a, b)
