"""The op-major engine's oblivious primitives
(``grapevine_tpu_torch/oblivious/primitives.py``: ``cmov``,
``onehot_select``, ``first_true_onehot``, ``argmin_u64_onehot``) held
against ``grapevine_tpu/oblivious/primitives.py`` at tolerance 0 on the
same seeded inputs: u32 words with the top bit set (negative on the
port's int32 lanes), 0xFFFFFFFF itself (the reference's +inf), ties,
all-invalid and all-False masks, and masks with several lanes set (the
masked sum wraps mod 2^32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grapevine_tpu.oblivious import primitives as jp
from grapevine_tpu_torch.oblivious import primitives as tp
from grapevine_tpu_torch.u32 import from_numpy, to_numpy


def _words(rng, shape, top: bool):
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    if top:
        w |= np.uint32(0x80000000)
    return w


def _masks(rng, n):
    yield np.zeros(n, bool)
    yield np.ones(n, bool)
    one = np.zeros(n, bool)
    one[rng.integers(n)] = True
    yield one
    yield one[::-1].copy()
    for _ in range(4):
        yield rng.random(n) < 0.3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cmov_and_onehot_select_match_jax(seed):
    rng = np.random.default_rng(seed)
    n = 9
    for top in (False, True):
        vals = _words(rng, (n, 3, 4), top)
        vals[0, 0, 0] = 0xFFFFFFFF
        other = _words(rng, (n, 3, 4), not top)
        for m in _masks(rng, n):
            want = np.asarray(jp.onehot_select(jnp.asarray(m), jnp.asarray(vals)))
            got = to_numpy(tp.onehot_select(torch.from_numpy(m), from_numpy(vals, "cpu")))
            np.testing.assert_array_equal(got, want, f"onehot_select {m}")
            assert got.dtype == np.uint32 and got.shape == (3, 4)
            c = m[:, None, None]
            want = np.asarray(jp.cmov(jnp.asarray(c), jnp.asarray(vals), jnp.asarray(other)))
            got = to_numpy(tp.cmov(torch.from_numpy(c), from_numpy(vals, "cpu"),
                                   from_numpy(other, "cpu")))
            np.testing.assert_array_equal(got, want, f"cmov {m}")


@pytest.mark.parametrize("n", [1, 2, 7, 62])
def test_first_true_onehot_matches_jax(n):
    rng = np.random.default_rng(n)
    for m in _masks(rng, n):
        want = np.asarray(jp.first_true_onehot(jnp.asarray(m)))
        got = tp.first_true_onehot(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, want, f"{m}")
        assert got.sum() == (1 if m.any() else 0)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_argmin_u64_onehot_matches_jax(seed):
    """Unsigned order: a hi word with its top bit set is larger, never
    smaller; 0xFFFFFFFF on a valid lane ties with the invalid lanes'
    +inf and still wins over them; ties break toward the lowest lane."""
    rng = np.random.default_rng(seed)
    n = 62
    cases = []
    for top in (False, True):
        hi, lo = _words(rng, n, top), _words(rng, n, top)
        cases.append((hi, lo))
        # few distinct words: many (hi, lo) ties
        cases.append((hi % 3 + (0x80000000 if top else 0), lo % 2))
    big = np.full(n, 0xFFFFFFFF, np.uint32)
    cases.append((big, big))
    cases.append((big, _words(rng, n, True)))
    mixed = _words(rng, n, False)
    mixed[::2] |= np.uint32(0x80000000)
    cases.append((mixed, mixed[::-1].copy()))
    for hi, lo in cases:
        for valid in _masks(rng, n):
            wo, wa = jp.argmin_u64_onehot(jnp.asarray(valid), jnp.asarray(hi),
                                          jnp.asarray(lo))
            go, ga = tp.argmin_u64_onehot(torch.from_numpy(valid), from_numpy(hi, "cpu"),
                                          from_numpy(lo, "cpu"))
            np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
            assert bool(ga) == bool(wa) == bool(valid.any())
            if valid.any():
                key = (hi.astype(np.uint64) << np.uint64(32)) | lo
                i = int(np.flatnonzero(go.numpy())[0])
                assert key[i] == key[valid].min() and valid[i]
                assert not np.any(valid[:i] & (key[:i] == key[i]))
