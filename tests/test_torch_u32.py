"""u32 lanes on int32 storage (grapevine_tpu_torch/u32.py) against numpy
uint32, bit for bit, on random inputs with the edge values mixed in."""

import numpy as np
import pytest
import torch

from grapevine_tpu_torch import u32 as U
from _torch_threads import one_torch_thread  # noqa: F401

EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xFFFFFFFE,
                  0xFFFFFFFF], np.uint32)


def _pair(seed, n=4096):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    # every pairing of two edge values leads both arrays
    a[: EDGES.size * EDGES.size] = np.repeat(EDGES, EDGES.size)
    b[: EDGES.size * EDGES.size] = np.tile(EDGES, EDGES.size)
    return a, b


def _t(x):
    return U.from_numpy(x, "cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_wrapping_arithmetic_matches_numpy(seed):
    a, b = _pair(seed)
    ta, tb = _t(a), _t(b)
    np.testing.assert_array_equal(U.to_numpy(ta + tb), a + b)
    np.testing.assert_array_equal(U.to_numpy(ta - tb), a - b)
    np.testing.assert_array_equal(U.to_numpy(ta * tb), a * b)
    np.testing.assert_array_equal(U.to_numpy(ta ^ tb), a ^ b)
    np.testing.assert_array_equal(U.to_numpy(ta & tb), a & b)
    np.testing.assert_array_equal(U.to_numpy(ta | tb), a | b)
    k = np.uint32(0xCC9E2D51)
    np.testing.assert_array_equal(U.to_numpy(ta * U.c32(k)), a * k)


@pytest.mark.parametrize("seed", [0, 1])
def test_shifts_and_rotates_match_numpy(seed):
    a, _ = _pair(seed)
    ta = _t(a)
    for n in range(32):
        np.testing.assert_array_equal(U.to_numpy(U.shr(ta, n)), a >> np.uint32(n))
        np.testing.assert_array_equal(U.to_numpy(ta << n), a << np.uint32(n))
    for n in range(1, 32):
        want = (a << np.uint32(n)) | (a >> np.uint32(32 - n))
        np.testing.assert_array_equal(U.to_numpy(U.rotl(ta, n)), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_unsigned_compare_matches_numpy(seed):
    a, b = _pair(seed)
    ta, tb = _t(a), _t(b)
    np.testing.assert_array_equal(U.ult(ta, tb).numpy(), a < b)
    np.testing.assert_array_equal(U.ule(ta, tb).numpy(), a <= b)
    np.testing.assert_array_equal(U.ule(ta, ta).numpy(), np.ones_like(a, bool))
    # against constants, including the sentinel
    for c in (0, 5, 0x80000000, 0xFFFFFFFF):
        np.testing.assert_array_equal(U.ult(ta, U.c32(c)).numpy(), a < np.uint32(c))


@pytest.mark.parametrize("seed", [0, 1])
def test_widen_narrow_round_trip(seed):
    a, _ = _pair(seed)
    ta = _t(a)
    w = U.widen(ta)
    assert w.dtype == torch.int64
    np.testing.assert_array_equal(w.numpy(), a.astype(np.int64))
    np.testing.assert_array_equal(U.to_numpy(U.narrow(w)), a)
    # narrow keeps the low 32 bits of any int64
    big = torch.tensor([-1, 2**32, 2**32 + 7, -(2**33) + 3], dtype=torch.int64)
    np.testing.assert_array_equal(
        U.to_numpy(U.narrow(big)),
        (big.numpy() & 0xFFFFFFFF).astype(np.uint32),
    )
    # sorting widened keys is unsigned order (the sentinel sorts last)
    order = torch.sort(w, stable=True).indices.numpy()
    np.testing.assert_array_equal(order, np.argsort(a, kind="stable"))


def test_c32_and_numpy_round_trip():
    for v in (0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF):
        t = torch.tensor(U.c32(v), dtype=torch.int32)
        assert int(U.to_numpy(t)) == v
    assert U.SENTINEL == U.c32(0xFFFFFFFF)
    scalar = U.from_numpy(np.uint32(0xFFFFFFFF), "cpu")
    assert scalar.shape == () and int(scalar) == -1
    src = np.arange(6, dtype=np.uint32).reshape(2, 3)
    t = U.from_numpy(src, "cpu")
    t += 1  # a copy: the source buffer is never written
    np.testing.assert_array_equal(src, np.arange(6).reshape(2, 3))
