"""The port's segmented primitives held against the JAX package's
(``grapevine_tpu/oblivious/segmented.py``) at tolerance 0, on seeded
numpy inputs: the saturating monoid's identity and elements, the
multi-word group sort (``(perm, inv, seg_start)`` equal, not only the
groups), segment bounds, the segmented min/max scans and sums, the
O(B²) counts — with keys whose top bit is set, B=1, and batches of one
group and of all singletons."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grapevine_tpu.oblivious import segmented as js
from grapevine_tpu_torch.oblivious import segmented as ts
from grapevine_tpu_torch.u32 import from_numpy
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

SIZES = [1, 2, 3, 7, 16, 33, 64]


def _t(a):
    return from_numpy(np.asarray(a), "cpu")


def _cols(rng, b, nw, pattern):
    """``nw`` u32 key columns of length ``b``: "mixed" draws from a few
    values with the top bit set about half the time, "one" is a single
    group, "single" all distinct (singletons)."""
    if pattern == "one":
        return [np.full(b, 0x80000001 + w, np.uint32) for w in range(nw)]
    if pattern == "single":
        base = rng.permutation(b).astype(np.uint32) | np.uint32(0x80000000)
        return [base] + [np.full(b, 7, np.uint32) for _ in range(nw - 1)]
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    return [vals[rng.integers(0, len(vals), b)] for _ in range(nw)]


def test_sat_identity_and_elem_equal_reference():
    for shape in ((), (3,)):
        for t, j in zip(ts.sat_identity(shape), js.sat_identity(shape)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    rng = np.random.default_rng(0)
    for _ in range(50):
        steps = [(int(rng.integers(-3, 4)), int(rng.integers(-5, 1)),
                  int(rng.integers(1, 8))) for _ in range(rng.integers(1, 6))]
        ft, fj = ts.sat_identity(), js.sat_identity()
        for s in steps:
            ft = ts.sat_compose(ft, ts.sat_elem(*s))
            fj = js.sat_compose(fj, js.sat_elem(*s))
        x = np.arange(-4, 9, dtype=np.int32)
        np.testing.assert_array_equal(
            ts.sat_apply(ft, torch.from_numpy(x)).numpy(),
            np.asarray(js.sat_apply(fj, jnp.asarray(x))))


@pytest.mark.parametrize("pattern", ["mixed", "one", "single"])
@pytest.mark.parametrize("nw", [1, 2, 3, 10])
def test_multiword_group_sort_equals_reference(nw, pattern):
    rng = np.random.default_rng(nw * 7 + len(pattern))
    for b in SIZES:
        cols = _cols(rng, b, nw, pattern)
        got = ts.multiword_group_sort([_t(c) for c in cols])
        want = js.multiword_group_sort([jnp.asarray(c) for c in cols])
        for name, g, w in zip(("perm", "inv", "seg_start"), got, want):
            np.testing.assert_array_equal(g.numpy().astype(np.int64),
                                          np.asarray(w).astype(np.int64),
                                          f"B={b} {name}")
        tstart, tend = ts.segment_bounds(got[2])
        jstart, jend = js.segment_bounds(want[2])
        np.testing.assert_array_equal(tstart.numpy(), np.asarray(jstart))
        np.testing.assert_array_equal(tend.numpy(), np.asarray(jend))


@pytest.mark.parametrize("b", SIZES)
def test_segmented_scans_and_sums_equal_reference(b):
    rng = np.random.default_rng(b)
    for p_start in (0.0, 0.3, 1.0):  # one group, mixed, all singletons
        seg = rng.random(b) < p_start
        seg[0] = True
        x = rng.integers(0, 5, (b, 3)).astype(np.int32)
        v = rng.integers(-9, 9, b).astype(np.int32)
        tseg, jseg = torch.from_numpy(seg), jnp.asarray(seg)
        bounds = ts.segment_bounds(tseg)
        for fn in ("segmented_sum_before", "segmented_sum_total"):
            for xx in (x, x[:, 0], x[:, 0] > 2):
                want = np.asarray(getattr(js, fn)(jnp.asarray(xx), jseg))
                got = getattr(ts, fn)(torch.from_numpy(xx), tseg)
                np.testing.assert_array_equal(got.numpy(), want, fn)
                np.testing.assert_array_equal(
                    getattr(ts, fn)(torch.from_numpy(xx), tseg, bounds).numpy(), want)
        for top, jop in ((torch.minimum, jnp.minimum), (torch.maximum, jnp.maximum)):
            np.testing.assert_array_equal(
                ts.segmented_scan(torch.from_numpy(v), tseg, top).numpy(),
                np.asarray(js.segmented_scan(jnp.asarray(v), jseg, jop)))
        np.testing.assert_array_equal(
            ts.segmented_scan(torch.from_numpy(x), tseg, torch.maximum).numpy(),
            np.asarray(js.segmented_scan(jnp.asarray(x), jseg, jnp.maximum)))


def test_segmented_counts_before_equals_reference():
    rng = np.random.default_rng(5)
    for b in SIZES:
        group = np.array([0, 0x80000000, 0xFFFFFFFF], np.uint32)[rng.integers(0, 3, b)]
        flags = rng.random(b) < 0.5
        np.testing.assert_array_equal(
            ts.segmented_counts_before(_t(group), torch.from_numpy(flags)).numpy(),
            np.asarray(js.segmented_counts_before(jnp.asarray(group), jnp.asarray(flags))))


def test_group_sort_keys_with_the_top_bit_set_sort_unsigned():
    """A key word at 0x80000000 and above sorts after every smaller u32,
    as ``lax.sort`` orders u32 — not first, as its int32 lane would."""
    cols = [np.array([0xFFFFFFFF, 1, 0x80000000, 0], np.uint32),
            np.array([0, 0x90000000, 5, 0xFFFFFFFF], np.uint32)]
    perm, _, _ = ts.multiword_group_sort([_t(c) for c in cols])
    assert perm.tolist() == [3, 1, 2, 0]
    perm2, _, _ = ts.multiword_group_sort([_t(cols[1])])
    assert perm2.tolist() == [0, 2, 1, 3]
