"""The port's scan vphases (``vphases_impl="scan"``): the group
aggregations, the sorted dedup masks, the knob, whole engines against the
port's dense twin, and the quadratic census.

- ``_SortedGroups`` answers every group question exactly as
  ``_DenseGroups`` does, at B ∈ {1, 8, 64}, over index and recipient
  groups (dummies singleton, flags only on real ops);
- ``occurrence_masks_sorted`` equals the JAX package's under both
  ``sort_impl`` values, and the port's dense masks;
- the knob validates, ``None`` resolves to ``"dense"`` and ``"scan"``
  is no longer refused;
- a scan engine equals a dense engine from one seed on the same CRUD
  rounds: responses, transcript and full state, at E=1, E=2, radix and
  a recursive map;
- the census: one scan round at B=256 under a ``TorchDispatchMode``
  creates no bool or float tensor with two axes of extent ≥ B; the
  dense round, the positive control, does.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from grapevine_tpu.oram.round import occurrence_masks_sorted as j_occ_sorted
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine import vphases as vp
from grapevine_tpu_torch.engine.batcher import batch_to_device
from grapevine_tpu_torch.engine.convert import first_difference, to_numpy
from grapevine_tpu_torch.engine.round_step import engine_round_step
from grapevine_tpu_torch.engine.state import EngineConfig, init_engine
from grapevine_tpu_torch.oram.round import occurrence_masks, occurrence_masks_sorted
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.u32 import to_numpy as t2n
from grapevine_tpu_torch.wire import constants as C
from test_torch_engine import GEOMETRIES, crud_batches


def _impl(v, s="xla"):
    return types.SimpleNamespace(vphases_impl=v, sort_impl=s)


def _groups(kind, b, rng, sort_impl):
    """(dense, sorted) group objects over the same ops."""
    is_real = torch.from_numpy(rng.random(b) < 0.8)
    if kind == "index":
        vals = np.array([3, 5, 0x7FFFFFF0, 9], np.uint32)[rng.integers(0, 4, b)]
        idx = from_numpy(vals, "cpu")
        base = 0x7FFFFFF1
        return (vp._index_groups(_impl("dense"), idx, is_real, base),
                vp._index_groups(_impl("scan", sort_impl), idx, is_real, base),
                is_real)
    users = rng.integers(0, 2**32, (3, 8), dtype=np.uint64).astype(np.uint32)
    users[0, 0] = 0x80000000  # a key word with the top bit set
    ka = from_numpy(users[rng.integers(0, 3, b)], "cpu")
    return (vp._recipient_groups(_impl("dense"), ka, is_real),
            vp._recipient_groups(_impl("scan", sort_impl), ka, is_real), is_real)


@pytest.mark.parametrize("sort_impl", ["xla", "radix"])
@pytest.mark.parametrize("kind", ["index", "recipient"])
@pytest.mark.parametrize("b", [1, 8, 64])
def test_sorted_groups_equal_dense_groups(b, kind, sort_impl):
    rng = np.random.default_rng(b * 3 + len(kind))
    dense, srt, is_real = _groups(kind, b, rng, sort_impl)
    assert isinstance(dense, vp._DenseGroups) and isinstance(srt, vp._SortedGroups)

    def eq(name, x, y):
        np.testing.assert_array_equal(x.numpy(), y.numpy(), name)

    eq("group_first", dense.group_first(), srt.group_first())
    eq("group_last", dense.group_last(), srt.group_last())
    for trial in range(4):
        flags = torch.from_numpy(rng.random(b) < (0.2, 0.5, 0.9, 1.0)[trial]) & is_real
        for m in ("counts_before", "any_before", "total_sum", "total_or",
                  "last_flag_index_upto", "last_flag_index"):
            eq(m, getattr(dense, m)(flags), getattr(srt, m)(flags))
        (xi, xh), (yi, yh) = dense.first_flag_index(flags), srt.first_flag_index(flags)
        eq("first_flag_index found", xh, yh)
        # the index is a don't-care where the group has no flag (both
        # forms clamp it in range; every caller masks it by ``found``)
        eq("first_flag_index", xi[xh], yi[yh])
        assert bool(((yi >= 0) & (yi < b)).all())
        u = torch.from_numpy(rng.random((b, 5)) < 0.3) & flags[:, None]
        eq("total_sum_rows", dense.total_sum_rows(u), srt.total_sum_rows(u))
        eq("total_or_rows", dense.total_or_rows(u), srt.total_or_rows(u))
        vals = torch.from_numpy(rng.integers(-2**31, 2**31, (b, 2), dtype=np.int64)
                                .astype(np.int32))
        q = torch.from_numpy(rng.integers(-1, 4, b).astype(np.int32))
        eq("select_by_rank", dense.select_by_rank(flags, vals, q),
           srt.select_by_rank(flags, vals, q))


@pytest.mark.parametrize("sort_impl", ["xla", "radix"])
def test_occurrence_masks_sorted_equal_reference(sort_impl):
    rng = np.random.default_rng(11)
    for b in (1, 5, 16, 64):
        dummy = 40
        idxs = rng.integers(0, dummy + 1, b).astype(np.uint32)
        kb = max(1, dummy.bit_length())
        got = occurrence_masks_sorted(from_numpy(idxs, "cpu"), dummy, sort_impl, kb)
        want = j_occ_sorted(jnp.asarray(idxs), dummy, sort_impl, kb)
        dense = occurrence_masks(from_numpy(idxs, "cpu"), dummy)
        for name, g, w, d in zip(("first_occ", "last_occ", "chain_slot"), got, want, dense):
            np.testing.assert_array_equal(t2n(g), np.asarray(w), f"B={b} {name}")
            np.testing.assert_array_equal(g.numpy(), d.numpy(), f"B={b} {name} dense")


def test_vphases_knob_validation_and_default():
    with pytest.raises(ValueError):
        GrapevineConfig(vphases_impl="bogus")
    # the port resolves None to "dense" everywhere (the reference picks
    # "scan" off the TPU)
    assert EngineConfig.from_config(GrapevineConfig(max_messages=64)).vphases_impl == "dense"
    for v in ("dense", "scan"):
        ecfg = EngineConfig.from_config(GrapevineConfig(max_messages=64, vphases_impl=v))
        assert ecfg.vphases_impl == v
    scan = EngineConfig.from_config(GrapevineConfig(max_messages=64, vphases_impl="scan"))
    dense = EngineConfig.from_config(GrapevineConfig(max_messages=64, vphases_impl="dense"))
    assert repr(scan) != repr(dense)  # the checkpoint fingerprint tells them apart
    # the op-major engine builds (and ignores the vphases: it runs none);
    # on a mesh the scan vphases resolve as on one device (shards stays
    # out of the engine config)
    op = EngineConfig.from_config(GrapevineConfig(max_messages=64, vphases_impl="scan",
                                                  commit="op"))
    assert op.vphases_impl == "scan" and op.mb_choices == 1
    assert op.rec.top_cache_levels == 0
    assert EngineConfig.from_config(GrapevineConfig(max_messages=64, vphases_impl="scan",
                                                    shards=2)) == scan


@pytest.mark.parametrize("extra", [
    dict(), dict(sort_impl="radix"), dict(evict_every=2),
    dict(posmap_impl="recursive", sort_impl="radix"),
], ids=["flat", "radix", "e2", "recursive-radix"])
@pytest.mark.parametrize("geo", ["g1", "g2"])
def test_scan_engine_equals_dense_engine(geo, extra):
    from grapevine_tpu_torch.engine.round_step import engine_flush_step

    eng = {}
    for v in ("dense", "scan"):
        ecfg = EngineConfig.from_config(GrapevineConfig(**GEOMETRIES[geo], vphases_impl=v,
                                                        **extra))
        eng[v] = [ecfg, init_engine(ecfg, 5, device="cpu")]
    b = eng["dense"][0].batch_size
    created = []
    for rnd, batch in enumerate(crud_batches(b, 6, 5, lambda: created)):
        out = {}
        for v, pair in eng.items():
            ecfg, st = pair
            st, resp, tr = engine_round_step(ecfg, st, batch_to_device(batch, "cpu"))
            if ecfg.evict_every > 1 and (rnd + 1) % ecfg.evict_every == 0:
                st = engine_flush_step(ecfg, st)
            pair[1] = st
            out[v] = (resp, tr)
        for k in out["dense"][0]:
            np.testing.assert_array_equal(t2n(out["scan"][0][k]), t2n(out["dense"][0][k]),
                                          f"round {rnd}: response {k}")
        np.testing.assert_array_equal(t2n(out["scan"][1]), t2n(out["dense"][1]))
        diff = first_difference(to_numpy(eng["scan"][1]), to_numpy(eng["dense"][1]))
        assert diff is None, f"round {rnd}: state differs at {diff}"
        resp = out["dense"][0]
        st = t2n(resp["status"])
        for i in np.flatnonzero((batch["req_type"] == C.REQUEST_TYPE_CREATE)
                                & (st == C.STATUS_CODE_SUCCESS)):
            created.append((t2n(resp["msg_id"])[i].tobytes(), batch["auth"][i].tobytes(),
                            batch["recipient"][i].tobytes()))
    assert created


# -- the quadratic census --------------------------------------------------

CENSUS_B = 256

#: the predicate broadcast and the select it feeds: a bool [B, 256] there
#: is batch x record width (1 KB records are 256 words wide), not a
#: same-key matrix (the reference's ``_quadratic_avals`` exclusions)
_SKIP_BOOL = {"expand", "where"}


class _Census(TorchDispatchMode):
    """Records every bool or float tensor an op creates with two or more
    axes of extent ≥ ``b``."""

    def __init__(self, b):
        super().__init__()
        self.b = b
        self.bad = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        for t in tree_flatten(out)[0]:
            if not isinstance(t, torch.Tensor):
                continue
            if not (t.dtype == torch.bool or t.dtype.is_floating_point):
                continue
            if t.dtype == torch.bool and name in _SKIP_BOOL:
                continue
            if sum(1 for d in t.shape if d >= self.b) >= 2:
                self.bad.append((name, str(t.dtype), tuple(t.shape)))
        return out


def _census_round(impl):
    cfg = GrapevineConfig(max_messages=1 << 12, max_recipients=1 << 8, mailbox_cap=4,
                          batch_size=CENSUS_B, bucket_cipher_rounds=0, stash_size=512,
                          vphases_impl=impl)
    ecfg = EngineConfig.from_config(cfg)
    st = init_engine(ecfg, 0, device="cpu")
    batch = batch_to_device(next(crud_batches(CENSUS_B, 1, 0, lambda: [])), "cpu")
    census = _Census(CENSUS_B)
    with census:
        engine_round_step(ecfg, st, batch, fast_ok=True)
    return census.bad


def test_scan_round_has_no_quadratic_tensor():
    bad = _census_round("scan")
    assert not bad, f"scan round creates [B,B] tensors at B={CENSUS_B}: {sorted(set(bad))[:8]}"


def test_dense_round_census_positive_control():
    """The dense round DOES create [B,B] masks and float products, which
    proves the census sees what the scan test asserts away."""
    bad = _census_round("dense")
    assert any(dt == "torch.bool" for _, dt, _ in bad)
    assert any(dt == "torch.float64" for _, dt, _ in bad)
