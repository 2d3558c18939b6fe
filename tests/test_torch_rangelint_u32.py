"""The range analyzer's u32-on-int32 reading (the port's own design, see
``grapevine_tpu_torch/analysis/rangelint.py``): the ``u32.py`` helpers are
exact on a full u32 lane, a sign-extending ``.long()`` of a lane that
reaches 2^31 is a ``trunc-cast``, ``scatter_drop``'s spill row is in
range, and the kernels' address operands are held against their tree's
rows. Plus the ``RANGELINT_BOUNDS`` anchors, value for value the
reference's."""

from __future__ import annotations

import pytest
import torch

from grapevine_tpu_torch.analysis.rangelint import analyze_ranges
from grapevine_tpu_torch.oblivious import gather_kernels as gk
from grapevine_tpu_torch.oblivious.primitives import scatter_drop
from grapevine_tpu_torch.u32 import c32, narrow, rotl, shr, ule, ult, widen
from _torch_threads import one_torch_thread  # noqa: F401

I32 = torch.int32
FULL = (0, 2**32 - 1)


def _t(*shape, dtype=I32):
    return torch.zeros(shape, dtype=dtype)


def _kinds(rep):
    return {f.kind for f in rep.findings}


def _outs(rep):
    out = next(n for n in rep.capture.gm.graph.nodes if n.op == "output").args[0]
    return [rep.intervals[n] for n in out]


def test_helpers_are_exact_on_a_full_u32_lane():
    def fn(x):
        return (widen(x), shr(x, 5), rotl(x, 7) ^ x, ult(x, c32(0xFFFF0000)), ule(x, 7),
                x ^ c32(0xFFFFFFFF), narrow(widen(x)))

    rep = analyze_ranges(fn, {"x": _t(4)})
    assert rep.ok, rep.summary()
    w, s, r, lt, le, xr, back = _outs(rep)
    assert (w.lo, w.hi) == FULL  # int64, the unsigned value
    assert (s.lo, s.hi, s.lane) == (0, 2**27 - 1, "u32")
    assert (r.lo, r.hi) == FULL and (lt.lo, lt.hi) == (le.lo, le.hi) == (0, 1)
    assert (xr.lo, xr.hi, xr.lane) == (*FULL, "u32")
    assert (back.lo, back.hi, back.lane) == (*FULL, "u32")


def test_widen_keeps_a_bounded_lane_exact():
    rep = analyze_ranges(lambda x: widen(x), {"x": _t(4)}, {"x": (5, 3 * 2**30)})
    assert rep.ok and [(v.lo, v.hi) for v in _outs(rep)] == [(5, 3 * 2**30)]


def test_masked_long_is_clean_and_unmasked_long_reaching_2_31_truncates():
    assert analyze_ranges(lambda x: x.long(), {"x": _t(4)}, {"x": (0, 2**31 - 1)}).ok
    assert analyze_ranges(lambda x: x.long() & 0xFFFFFFFF, {"x": _t(4)}).ok
    rep = analyze_ranges(lambda x: x.long() + 1, {"x": _t(4)}, {"x": (0, 2**31)})
    assert _kinds(rep) == {"trunc-cast"}
    assert "sign-extending" in rep.findings[0].message


def test_narrow_is_clean_when_it_fits_and_wraps_otherwise():
    ok = analyze_ranges(lambda x: narrow(widen(x) * 2), {"x": _t(4)}, {"x": (0, 2**30)})
    assert ok.ok and [(v.lo, v.hi) for v in _outs(ok)] == [(0, 2**31)]
    signed = analyze_ranges(lambda x: narrow(widen(x) - 5), {"x": _t(4)}, {"x": (0, 10)})
    assert signed.ok and [(v.lo, v.hi, v.lane) for v in _outs(signed)] == [(-5, 5, "i32")]
    bad = analyze_ranges(lambda x: narrow(widen(x) * 3), {"x": _t(4)})
    assert _kinds(bad) == {"trunc-cast"} and "narrow" in bad.findings[0].message


def test_a_signed_clamp_does_not_certify_a_u32_lane():
    """``x < n`` and ``minimum`` are signed on int32: a u32 value above
    2^31 reads negative and passes them, so only ``ult`` narrows."""
    def signed(i, t):
        return t[torch.where(i < 16, i, 16).long()]

    def unsigned(i, t):
        return t[torch.where(ult(i, 16), i, 16).long()]

    args = {"i": _t(4), "t": _t(17)}
    assert "oob-index" in _kinds(analyze_ranges(signed, args))
    assert analyze_ranges(unsigned, args).ok


def test_a_negative_sentinel_joins_a_lane_signed():
    """``where(m, u32 index, -1).long()``: the lane's bits and the -1
    sentinel read signed, the drop index scatter_drop expects."""
    def fn(m, ix, plane):
        return scatter_drop(plane, torch.where(m, ix, -1).long(), torch.ones(4, dtype=I32))

    rep = analyze_ranges(fn, {"m": _t(4, dtype=torch.bool), "ix": _t(4), "plane": _t(8)},
                         {"ix": (0, 7)})
    assert rep.ok, rep.summary()


def test_scatter_drop_spill_row_is_in_range():
    def fn(idx, plane, vals):
        return scatter_drop(plane, widen(idx), vals)

    rep = analyze_ranges(fn, {"idx": _t(3), "plane": _t(8, 2), "vals": _t(3, 2)})
    assert rep.ok, rep.summary()


def test_exclusive_rank_is_nonnegative():
    """``cumsum(m) - m`` (``primitives.rank_of``) indexes without a clamp."""
    from grapevine_tpu_torch.oblivious.primitives import rank_of

    rep = analyze_ranges(lambda m, t: t[rank_of(m).long()],
                         {"m": _t(8, dtype=torch.bool), "t": _t(9)})
    assert rep.ok, rep.summary()


@pytest.mark.parametrize("kernel", ["gather_decrypt_rows", "gather_decrypt_rows_tiled"])
def test_kernel_address_operand_against_the_tree_rows(kernel):
    n, z, v = 8, 2, 3

    def fn(key, ti, tv, nonces, flat_b):
        return getattr(gk, kernel)(key, ti, tv, nonces, flat_b, z, 8)

    args = {"key": _t(8), "ti": _t(n * z), "tv": _t(n, z * v), "nonces": _t(n, 2),
            "flat_b": _t(5)}
    rep = analyze_ranges(fn, args, {"flat_b": (0, n)})
    assert _kinds(rep) == {"oob-index"} and "address operand flat_b" in rep.findings[0].message
    clean = analyze_ranges(fn, args, {"flat_b": (0, n - 1)})
    assert clean.ok and clean.kernels == {f"gv.{kernel}": 1}


@pytest.mark.parametrize("kernel", ["scatter_encrypt_rows", "scatter_encrypt_rows_tiled"])
def test_scatter_kernel_addresses_count_only_owned_rows(kernel):
    """A scatter kernel skips non-owner rows whole: ``flat_b`` may hold a
    pad id where ``owner`` is False, never where it is True."""
    n, z, v = 8, 2, 3

    def fn(key, ti, tv, nonces, flat_b, epoch, pidx, pval, owned):
        owner = ult(flat_b, n) & owned
        return getattr(gk, kernel)(key, ti, tv, nonces, flat_b, owner, epoch, pidx, pval, z, 8)

    args = {"key": _t(8), "ti": _t(n * z), "tv": _t(n, z * v), "nonces": _t(n, 2),
            "flat_b": _t(5), "epoch": _t(2), "pidx": _t(5, z), "pval": _t(5, z * v),
            "owned": _t(5, dtype=torch.bool)}
    rep = analyze_ranges(fn, args, {"flat_b": (0, n)})
    assert rep.ok and rep.kernels == {f"gv.{kernel}": 1}, rep.summary()

    def unguarded(key, ti, tv, nonces, flat_b, epoch, pidx, pval, owned):
        return getattr(gk, kernel)(key, ti, tv, nonces, flat_b, owned, epoch, pidx, pval, z, 8)

    assert _kinds(analyze_ranges(unguarded, args, {"flat_b": (0, n)})) == {"oob-index"}


def _ref_engine(log2, pmi, ee, k=0):
    from grapevine_tpu.config import GrapevineConfig as RC
    from grapevine_tpu.engine.state import EngineConfig as RE
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine.state import EngineConfig

    kw = dict(max_messages=1 << log2, max_recipients=max(16, 1 << min(log2, 20)),
              batch_size=4, posmap_impl=pmi, tree_top_cache_levels=k, evict_every=ee)
    return RE.from_config(RC(**kw)), EngineConfig.from_config(GrapevineConfig(**kw))


@pytest.mark.parametrize("geo", [(5, "flat", 1, 0), (8, "recursive", 2, 2), (30, "flat", 4, 2),
                                 (30, "recursive", 2, 0)])
def test_anchors_declare_the_references_bounds(geo):
    """Every anchor declares, label for label, the reference's interval
    (an int32 leaf is a u32 lane) at the reference's audit batch; the
    port adds only its draw inputs, each below its tree's leaf count."""
    from grapevine_tpu.engine import expiry as rexp
    from grapevine_tpu.engine import round_step as rrs
    from grapevine_tpu.oram import path_oram as rpo
    from grapevine_tpu.oram import posmap as rpm
    from grapevine_tpu_torch.engine import expiry, round_step
    from grapevine_tpu_torch.oram import path_oram, posmap

    ref, port = _ref_engine(*geo)
    ours = round_step.RANGELINT_BOUNDS(port)
    theirs = rrs.RANGELINT_BOUNDS(ref)
    assert {k: v for k, v in ours.items() if not k.startswith("draws.")} == theirs
    assert ours["draws.nl_b"] == (0, port.rec.leaves - 1)
    assert ours["draws.dl_a"] == (0, port.mb.leaves - 1)
    assert expiry.RANGELINT_BOUNDS(port) == rexp.RANGELINT_BOUNDS(ref)
    for pc, rc in ((port.rec, ref.rec), (port.mb, ref.mb)):
        assert path_oram.RANGELINT_BOUNDS(pc, "s") == rpo.RANGELINT_BOUNDS(rc, "s")
        assert posmap.RANGELINT_BOUNDS(pc) == rpm.RANGELINT_BOUNDS(rc)


def test_the_overflow_budget_covers_a_production_round():
    """The sticky drop counter's headroom covers everything one round can
    drop (two mailbox rounds, one records round): the reference's 2^16
    at toy B, a larger power of two at B=2048."""
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine import round_step
    from grapevine_tpu_torch.engine.state import EngineConfig
    from grapevine_tpu_torch.oram.path_oram import round_drops

    ecfg = EngineConfig.from_config(GrapevineConfig(
        max_messages=2**20, max_recipients=2**12, batch_size=2048))
    b = round_step.RANGELINT_BOUNDS(ecfg)
    rec = round_drops(ecfg.rec, 2048)
    mb = 2 * round_drops(ecfg.mb, 2048 * ecfg.mb_choices)
    assert rec > 2**16 and mb > 2**16
    assert 2**32 - 1 - b["state.rec.overflow"][1] >= rec
    assert 2**32 - 1 - b["state.mb.overflow"][1] >= mb
    assert b["state.rec.overflow"] == (0, 2**32 - 2**18)
    assert b["state.mb.overflow"] == (0, 2**32 - 2**19)
