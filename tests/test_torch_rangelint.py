"""The port's range analyzer (``grapevine_tpu_torch/analysis/rangelint.py``)
against the reference's (``grapevine_tpu/analysis/rangelint.py``): the
toy programs of ``tests/test_rangelint.py``, each written once in JAX and
once in torch, given the same declared bounds. Both analyzers must give
the same finding kinds, and where both report an interval for a 1:1 op
(add, sub, mul, shift), the same interval (tolerance 0).

The torch forms are the port's idioms for the reference's u32 ops: an
unsigned clamp is ``where(ult(x, n), x, n)`` (a signed ``<`` or
``minimum`` reads a u32 lane above 2^31 as negative), a drop-mode scatter
is ``primitives.scatter_drop``, the reference's u32->int32 index cast is
the sign-extending ``.long()``. The reference's scan rule has no port
counterpart (the port's loops are unrolled); its while rule does.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._higher_order_ops.while_loop import while_loop

from grapevine_tpu.analysis import rangelint as rrl
from grapevine_tpu.analysis.oblint import AllowEntry as RefAllowEntry
from grapevine_tpu_torch.analysis.oblint import AllowEntry
from grapevine_tpu_torch.analysis.rangelint import analyze_ranges, dtype_range
from grapevine_tpu_torch.oblivious.primitives import scatter_drop
from grapevine_tpu_torch.u32 import ult, widen
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

U32 = jnp.uint32
I32 = torch.int32


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, np.uint32)


def _t(*shape):
    return torch.zeros(shape, dtype=I32)


def _kinds(rep):
    return {f.kind for f in rep.findings}


def _ref_outputs(fn, shapes: dict, bounds: dict) -> list:
    """The reference's interval of each output (its walk's own result)."""
    closed = jax.make_jaxpr(fn)(*(_sds(*s) for s in shapes.values()))
    ivs = [tuple(bounds.get(n, rrl.dtype_range(np.uint32))) for n in shapes]
    return rrl._propagate(closed, ivs, rrl._Ctx(()))


def _port_outputs(rep) -> list:
    out = next(n for n in rep.capture.gm.graph.nodes if n.op == "output").args[0]
    return [(rep.intervals[n].lo, rep.intervals[n].hi) for n in out]


def _both(jfn, tfn, shapes: dict, bounds: dict):
    ref = rrl.analyze_ranges(jfn, {n: _sds(*s) for n, s in shapes.items()}, bounds)
    port = analyze_ranges(tfn, {n: _t(*s) for n, s in shapes.items()}, bounds)
    return ref, port


# (name, jax fn, torch fn, shapes, [(bounds, expected kinds)], 1:1 op)
CASES = [
    ("add", lambda x: x + U32(100), lambda x: x + 100, {"x": (4,)},
     [({"x": (0, 1000)}, set()), ({"x": (0, 2**32 - 50)}, {"overflow"})], True),
    ("shift", lambda x: (x << U32(8)) & U32(0xFFFF), lambda x: (x << 8) & 0xFFFF, {"x": (4,)},
     [({"x": (0, 2**30)}, {"overflow"}), ({"x": (0, 2**20)}, set())], False),
    ("shift_alone", lambda x: x << U32(8), lambda x: x << 8, {"x": (4,)},
     [({"x": (0, 2**20)}, set())], True),
    ("mul", lambda r: r * U32(4096), lambda r: r * 4096, {"r": (2,)},
     [({"r": (0, 2**19)}, set()), ({"r": (0, 2**21)}, {"overflow"})], True),
    ("unsigned_sub", lambda a, b: a - b, lambda a, b: a - b, {"a": (2,), "b": (2,)},
     [({"a": (0, 10), "b": (0, 10)}, {"overflow"}), ({"a": (10, 20), "b": (0, 10)}, set())],
     True),
    ("narrowing_cast", lambda x: x.astype(jnp.int32), lambda x: x.long(), {"x": (4,)},
     [({}, {"trunc-cast"}), ({"x": (0, 2**31 - 1)}, set())], False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_same_kinds_and_intervals_as_the_reference(case):
    name, jfn, tfn, shapes, runs, one_to_one = case
    for bounds, want in runs:
        ref, port = _both(jfn, tfn, shapes, bounds)
        assert _kinds(ref) == _kinds(port) == want, (name, bounds, ref.summary(),
                                                     port.summary())
        if one_to_one and not want:
            assert _port_outputs(port) == [tuple(iv) for iv in _ref_outputs(jfn, shapes, bounds)]


def test_dtype_range():
    assert dtype_range(torch.int32) == rrl.dtype_range(np.int32)
    assert dtype_range(torch.int64) == rrl.dtype_range(np.int64)
    assert dtype_range(torch.bool) == rrl.dtype_range(np.bool_) == (0, 1)
    assert dtype_range(torch.float32) is None and rrl.dtype_range(np.float32) is None


def test_gather_oob_flags_and_clamped_gather_clean():
    shapes = {"idx": (4,), "table": (16,)}
    ref, port = _both(lambda i, t: t[i], lambda i, t: t[widen(i)], shapes, {})
    assert "oob-index" in _kinds(ref) and _kinds(port) == {"oob-index"}
    ref, port = _both(lambda i, t: t[jnp.minimum(i, U32(15))],
                      lambda i, t: t[widen(torch.where(ult(i, 15), i, 15))], shapes, {})
    assert ref.ok and port.ok, port.summary()


def test_where_clamp_narrows():
    shapes = {"idx": (4,), "table": (17,)}
    ref, port = _both(lambda i, t: t[jnp.where(i < U32(16), i, U32(16))],
                      lambda i, t: t[torch.where(ult(i, 16), i, 16).long()], shapes, {})
    assert ref.ok and port.ok, port.summary()


def test_drop_mode_scatter_is_the_masking_idiom():
    def jfn(idx, plane):
        return plane.at[jnp.where(idx < U32(8), idx, U32(8))].set(U32(1), mode="drop")

    def tfn(idx, plane):
        tgt = torch.where(ult(idx, 8), idx, 8)
        return scatter_drop(plane, widen(tgt), torch.ones(4, dtype=I32))

    ref, port = _both(jfn, tfn, {"idx": (4,), "plane": (8,)}, {})
    assert ref.ok and port.ok, port.summary()


def test_while_carry_widens_to_lane_and_flags_inside_body():
    def jfn(s):
        return jax.lax.while_loop(lambda c: c[0] < s[0],
                                  lambda c: (c[0] + U32(1), c[1] * U32(2)), (U32(0), U32(1)))

    def tfn(s):
        return while_loop(lambda i, c: i < s[0], lambda i, c: (i + 1, c * 2),
                          (torch.zeros((), dtype=I32), torch.ones((), dtype=I32)))

    ref, port = _both(jfn, tfn, {"s": (1,)}, {})
    assert "overflow" in _kinds(ref) and _kinds(port) == {"overflow"}


def test_scatter_min_bounds_the_owner_map():
    def jfn(hb, cols):
        return jnp.full((64,), U32(8)).at[hb].min(cols) * U32(4)

    def tfn(hb, cols):
        bmap = torch.full((64,), 8, dtype=I32).scatter_reduce(0, hb.long(), cols, "amin")
        return bmap * 4

    bounds = {"hb": (0, 63), "cols": (0, 7)}
    ref, port = _both(jfn, tfn, {"hb": (16,), "cols": (16,)}, bounds)
    assert ref.ok and port.ok, port.summary()
    assert _port_outputs(port) == [(0, 32)] == [tuple(iv) for iv in _ref_outputs(
        jfn, {"hb": (16,), "cols": (16,)}, bounds)]


def test_scatter_add_accumulation_budget():
    def jfn(x, upd):
        return x.at[jnp.zeros((8,), jnp.int32)].add(upd)

    def tfn(x, upd):
        return x.index_add(0, torch.zeros(8, dtype=torch.int64), upd)

    shapes = {"x": (4,), "upd": (8,)}
    for bounds, want in (({"x": (0, 100), "upd": (0, 10)}, set()),
                         ({"x": (0, 100), "upd": (0, 2**30)}, {"overflow"})):
        ref, port = _both(jfn, tfn, shapes, bounds)
        assert _kinds(ref) == _kinds(port) == want


def test_allowlist_admits_by_site_and_counts_hits():
    shapes = {"a": (2,), "b": (2,)}
    ref, port = _both(lambda a, b: a + b, lambda a, b: a + b, shapes, {})
    assert len(ref.findings) == len(port.findings) == 1
    ref_e = RefAllowEntry("add", ref.findings[0].site, "test: the wrap is intended")
    port_e = AllowEntry("aten.add", port.findings[0].site, "test: the wrap is intended")
    ref2 = rrl.analyze_ranges(lambda a, b: a + b, {n: _sds(*s) for n, s in shapes.items()},
                              allowlist=(ref_e,))
    port2 = analyze_ranges(lambda a, b: a + b, {n: _t(*s) for n, s in shapes.items()},
                           allowlist=(port_e,))
    assert ref2.ok and port2.ok
    assert ref2.allowed == {ref_e.key: 1} and port2.allowed == {port_e.key: 1}


def test_trace_abort_is_a_finding_not_a_crash():
    def boom(x):
        raise ValueError("refused: certified bound exceeded")

    ref = rrl.analyze_ranges(boom, {"x": _sds(2)})
    port = analyze_ranges(boom, {"x": _t(2)})
    assert _kinds(ref) == _kinds(port) == {"trace-abort"}
    assert "refused" in port.findings[0].message


def test_data_dependent_capture_is_a_trace_abort():
    """The port's own case: a capture that stops on a data-dependent
    guard (a Python branch on a value) is a finding at its site."""
    def fn(x):
        return x + 1 if x[0] > 3 else x

    rep = analyze_ranges(fn, {"x": _t(2)})
    assert _kinds(rep) == {"trace-abort"}
    assert rep.findings[0].site == "test_torch_rangelint.py:fn"
