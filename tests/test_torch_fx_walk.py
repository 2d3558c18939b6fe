"""The port's capture layer (``grapevine_tpu_torch/analysis/fx_walk.py``):
labelled pytree inputs, the functionalized graph (a read after an
in-place write points at the write), the node walk and census (into
higher-order subgraphs and ``auto_functionalized``), sites, plane rows,
host reads as nodes, and a data-dependent capture as a finding."""

from __future__ import annotations

from typing import NamedTuple

import torch

from grapevine_tpu_torch.analysis import fx_walk
from grapevine_tpu_torch.analysis.oblint import analyze
from _torch_threads import one_torch_thread  # noqa: F401


def _t(*shape):
    return torch.zeros(shape, dtype=torch.int32)


class _Pair(NamedTuple):
    a: torch.Tensor
    b: dict


def test_flatten_labels_and_rebuild():
    value = _Pair(_t(2), {"x": _t(3), "gen": torch.Generator(), "n": 4, "l": [_t(1)]})
    labels, ts, rebuild = fx_walk.flatten(value, "state")
    assert labels == ["state.a", "state.b.x", "state.b.l.0"]
    new = [t + 1 for t in ts]
    back = rebuild(new)
    assert isinstance(back, _Pair) and back.b["n"] == 4
    assert back.b["gen"] is value.b["gen"]
    assert torch.equal(back.b["l"][0], new[2])


def test_capture_labels_placeholders_and_sites():
    def fn(state, x):
        return state.a * 2 + x.sum()

    cap = fx_walk.capture(fn, _Pair(_t(2), {"x": _t(3)}), _t(4), names=("state", "x"))
    ph = [n for n in cap.gm.graph.nodes if n.op == "placeholder"]
    assert cap.labels == ["state.a", "state.b.x", "x"] and len(ph) == 3
    sites = {fx_walk.site_of(n) for n in fx_walk.walk_nodes(cap.gm)}
    assert sites == {"test_torch_fx_walk.py:fn"}


def test_functionalized_mutation_is_an_ssa_value():
    """A read of a tensor after an in-place write points at the write's
    node: the taint of a secret written in place reaches a later index."""
    def fn(s, buf, table):
        buf[0:1] = s[0:1]  # in place: buf now holds a secret
        return table[buf.long()]

    cap = fx_walk.capture(fn, _t(2), _t(1), _t(8), names=("s", "buf", "table"))
    ops = [fx_walk.op_name(n.target) for n in fx_walk.walk_nodes(cap.gm)]
    assert not any(o.endswith("_.default") or o.startswith("aten.copy_") for o in ops), ops
    rep = analyze(fn, {"s": _t(2), "buf": _t(1), "table": _t(8)}, secrets=("s",))
    assert [v.kind for v in rep.violations] == ["gather-index"]
    assert rep.violations[0].labels == ("s",)


def test_census_and_walk_recurse_into_subgraphs():
    def fn(p, table):
        return torch.cond(p[0] > 0, lambda t: (t * 3).sum(), lambda t: (t - 1).sum(),
                          (table,))

    cap = fx_walk.capture(fn, _t(2), _t(4))
    c = fx_walk.census(cap.gm)
    assert c["higher_order.cond"] == 1
    assert c["aten.mul.Tensor"] == 1 and c["aten.sub.Tensor"] == 1  # both branches
    assert sum(c.values()) == sum(1 for _ in fx_walk.walk_nodes(cap.gm))
    shaped = fx_walk.census(cap.gm, shapes=True)
    assert sum(shaped.values()) == sum(c.values())


def test_kernel_ops_are_nodes_and_auto_functionalized_counts_its_op():
    from grapevine_tpu_torch.oblivious import gather_kernels as gk

    n, z, v = 8, 2, 3

    def fn(key, ti, tv, nonces, flat_b, owner, epoch):
        pi, pv = gk.gather_decrypt_rows(key, ti, tv, nonces, flat_b, z, 8)
        gk.scatter_encrypt_rows(key, ti, tv, nonces, flat_b, owner, epoch, pi, pv, z, 8)
        return ti, tv, nonces

    args = (_t(8), _t(n * z), _t(n, z * v), _t(n, 2), _t(3),
            torch.ones(3, dtype=torch.bool), _t(2))
    cap = fx_walk.capture(fn, *args)
    assert dict(fx_walk.kernel_nodes(cap.gm)) == {"gather_decrypt_rows": 1,
                                                  "scatter_encrypt_rows": 1}
    c = fx_walk.census(cap.gm)
    assert any(k.startswith("higher_order.auto_functionalized") for k in c)
    rows = fx_walk.plane_rows(cap.gm, {"tree_val": ((n, z * v), 1)})
    assert sorted(rows["tree_val"]) == [("gv.gather_decrypt_rows", 3),
                                        ("gv.scatter_encrypt_rows", 3)]


def test_plane_rows_gathers_and_scatters():
    def fn(plane, rows, vals):
        got = plane[rows.long()]
        out = plane.clone()
        out[rows.long()] = vals
        return got, out

    cap = fx_walk.capture(fn, _t(16, 4), _t(5), _t(5, 4))
    rows = fx_walk.plane_rows(cap.gm, {"p": ((16, 4), 1), "q": ((16, 8), 1)})
    assert rows == {"p": [("aten.index.Tensor", 5), ("aten.index_put.default", 5)],
                    "q": []}


def test_host_reads_are_recorded_as_nodes():
    def fn(s, x):
        print(f"{s[0]}", file=open("/dev/null", "w"))  # a formatted host read
        return x + 1

    cap = fx_walk.capture(fn, _t(2), _t(2))
    reads = [n for n in fx_walk.walk_nodes(cap.gm)
             if fx_walk.op_name(n.target) == "gv_analysis.host_read.default"]
    assert [n.args[1] for n in reads] == ["__format__"]


def test_data_dependent_capture_is_a_trace_dependence_violation():
    def fn(s):
        if s[0] > 3:
            return s + 1
        return s

    cap = fx_walk.capture(fn, _t(2))
    assert cap.gm is None
    site, msg = cap.dependence
    assert site == "test_torch_fx_walk.py:fn"
    assert msg.split(":")[0] in fx_walk.DEPENDENCE_ERRORS
    rep = analyze(fn, {"s": _t(2)}, secrets=("s",))
    assert [v.kind for v in rep.violations] == ["trace-dependence"]
    assert rep.violations[0].site == site


def test_package_sites_skip_primitive_helpers():
    """A helper that stands for one JAX primitive is not a site: its
    caller is, as the primitive's would be in the reference."""
    from grapevine_tpu_torch.oblivious.primitives import scatter_drop

    def fn(plane, idx, vals):
        return scatter_drop(plane, idx.long(), vals)

    cap = fx_walk.capture(fn, _t(8), _t(3), _t(3))
    puts = [n for n in fx_walk.walk_nodes(cap.gm)
            if fx_walk.op_name(n.target).startswith("aten.index_put")]
    assert puts and {fx_walk.site_of(n) for n in puts} == {"test_torch_fx_walk.py:fn"}
