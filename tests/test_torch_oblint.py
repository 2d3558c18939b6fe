"""The port's taint analyzer (``grapevine_tpu_torch/analysis/oblint.py``)
against the reference's (``grapevine_tpu/analysis/oblint.py``): the
counterparts of the propagation units of ``tests/test_oblint.py``, one
small program per op class, pinning the flow (a secret reaches the
sink) and the non-flow (public indices stay clean).

Each case runs the same program written twice, in JAX and in torch,
through both analyzers: equal verdicts, and the reference's violation
kinds among the port's. Where torch has no counterpart of a JAX
primitive the port's extra kind is named (a slice start read from a
tensor is also a host read, ``callback``). The callback case is red on
the JAX side under jax 0.9.0, so there the port's result stands alone.
"""

from __future__ import annotations

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._higher_order_ops.while_loop import while_loop

from grapevine_tpu.analysis.oblint import AllowEntry as RefAllowEntry
from grapevine_tpu.analysis.oblint import analyze as ref_analyze
from grapevine_tpu_torch.analysis.oblint import AllowEntry, analyze
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

U32 = jnp.uint32
I32 = torch.int32


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, np.uint32)


def _t(*shape):
    return torch.zeros(shape, dtype=I32)


def _kinds(rep):
    return {v.kind for v in rep.violations}


# --- the programs, as (jax fn, torch fn, shapes, secrets, port-only kinds);
# a kind written "ref>port" is the reference's kind and the port's for
# the same finding where the two idioms differ


def _elementwise():
    def jfn(s, p):
        mixed = (s * 2 + p).astype(U32) ^ s
        return p[mixed % 4], p[p % 4]

    def tfn(s, p):
        mixed = (s * 2 + p) ^ s
        return p[(mixed % 4).long()], p[(p % 4).long()]

    return jfn, tfn, {"s": (4,), "p": (4,)}, ("s",), set()


def _gather():
    return (lambda s, table: table[s % 8],
            lambda s, table: table[(s % 8).long()],
            {"s": (4,), "table": (8,)}, ("s",), set())


def _scatter_family():
    def jfn(s, plane):
        return plane.at[s % 8].set(U32(1)), plane.at[s % 8].add(U32(1))

    def tfn(s, plane):
        a = plane.clone()
        a[(s % 8).long()] = 1
        return a, plane.index_add(0, (s % 8).long(), torch.ones(4, dtype=I32))

    return jfn, tfn, {"s": (4,), "plane": (8,)}, ("s",), set()


def _dynamic_slice():
    return (lambda s, x: jax.lax.dynamic_slice(x, (s[0].astype(jnp.int32),), (2,)),
            lambda s, x: torch.narrow(x, 0, s[0], 2),
            {"s": (2,), "x": (8,)}, ("s",), {"callback"})


def _select_and_sort():
    def jfn(s, p, table):
        return table[jnp.argsort(jnp.where(s > 0, s, p))]

    def tfn(s, p, table):
        return table[torch.argsort(torch.where(s > 0, s, p), stable=True)]

    return jfn, tfn, {"s": (4,), "p": (4,), "table": (4,)}, ("s",), set()


def _cond():
    def jfn(s, table):
        return jax.lax.cond(s[0] > 1, lambda: table[s % 4].sum(),
                            lambda: jnp.zeros((), U32))

    def tfn(s, table):
        return torch.cond(s[0] > 1, lambda s, t: t[(s % 4).long()].sum(),
                          lambda s, t: (t * 0).sum(), (s, table))

    return jfn, tfn, {"s": (4,), "table": (4,)}, ("s",), set()


def _while_carry():
    """The secret enters the predicate only through the carry after one
    body pass: catches a walk without the fixpoint."""
    def jfn(s):
        def body(c):
            i, acc = c
            return i + U32(1), acc | s[0]

        def cond(c):
            i, acc = c
            return (i < U32(3)) | (acc > U32(0))

        return jax.lax.while_loop(cond, body, (U32(0), U32(0)))

    def tfn(s):
        def body(i, acc):
            return i + 1, acc | s[0]

        def cond(i, acc):
            return (i < 3) | (acc > 0)

        return while_loop(cond, body, (torch.zeros((), dtype=I32),
                                       torch.zeros((), dtype=I32)))

    return jfn, tfn, {"s": (2,)}, ("s",), set()


def _carry_index():
    """A loop carry that turns secret after one step then indexes: the
    reference's scan (a dynamic slice on the carry), the port's unrolled
    loop (a gather by a 1-element index)."""
    def jfn(s, table):
        def body(c, x):
            return c + s[0], table[c % 4]

        return jax.lax.scan(body, U32(0), jnp.arange(3, dtype=U32))

    def tfn(s, table):
        c, ys = torch.zeros(1, dtype=I32), []
        for _ in range(3):
            ys.append(table[(c % 4).long()])
            c = c + s[0]
        return c, torch.stack(ys)

    return jfn, tfn, {"s": (2,), "table": (4,)}, ("s",), {"dynamic-slice-start>gather-index"}


def _clean_carry():
    def jfn(s, table):
        def body(c, x):
            return c + x, table[x % 4] + s[0]

        return jax.lax.scan(body, U32(0), jnp.arange(3, dtype=U32))

    def tfn(s, table):
        c, ys = torch.zeros(1, dtype=I32), []
        for x in range(3):
            ys.append(table[x % 4] + s[0])
            c = c + x
        return c, torch.stack(ys)

    return jfn, tfn, {"s": (2,), "table": (4,)}, ("s",), set()


def _nesting():
    @jax.jit
    def inner(s, table):
        return table[s % 4]

    def tinner(s, table):
        return table[(s % 4).long()]

    return (lambda s, table: inner(s, table) + 1, lambda s, table: tinner(s, table) + 1,
            {"s": (4,), "table": (4,)}, ("s",), set())


CASES = {
    "elementwise_propagates_public_stays_clean": _elementwise,
    "gather_by_secret": _gather,
    "scatter_family_by_secret": _scatter_family,
    "dynamic_slice_start_by_secret": _dynamic_slice,
    "select_and_sort_transmit_without_sinking": _select_and_sort,
    "cond_predicate_and_branches": _cond,
    "while_predicate_via_carry_fixpoint": _while_carry,
    "carry_turns_secret_then_indexes": _carry_index,
    "clean_carry_passes": _clean_carry,
    "nested_function_walked": _nesting,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_and_reference_agree(case):
    jfn, tfn, shapes, secrets, port_extra = CASES[case]()
    ref = ref_analyze(jfn, {k: _sds(*s) for k, s in shapes.items()}, secrets=secrets)
    port = analyze(tfn, {k: _t(*s) for k, s in shapes.items()}, secrets=secrets)
    assert ref.ok == port.ok, (ref.summary(), port.summary())
    same = dict(k.split(">") for k in port_extra if ">" in k)
    want = {same.get(k, k) for k in _kinds(ref)}
    assert want <= _kinds(port) <= want | {k for k in port_extra if ">" not in k}, (
        ref.summary(), port.summary())
    for v in port.violations:  # every finding names the secret
        assert "s" in v.labels


def test_only_the_secret_indexed_gather_is_flagged():
    _, tfn, shapes, secrets, _ = _elementwise()
    rep = analyze(tfn, {k: _t(*s) for k, s in shapes.items()}, secrets=secrets)
    assert len(rep.violations) == 1 and rep.violations[0].labels == ("s",)


def test_cond_flags_the_predicate_and_the_branch_gather():
    _, tfn, shapes, secrets, _ = _cond()
    rep = analyze(tfn, {k: _t(*s) for k, s in shapes.items()}, secrets=secrets)
    assert _kinds(rep) == {"cond-predicate", "gather-index"}


def test_callback_sink_flagged():
    """A debug print of a secret (the reference's jax.debug.print case;
    red on the JAX side under jax 0.9.0, so the port's alone)."""
    sink = io.StringIO()

    def fn(s, x):
        print(f"leaf {s[0]}", file=sink)
        return x

    rep = analyze(fn, {"s": _t(2), "x": _t(2)}, secrets=("s",))
    assert _kinds(rep) == {"callback"}
    for read in ("item", "tolist"):
        rep = analyze(lambda s, x, r=read: (getattr(s[0], r)(), x)[1],
                      {"s": _t(2), "x": _t(2)}, secrets=("s",))
        assert "callback" in _kinds(rep), (read, rep.summary())


def test_copy_to_the_host_is_a_callback():
    rep = analyze(lambda s, x: s.cpu() if s.device.type != "cpu" else x,
                  {"s": _t(2), "x": _t(2)}, secrets=("s",))
    assert rep.ok  # on the CPU there is no copy

    def fn(s, x):
        return x + s.to("meta").sum().to("cpu")

    rep = analyze(fn, {"s": _t(2).to("meta"), "x": _t(1)}, secrets=("s",))
    assert "callback" in _kinds(rep), rep.summary()


def test_secret_prefix_matches_pytree_paths():
    jstate = {"stash": _sds(4), "nonces": _sds(4)}
    tstate = {"stash": _t(4), "nonces": _t(4)}
    ref = ref_analyze(lambda st, table: (table[st["stash"] % 4], table[st["nonces"] % 4]),
                      {"state": jstate, "table": _sds(4)}, secrets=("state.stash",))
    port = analyze(lambda st, table: (table[(st["stash"] % 4).long()],
                                      table[(st["nonces"] % 4).long()]),
                   {"state": tstate, "table": _t(4)}, secrets=("state.stash",))
    assert [v.labels for v in port.violations] == [v.labels for v in ref.violations] \
        == [("state.stash",)]


def test_allowlist_admits_and_counts_hits():
    def fn(s, table):
        return table[(s % 4).long()]

    args = {"s": _t(4), "table": _t(4)}
    site = analyze(fn, args, secrets=("s",)).violations[0].site
    allowed = analyze(fn, args, secrets=("s",),
                      allowlist=(AllowEntry("aten.index", site, "test entry"),))
    assert allowed.ok and allowed.allowed == {f"aten.index@{site}": 1}
    # the same admission on the reference's side
    jbare = ref_analyze(lambda s, t: t[s % 4], {"s": _sds(4), "table": _sds(4)},
                        secrets=("s",))
    jsite = jbare.violations[0].site
    jallowed = ref_analyze(lambda s, t: t[s % 4], {"s": _sds(4), "table": _sds(4)},
                           secrets=("s",),
                           allowlist=(RefAllowEntry("gather", jsite, "test"),))
    assert jallowed.ok and sum(jallowed.allowed.values()) == 1


def test_allow_entry_matches_its_overload_packet_only():
    from grapevine_tpu_torch.analysis.oblint import Violation

    e = AllowEntry("aten.index", "x.py:f", "r")
    hit = Violation("gather-index", "x.py:f", "aten.index.Tensor", ("s",))
    assert e.matches(hit)
    assert not e.matches(hit.__class__("scatter-index", "x.py:f",
                                       "aten.index_put.default", ("s",)))
    assert not e.matches(hit.__class__("gather-index", "y.py:f", "aten.index.Tensor",
                                       ("s",)))
