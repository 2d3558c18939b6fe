"""Seeded mutants: the analyzers' positive controls (counterpart of
``grapevine_tpu/analysis/mutants.py``).

Each mutant is a small torch program with ONE deliberate defect of a
distinct class, under the reference's name. The gate
(:mod:`.check_oblivious`) and the tests run every mutant through the
same analyzer configuration as the production sweep — production
allowlist included — and require every one to FAIL for its own reason
(its expected violation kind). A mutant that passes means the analyzer
lost its teeth, or an allowlist entry grew into a blanket permission.

The classes: position-dependent branch (``torch.cond``), key-indexed
gather, data-dependent early exit (``while_loop``), secret-shaped output
(a boolean-mask select: it captures with an unbacked size, which the
analyzer reports, and two concrete secrets capture different programs),
un-allowlisted scatter, leaky debug print (a host read of a formatted
secret), python-level branch, flush on buffer contents, and an adaptive
batch window sized from queue contents.

The range mutants (:data:`_RANGE_REGISTRY`, the reference's six, run by
:mod:`.check_ranges` under the production ``RANGE_ALLOWLIST``): each one
deliberate lane escape of a distinct class — u32 heap-id arithmetic past
the lane, a sign-extending ``.long()`` of an unbounded u32 lane, an index
bound equal to its axis, a ``while_loop`` counter the widen-to-lane rule
must flag, an unreset eviction-buffer cursor, and a byte-size product in
an i32 lane.
"""

from __future__ import annotations

import io

import torch

from .oblint import analyze, census_equal
from .rangelint import analyze_ranges

#: every mutant: name -> (maker returning (fn, args, secrets),
#: expected violation kind)
_REGISTRY: dict = {}
#: mutants whose teeth include program equality: name -> two concrete
#: argument sets that must capture different programs
_CENSUS: dict = {}


def _mutant(name: str, kind: str):
    def deco(make):
        _REGISTRY[name] = (make, kind)
        return make
    return deco


def _t(*shape):
    return torch.zeros(shape, dtype=torch.int32)


@_mutant("position_branch", "cond-predicate")
def _position_branch():
    """A branch on an ORAM position: the executed branch (and its device
    time) reveals where the block lives."""
    def fn(pos, table):
        return torch.cond(pos[0] > 7, lambda t: t.sum(), lambda t: (t * 0).sum(), (table,))

    return fn, {"pos": _t(4), "table": _t(16)}, ("pos",)


@_mutant("key_indexed_gather", "gather-index")
def _key_indexed_gather():
    """A table read addressed by the recipient key — the access-pattern
    leak the whole ORAM exists to prevent."""
    def fn(key, table):
        return table[(key % 16).long()]

    return fn, {"key": _t(8), "table": _t(16)}, ("key",)


@_mutant("data_dependent_early_exit", "while-predicate")
def _data_dependent_early_exit():
    """A loop whose trip count depends on the secret: wall-clock (and
    transcript length) becomes a function of the data."""
    from torch._higher_order_ops.while_loop import while_loop

    def fn(secret):
        def cond(i, acc):
            return i < secret[0]

        def body(i, acc):
            return i + 1, acc + i

        return while_loop(cond, body, (torch.zeros((), dtype=torch.int32),
                                       torch.zeros((), dtype=torch.int32)))

    return fn, {"secret": _t(4)}, ("secret",)


@_mutant("secret_shaped_output", "trace-dependence")
def _secret_shaped_output():
    """An output whose SHAPE is the secret (the records that matched): the
    fake capture records an unbacked size, and two concrete secrets
    capture programs of different shapes."""
    def fn(secret):
        return secret[secret > 3]

    return fn, {"secret": _t(4)}, ("secret",)


_CENSUS["secret_shaped_output"] = (
    {"secret": torch.tensor([0, 1, 2, 3], dtype=torch.int32)},
    {"secret": torch.tensor([9, 9, 9, 9], dtype=torch.int32)},
)


@_mutant("unallowlisted_scatter", "scatter-index")
def _unallowlisted_scatter():
    """A scatter targeted by a secret-derived index at a site no review
    admitted — new private state without a proof."""
    def fn(secret, plane):
        out = plane.clone()
        out[(secret[:1] % 16).long()] = 1
        return out

    return fn, {"secret": _t(4), "plane": _t(16)}, ("secret",)


@_mutant("leaky_debug_print", "callback")
def _leaky_debug_print():
    """A debug print of a secret: the host read is an access pattern too
    — it reaches the operator's terminal and logs. (A fake capture
    formats a fake tensor without reading it; the analyzer records the
    read.)"""
    sink = io.StringIO()

    def fn(secret, x):
        print(f"selected leaf {secret[0]}", file=sink)
        return x + 1

    return fn, {"secret": _t(4), "x": _t(8)}, ("secret",)


@_mutant("flush_on_buffer_contents", "cond-predicate")
def _flush_on_buffer_contents():
    """A delayed-eviction flush triggered by buffer occupancy instead of
    the round counter: hot keys dedup to fewer live rows than cold scans,
    so the flush timing becomes a function of the workload. The
    production trigger is a pure round count
    (``engine/batcher.py:_flush_window_locked``)."""
    def fn(ebuf_idx, tree):
        occupancy = (ebuf_idx != -1).sum()
        return torch.cond(occupancy > 8, lambda t: t + 1, lambda t: t.clone(), (tree,))

    return fn, {"ebuf_idx": _t(16), "tree": _t(32)}, ("ebuf_idx",)


@_mutant("adaptive_batch_from_contents", "cond-predicate")
def _adaptive_batch_from_contents():
    """A collection window sized from queue contents instead of public
    aggregates (the production policy, ``server/adaptive.py``, reads the
    queue depth, the arrival rate and the SLO burn rates only)."""
    def fn(payloads, wait):
        hot = (payloads & 1).sum()
        return torch.cond(hot > 4, lambda w: w // 2, lambda w: w.clone(), (wait,))

    return fn, {"payloads": _t(16), "wait": _t(1)}, ("payloads",)


@_mutant("python_level_branch", "trace-dependence")
def _python_level_branch():
    """A host-Python ``if`` on a secret: different paths record different
    programs; the capture stops on the data-dependent guard."""
    def fn(secret):
        if secret[0] > 3:
            return torch.zeros(2, dtype=torch.int32)
        return torch.ones(2, dtype=torch.int32)

    return fn, {"secret": _t(4)}, ("secret",)


# ----------------------------------------------------------------------
# range mutants: name -> (maker returning (fn, args, bounds), kind)
# ----------------------------------------------------------------------

_RANGE_REGISTRY: dict = {}


def _range_mutant(name: str, kind: str):
    def deco(make):
        _RANGE_REGISTRY[name] = (make, kind)
        return make
    return deco


@_range_mutant("u32_leaf_arith_wrap", "overflow")
def _u32_leaf_arith_wrap():
    """Heap-bucket-id arithmetic one recursion level past the certified
    geometry: (2^31 - 1) + 4·leaf at 2^30 leaves wraps the u32 lane."""
    def fn(leaf):
        return leaf * 4 + ((1 << 31) - 1)

    return fn, {"leaf": _t(8)}, {"leaf": (0, (1 << 30) - 1)}


@_range_mutant("truncating_cast", "trunc-cast")
def _truncating_cast():
    """An unbounded u32 lane sign-extended by ``.long()`` into an index:
    every value >= 2^31 turns negative on the way into what it indexes
    (the port's form of the reference's u32->int32 cast)."""
    def fn(x):
        return x.long()

    return fn, {"x": _t(8)}, {}


@_range_mutant("off_by_one_axis_bound", "oob-index")
def _off_by_one_axis_bound():
    """A gather whose declared index bound equals the axis extent — the
    <= vs < slip; a CUDA kernel would read past the table."""
    def fn(idx, table):
        return table[idx.long()]

    return fn, {"idx": _t(4), "table": _t(16)}, {"idx": (0, 16)}


@_range_mutant("unbounded_scan_counter", "overflow")
def _unbounded_scan_counter():
    """A u32 accumulator gaining up to 2^16 an iteration over a 2^20-trip
    ``while_loop``: fine for one step, 2^36 by the end — the carry that
    reaches no fixpoint widens to its lane and the add flags."""
    from torch._higher_order_ops.while_loop import while_loop

    def fn(inc):
        def cond(i, c):
            return i < (1 << 20)

        def body(i, c):
            return i + 1, c + inc[0]

        return while_loop(cond, body, (torch.zeros((), dtype=torch.int32),
                                       torch.zeros((), dtype=torch.int32)))

    return fn, {"inc": _t(2)}, {"inc": (0, 1 << 16)}


@_range_mutant("ebuf_index_overflow", "overflow")
def _ebuf_index_overflow():
    """The delayed-eviction buffer cursor without its window reset:
    ``rounds · window_rows`` with a counter that never resets walks past
    2^32 and the append cursor wraps onto live rows. The production
    program resets ``ebuf_rounds`` at every flush and declares its
    [0, W] budget (``path_oram.RANGELINT_BOUNDS``)."""
    def fn(rounds, leaves):
        return rounds[0] * (1 << 20) + leaves

    return fn, {"rounds": _t(2), "leaves": _t(8)}, {
        "rounds": (0, (1 << 32) - (1 << 16)), "leaves": (0, (1 << 14) - 1)}


@_range_mutant("int32_byte_size_product", "overflow")
def _int32_byte_size_product():
    """A byte length computed in a signed i32 lane: 2^20 rows of a 4 KiB
    row is 2^32 bytes — positive sizes multiply into a negative length."""
    def fn(rows):
        return rows * 4096

    return fn, {"rows": _t(4)}, {"rows": (0, 1 << 20, "i32")}


def range_mutant_names() -> tuple:
    return tuple(_RANGE_REGISTRY)


def run_range_mutants(allowlist=()) -> dict:
    """Analyze every range mutant under ``allowlist``; returns name ->
    (report, expected_kind, failed_as_expected)."""
    out = {}
    for name, (make, kind) in _RANGE_REGISTRY.items():
        fn, args, bounds = make()
        rep = analyze_ranges(fn, args, bounds, allowlist=allowlist,
                             name=f"range_mutant/{name}")
        out[name] = (rep, kind, any(f.kind == kind for f in rep.findings))
    return out


def mutant_names() -> tuple:
    return tuple(_REGISTRY)


def run_mutants(allowlist=()) -> dict:
    """Analyze every mutant under ``allowlist``; returns name ->
    (report, expected_kind, failed_as_expected). A mutant with census
    teeth also captures its two concrete argument sets, and their
    ``program-mismatch`` joins its report's violations."""
    out = {}
    for name, (make, kind) in _REGISTRY.items():
        fn, args, secrets = make()
        rep = analyze(fn, args, secrets, allowlist=allowlist, name=f"mutant/{name}")
        if name in _CENSUS:
            rep.violations = rep.violations + census_equal(
                {f"v{i}": (fn, tuple(a.values())) for i, a in enumerate(_CENSUS[name])},
                name=f"mutant/{name}")
        hit = any(v.kind == kind for v in rep.violations)
        out[name] = (rep, kind, hit)
    return out


def control_failures(results: dict, flavor: str, log=print) -> list:
    """Print one status line per mutant via ``log`` and return the
    not-caught failures; reads oblint reports (``violations``), rangelint
    reports and cost-model mismatches (``findings``)."""
    failures = []
    for name, (rep, kind, hit) in results.items():
        log(f"{flavor} {name}: {'FAIL (expected)' if hit else 'PASSED — NO TEETH'}")
        if not hit:
            got = [v.kind for v in getattr(rep, "violations", None)
                   or getattr(rep, "findings", [])]
            failures.append(f"{flavor} {name!r} was NOT caught (expected a {kind}; got "
                            f"{got})")
    return failures
