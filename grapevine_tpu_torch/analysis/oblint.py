"""Oblint: taint-propagation obliviousness analyzer over a captured FX
graph (counterpart of ``grapevine_tpu/analysis/oblint.py``).

Secret inputs (recipient keys, msg ids, ORAM positions, stash, cache and
eviction-buffer contents, cipher keys, per-op payloads, the round's
random draws — declared as ``OBLINT_SECRETS`` anchors next to the code
where each secret enters: ``oram/round.py``, ``oram/posmap.py``,
``engine/round_step.py``, ``engine/expiry.py``) are tainted at their
placeholders, and the analyzer walks the graph :func:`.fx_walk.capture`
made, proving that nothing secret-derived reaches an access-deciding
sink:

- ``gather-index``: the index operand of ``index.Tensor``,
  ``index_select``, ``gather``, ``take``;
- ``scatter-index``: the index operand of ``index_put``, ``scatter*``,
  ``index_add``, ``index_copy``, ``index_fill``;
- ``dynamic-slice-start``: a slice, narrow or select whose start is a
  value read from a tensor;
- ``cond-predicate`` / ``while-predicate``: the predicate of
  ``torch.cond`` / ``while_loop``;
- ``callback``: any read of a tensor's values by the host (the capture's
  ``host_read`` nodes, ``item``'s ``_local_scalar_dense``, a copy from
  the card to the CPU) — it reaches the operator's process;
- the port's kernels, one node each: an operand that decides the
  kernel's memory addresses is a gather/scatter index (``flat_b`` of the
  fused gathers, ``flat_b`` and ``owner`` of the fused scatters: the
  Pallas kernels' scalar-prefetch index maps). The row cipher reads row
  i at row i and has none.

Taint transfer is a conservative union over every op (a leak can only be
over-reported, never missed): a kernel's outputs carry the union of its
inputs, so the key taint marks decrypted rows secret. ``cond`` branches
are walked and a secret predicate taints every branch output;
``while_loop`` bodies run to a carry-taint fixpoint. A capture that stops
on a data-dependent guard, and a node whose output shape depends on a
secret (an unbacked size), are ``trace-dependence`` violations: Python
control flow or shapes that follow the secret.

Sites that are oblivious by construction are admitted through the
reviewed allowlist (:mod:`.allowlist`), keyed ``aten_op@file.py:function``;
:func:`census_equal` captures the same program at adversarially
different concrete secrets and requires identical op censuses.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterable

import torch

from .fx_walk import (
    bound_args,
    capture,
    census,
    inner_op,
    op_name,
    subgraphs,
    walk_nodes,
)

EMPTY: frozenset = frozenset()

#: sinks: op-name prefixes whose ``indices``/``index`` operand decides
#: the addresses read (gathers) or written (scatters)
_GATHERS = ("aten.index.", "aten._unsafe_index.", "aten.index_select.", "aten.gather.",
            "aten.take.", "aten.embedding.")
_SCATTERS = ("aten.index_put.", "aten._unsafe_index_put.", "aten._index_put_impl.",
             "aten.scatter.", "aten.scatter_add.", "aten.scatter_reduce.",
             "aten.index_add.", "aten.index_copy.", "aten.index_fill.",
             "aten.index_reduce.")
_SLICES = ("aten.slice.", "aten.narrow.", "aten.select.", "aten.as_strided.",
           "aten.slice_scatter.", "aten.select_scatter.", "aten.split.",
           "aten.split_with_sizes.", "aten.unfold.")
#: kernel op -> (sink kind, operands that decide its memory addresses):
#: the Pallas kernels' scalar-prefetch index maps
#: (``grapevine_tpu/oblivious/pallas_gather.py``); the row cipher reads
#: row i at row i and has none
KERNEL_ADDRESS_OPERANDS = {
    "gv.gather_decrypt_rows": ("gather-index", ("flat_b",)),
    "gv.gather_decrypt_rows_tiled": ("gather-index", ("flat_b",)),
    "gv.scatter_encrypt_rows": ("scatter-index", ("flat_b", "owner")),
    "gv.scatter_encrypt_rows_tiled": ("scatter-index", ("flat_b", "owner")),
    "gv.cipher_rows_pallas": ("gather-index", ()),
}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One secret-derived value reaching an access-deciding sink."""

    kind: str  # gather-index | scatter-index | dynamic-slice-start |
    #            cond-predicate | while-predicate | callback |
    #            trace-dependence | program-mismatch
    site: str  # "file.py:function" (fx_walk.site_of key)
    prim: str  # op name ("" for capture-level findings)
    labels: tuple  # sorted secret labels that reached the sink
    message: str = ""

    def __str__(self) -> str:
        via = f" via {', '.join(self.labels)}" if self.labels else ""
        msg = f" — {self.message}" if self.message else ""
        return f"{self.kind}: {self.prim or '<trace>'} at {self.site}{via}{msg}"


@dataclasses.dataclass(frozen=True)
class AllowEntry:
    """One reviewed oblivious-by-construction sink site.

    ``prim`` matches an op name exactly or as its overload packet
    (``"aten.index_put"`` covers ``aten.index_put.default``); ``site`` is
    the ``file.py:function`` key; ``reason`` the one-line leak argument."""

    prim: str
    site: str
    reason: str

    @property
    def key(self) -> str:
        return f"{self.prim}@{self.site}"

    def matches(self, v: Violation) -> bool:
        if v.site != self.site:
            return False
        return v.prim == self.prim or v.prim.startswith(self.prim + ".")


@dataclasses.dataclass
class OblintReport:
    """Outcome of one analysis: surviving violations, allowlist hits
    (entry.key -> count), the captured program's op census, and the
    capture (``capture.gm`` the graph) with its and the walk's seconds."""

    name: str
    violations: list
    allowed: dict
    census: dict
    n_eqns: int = 0
    capture: object = None
    audit_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        lines = [
            f"[oblint] {self.name}: {len(self.violations)} violation(s), "
            f"{sum(self.allowed.values())} allowlisted sink(s) at "
            f"{len(self.allowed)} site(s), {self.n_eqns} nodes"
        ]
        lines += [f"  VIOLATION {v}" for v in self.violations]
        return "\n".join(lines)


class _Ctx:
    """Mutable walk state: violations dedup + allowlist hit counts."""

    def __init__(self, allowlist: Iterable[AllowEntry]):
        self.allowlist = tuple(allowlist)
        self.violations: dict = {}
        self.allowed: dict = {}

    def sink(self, kind: str, site: str, prim: str, labels: frozenset, message: str = ""):
        if not labels:
            return
        v = Violation(kind=kind, site=site, prim=prim, labels=tuple(sorted(labels)),
                      message=message)
        for entry in self.allowlist:
            if entry.matches(v):
                self.allowed[entry.key] = self.allowed.get(entry.key, 0) + 1
                return
        self.violations.setdefault((v.kind, v.site, v.prim, v.labels), v)


def _union(ts) -> frozenset:
    return frozenset().union(*ts) if ts else EMPTY


def _is_scalar_node(a) -> bool:
    """A node whose value is a Python scalar read from a tensor (a SymInt
    or SymBool): the start of a slice built from it depends on data."""
    return isinstance(a, torch.fx.Node) and isinstance(
        a.meta.get("val"), (torch.SymInt, torch.SymBool, torch.SymFloat))


def _data_shaped(node) -> bool:
    """Has the node's output a size the capture could not know (an
    unbacked symbol: a shape that follows the data)?"""
    from torch.fx.experimental.symbolic_shapes import free_unbacked_symbols

    vals = node.meta.get("val")
    vals = vals if isinstance(vals, (list, tuple)) else [vals]
    return any(isinstance(v, torch.Tensor) and free_unbacked_symbols(v.shape)
               for v in vals)


def _propagate(gm, in_taints: list, ctx: _Ctx, parent_site: str = "<unknown>") -> list:
    """Walk one graph, return per-output taints."""
    env: dict = {}

    def read(a):
        if isinstance(a, torch.fx.Node):
            t = env.get(a, EMPTY)
            return _union(t) if isinstance(t, list) else t
        if isinstance(a, (list, tuple)):
            return _union([read(x) for x in a])
        if isinstance(a, dict):
            return _union([read(x) for x in a.values()])
        return EMPTY

    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for n, t in zip(placeholders, in_taints):
        env[n] = t
    outs: list = []
    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            continue
        if node.op == "output":
            res = node.args[0]
            outs = [read(x) for x in (res if isinstance(res, (list, tuple)) else [res])]
            continue
        site = node.meta.get("gv_site") or parent_site
        name = op_name(node.target)
        union = _union([read(a) for a in node.args] + [read(a) for a in node.kwargs.values()])

        # ---- sinks -----------------------------------------------------
        if name.startswith(_GATHERS + _SCATTERS):
            bound = bound_args(node)
            idx = read(bound.get("indices", bound.get("index")))
            if name.startswith(_GATHERS):
                ctx.sink("gather-index", site, name, idx,
                         "gather indexed by a secret-derived value")
            else:
                ctx.sink("scatter-index", site, name, idx,
                         "scatter targeted by a secret-derived value")
        elif name.startswith(_SLICES):
            ctx.sink("dynamic-slice-start", site, name,
                     _union([read(a) for a in node.args[1:] if _is_scalar_node(a)]),
                     "slice start derived from a secret")
        elif name == "gv_analysis.host_read.default":
            ctx.sink("callback", site, f"host_read.{node.args[1]}", read(node.args[0]),
                     "secret-derived value read by the host")
        elif name in ("aten._local_scalar_dense.default", "aten.item.default"):
            ctx.sink("callback", site, name, union,
                     "secret-derived value read by the host")
        elif name in ("aten._to_copy.default", "aten.copy.default"):
            src = bound_args(node).get("src" if name == "aten.copy.default" else "self")
            dst = node.meta.get("val")
            sv = src.meta.get("val") if isinstance(src, torch.fx.Node) else None
            if isinstance(dst, torch.Tensor) and isinstance(sv, torch.Tensor) \
                    and dst.device.type == "cpu" and sv.device.type != "cpu":
                ctx.sink("callback", site, name, read(src),
                         "secret-derived value copied to the host")
        kern = op_name(inner_op(node) or node.target).rsplit(".", 1)[0]
        if kern in KERNEL_ADDRESS_OPERANDS:
            kind, operands = KERNEL_ADDRESS_OPERANDS[kern]
            bound = bound_args(node)
            ctx.sink(kind, site, kern, _union([read(bound.get(o)) for o in operands]),
                     "kernel addresses decided by a secret-derived value")
        if _data_shaped(node):
            ctx.sink("trace-dependence", site, name, union,
                     "output shape follows a secret-derived value")

        # ---- taint transfer --------------------------------------------
        if name == "higher_order.cond":
            pred = read(node.args[0])
            ctx.sink("cond-predicate", site, name, pred,
                     "branch selected by a secret-derived predicate")
            operands = [read(a) for a in node.args[3]]
            res = None
            for br in subgraphs(gm, node)[:2]:
                bouts = _propagate(br, operands, ctx, site)
                res = bouts if res is None else [a | b for a, b in zip(res, bouts)]
            env[node] = [t | pred for t in (res or [])]
        elif name == "higher_order.while_loop":
            cond_gm, body_gm = subgraphs(gm, node)[:2]
            carry = [read(a) for a in node.args[2]]
            extra = [read(a) for a in node.args[3]] if len(node.args) > 3 else []
            for _ in range(len(carry) + 1):
                nxt = _propagate(body_gm, carry + extra, ctx, site)
                merged = [a | b for a, b in zip(carry, nxt)]
                if merged == carry:
                    break
                carry = merged
            ctx.sink("while-predicate", site, name,
                     _union(_propagate(cond_gm, carry + extra, ctx, site)),
                     "loop trip count depends on a secret")
            env[node] = carry
        elif name == "getitem":
            src = env.get(node.args[0], EMPTY)
            env[node] = src[node.args[1]] if isinstance(src, list) \
                and node.args[1] < len(src) else read(node.args[0])
        else:
            subs = subgraphs(gm, node)
            for sub in subs:  # any other subgraph: broadcast the union
                n_in = sum(1 for n in sub.graph.nodes if n.op == "placeholder")
                union = union | _union(_propagate(sub, [union] * n_in, ctx, site))
            env[node] = union
    return outs


def _secret_match(label: str, prefixes) -> bool:
    return any(label == p or label.startswith(p + ".") for p in prefixes)


def audit(cap, secrets: Iterable[str], allowlist: Iterable[AllowEntry] = ()) -> OblintReport:
    """Taint-check one :class:`.fx_walk.Capture`."""
    secrets = tuple(secrets)
    if cap.gm is None:  # the capture stopped: data-dependent Python
        site, msg = cap.dependence
        v = Violation(kind="trace-dependence", site=site, prim="", labels=(),
                      message="capture stopped on a data-dependent Python branch or "
                              f"shape: {msg}")
        return OblintReport(cap.name, [v], {}, {}, capture=cap)
    t0 = time.perf_counter()
    ctx = _Ctx(allowlist)
    in_taints = [frozenset([lb]) if _secret_match(lb, secrets) else EMPTY
                 for lb in cap.labels]
    n_ph = sum(1 for n in cap.gm.graph.nodes if n.op == "placeholder")
    if len(in_taints) != n_ph:
        raise ValueError(f"oblint: {len(in_taints)} labelled inputs vs {n_ph} placeholders")
    _propagate(cap.gm, in_taints, ctx)
    return OblintReport(
        name=cap.name,
        violations=sorted(ctx.violations.values(), key=lambda v: (v.site, v.kind)),
        allowed=dict(ctx.allowed),
        census=dict(census(cap.gm)),
        n_eqns=sum(1 for _ in walk_nodes(cap.gm)),
        capture=cap,
        audit_s=time.perf_counter() - t0,
    )


def analyze(
    fn: Callable,
    args: dict,
    secrets: Iterable[str],
    allowlist: Iterable[AllowEntry] = (),
    name: str = "program",
) -> OblintReport:
    """Capture ``fn(*args.values())`` and taint-check the graph.

    ``args`` maps argument name -> example value (tensors, pytrees of
    them; in "fake" mode nothing runs, so any tensors of the right shapes
    do). ``secrets`` are dotted label prefixes over those names
    (``"batch.auth"``, ``"state.rec.posmap"``): every leaf under a prefix
    is tainted with its own full label, so a violation names the exact
    secret that reached the sink."""
    cap = capture(fn, *args.values(), names=list(args), name=name)
    return audit(cap, secrets, allowlist)


def census_equal(variants: dict, name: str = "program") -> list:
    """Capture each ``variants[vname] = (fn, args)`` — secrets as
    concrete tensors, so a Python branch on one, a shortcut for special
    values or a secret-shaped output records a different program — and
    require identical op censuses, output shapes included. Returns
    ``program-mismatch`` violations (empty = pass); a capture that stops
    is a ``trace-dependence`` violation."""
    censuses, out = {}, []
    for vname, (fn, args) in variants.items():
        cap = capture(fn, *args, tracing_mode="real", name=f"{name}/{vname}")
        if cap.gm is None:
            out.append(Violation(kind="trace-dependence", site=cap.dependence[0], prim="",
                                 labels=(vname,), message=cap.dependence[1]))
            continue
        censuses[vname] = census(cap.gm, shapes=True)
    if not censuses:
        return out
    base_name, base = next(iter(censuses.items()))
    for vname, c in censuses.items():
        if c != base:
            diff = (c - base) + (base - c)
            out.append(Violation(
                kind="program-mismatch", site=name, prim="", labels=(vname, base_name),
                message=(f"secret instantiation {vname!r} captures a DIFFERENT program "
                         f"than {base_name!r}: {dict(list(diff.items())[:6])} — the "
                         "round depends on the secret values"),
            ))
    return out
