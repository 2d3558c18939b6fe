"""Rangelint: interval-domain overflow certification of a captured round
(counterpart of ``grapevine_tpu/analysis/rangelint.py``).

An abstract interpreter over the functional FX graph :func:`.fx_walk.capture`
makes (the node stream :func:`.fx_walk.walk_nodes` yields, the one the
taint walk reads): every integer value carries one ``[lo, hi]`` over
unbounded Python ints covering all of its elements. Geometry-derived
input ranges are declared where the values enter the program (the
``RANGELINT_BOUNDS`` anchors in ``oram/path_oram.py``, ``oram/posmap.py``,
``engine/round_step.py``, ``engine/expiry.py``; ``engine/journal.py``
holds the host-side byte-length guard) and propagated through every aten
op of the round. Finding classes, named as the reference names them:

- ``overflow`` — an arithmetic op whose mathematical interval escapes its
  lane: the device value silently wraps;
- ``trunc-cast`` — a conversion whose source interval does not fit its
  target (below: the port's sign-extending ``.long()`` of a u32 lane,
  a ``narrow`` that wraps, an int64 value that does not fit int32);
- ``oob-index`` — an index operand whose interval can leave its axis:
  every aten gather/scatter/index op, and the address operands of the
  port's kernels (``torch.ops.gv.*``: ``flat_b`` of B3-B6 against the
  tree plane's rows), which read and write raw rows without a check;
- ``trace-abort`` — a capture that stopped (a data-dependent guard) or a
  builder that refused the geometry: a finding, never a crash.

**The u32-on-int32 reading.** The reference computes in ``jnp.uint32``;
the port stores every u32 plane as ``torch.int32`` with the same bits
(``u32.py``). So each int32 value is read under a *lane*:

- ``"u32"``: its bits read unsigned, an interval inside ``[0, 2^32)``
  (the reference's ``uint32``). Every int32 input is a u32 lane (the
  anchors declare the bounded ones; undeclared ones are the full lane);
- ``"i32"``: a signed value, inside ``[-2^31, 2^31)`` (counters, ranks,
  values a signed op produced);
- no lane yet: a value the program made (a constant, ``arange``, a count)
  inside ``[-2^31, 2^31)``. It takes the lane of what it meets: a
  negative constant (``c32(0xFFFFFFFF)`` is -1) meets a u32 lane by its
  bits, as ``2^32 - 1``. Arithmetic on such values alone takes the lane
  its result fits (``[0, 2^32)`` is u32) and overflows only when it fits
  neither.

Lanes propagate through arithmetic: an add, sub, mul or left shift on a
u32 lane is an ``overflow`` when its interval leaves ``[0, 2^32)``; on an
i32 one when it leaves ``[-2^31, 2^31)``. Ops whose meaning depends on the
reading read the value as torch does — int32 compares, ``>>``,
``minimum``/``maximum``/``clamp`` and index operands are signed — and the
port's helpers come out exact:

- ``widen`` (``.to(int64) & 0xFFFFFFFF``) maps the u32 interval into
  int64 exactly; a conversion of a u32 lane to int64 whose users are not
  all such masks is a ``trunc-cast`` when the lane's interval reaches
  2^31 (the sign-extending ``.long()``: the counterpart of the
  reference's narrowing u32->int32 cast);
- ``shr``'s ``(x >> n) & (2^(32-n) - 1)`` is the logical shift of the u32
  value, and ``rotl``'s ``(x << n) | shr(x, 32 - n)`` a rotation (its
  left shift loses no bit, so it does not flag); ``ult``/``ule``'s sign flip (``x ^ 0x80000000``, then a signed
  compare) is read as the unsigned compare of the unflipped values, and
  a ``where`` guarded by it narrows by it;
- ``narrow`` (the low 32 bits of an int64) is clean where its int64
  interval fits the u32 or the i32 lane, and a ``trunc-cast`` where it
  wraps (admitted only by an allowlist entry that says why).

Soundness rules, the reference's: an op the domain does not model
degrades to its dtype's full range (sound and quiet; the report's
``unmodeled`` census counts them); bitwise ops never flag; a
``while_loop`` carry is joined over three body walks and, without a
fixpoint, widens to its lane and is re-walked, so a counter that can
pass its lane flags inside the body. The port has no scan: its loops are
unrolled Python, each iteration walked as its own nodes. One assumption
the domain adds: a buffer made by ``empty`` holds no value until written
(the port writes every row of such a buffer before reading it — the
sweep's chunk buffers, ``scatter_drop``'s spill row, which is sliced
off), so ``empty`` is the bottom of the join.

Intentional mod-2^32 arithmetic is admitted through the reviewed
:data:`.allowlist.RANGE_ALLOWLIST`, keyed ``aten_op@file.py:function``
(oblint's :class:`.oblint.AllowEntry`); the driver
(:mod:`.check_ranges`) fails a run that reaches an entry nowhere.
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import Callable, Iterable, NamedTuple

import torch

from .fx_walk import bound_args, capture, census, inner_op, op_name, site_of, subgraphs, \
    walk_nodes

U32 = (0, (1 << 32) - 1)
I32 = (-(1 << 31), (1 << 31) - 1)
_SIGN = -(1 << 31)
_MASK32 = (1 << 32) - 1
#: cap on shift amounts fed to Python ``<<`` during interval math
_SHIFT_CAP = 128

#: the kernels' address operands: op -> (operands, the tree operand whose
#: leading dim bounds them). B2 reads row i at row i: its ``buckets`` is
#: a keystream input, certified as a u32 lane only.
KERNEL_ADDRESS_OPERANDS = {
    "gv.gather_decrypt_rows": (("flat_b",), "tree_val"),
    "gv.gather_decrypt_rows_tiled": (("flat_b",), "tree_val"),
    "gv.scatter_encrypt_rows": (("flat_b",), "tree_val"),
    "gv.scatter_encrypt_rows_tiled": (("flat_b",), "tree_val"),
    "gv.cipher_rows_pallas": ((), None),
}


def dtype_range(dtype) -> "tuple[int, int] | None":
    """Representable range of a torch dtype: ints and bool exact, floats
    None (no wraparound to certify)."""
    if dtype == torch.bool:
        return (0, 1)
    if dtype.is_floating_point or dtype.is_complex:
        return None
    info = torch.iinfo(dtype)
    return (int(info.min), int(info.max))


class Iv(NamedTuple):
    """One value's interval under its lane (``"u32"``, ``"i32"`` or None;
    see the module docstring). ``tag`` marks a half-finished helper idiom
    (a sign extension of a u32 lane, an arithmetic shift of one, the low
    32 bits of an int64) that the next op may complete exactly."""

    lo: int
    hi: int
    lane: "str | None" = None
    tag: "tuple | None" = None


#: the empty interval (``empty``'s unwritten rows): the join's identity
BOT = Iv(1, 0, None)


def _is_bot(v) -> bool:
    return isinstance(v, Iv) and v.lo > v.hi


def _lane_rng(lane):
    return U32 if lane == "u32" else I32


def _read_u(v: Iv) -> tuple:
    """The u32 reading of an int32 value."""
    if v.lane == "u32" or v.lo >= 0:
        return (v.lo, v.hi)
    if v.hi < 0:
        return (v.lo + (1 << 32), v.hi + (1 << 32))
    return U32


def _read_s(v: Iv) -> tuple:
    """The signed reading of an int32 value (what torch computes with)."""
    if v.lane != "u32" or v.hi < (1 << 31):
        return (v.lo, v.hi)
    if v.lo >= (1 << 31):
        return (v.lo - (1 << 32), v.hi - (1 << 32))
    return I32


def _from_s(s: tuple, lane) -> Iv:
    """A signed result back into ``lane``'s reading."""
    if lane == "u32":
        if s[0] >= 0:
            return Iv(s[0], s[1], "u32")
        if s[1] < 0:
            return Iv(s[0] + (1 << 32), s[1] + (1 << 32), "u32")
        return Iv(*U32, "u32")
    return Iv(s[0], s[1], lane)


def _join(a, b):
    if a is None or b is None:
        return None
    if _is_bot(a):
        return b
    if _is_bot(b):
        return a
    lane = _meet_lane(a, b)
    if lane is None:
        return Iv(min(a.lo, b.lo), max(a.hi, b.hi))
    # both readings describe the same bits: keep the tighter hull (a u32
    # lane joined with a negative sentinel such as -1 reads signed)
    ua, ub, sa, sb = _read_u(a), _read_u(b), _read_s(a), _read_s(b)
    u = (min(ua[0], ub[0]), max(ua[1], ub[1]))
    s = (min(sa[0], sb[0]), max(sa[1], sb[1]))
    if s[1] - s[0] < u[1] - u[0]:
        return Iv(s[0], s[1], "i32" if (lane == "i32" or s[0] < 0) else lane)
    if u[1] - u[0] < s[1] - s[0]:
        return Iv(u[0], u[1], "u32")
    return Iv(*(u if lane == "u32" else s), lane)


def _meet_lane(*vs):
    lanes = {v.lane for v in vs if isinstance(v, Iv)}
    return "u32" if "u32" in lanes else "i32" if "i32" in lanes else None


@dataclasses.dataclass(frozen=True)
class RangeFinding:
    """One interval escaping its lane (or its axis)."""

    kind: str  # overflow | trunc-cast | oob-index | trace-abort
    site: str  # "file.py:function" (fx_walk.site_of key)
    prim: str  # op name ("" for capture-level findings)
    message: str = ""

    def __str__(self) -> str:
        msg = f" — {self.message}" if self.message else ""
        return f"{self.kind}: {self.prim or '<trace>'} at {self.site}{msg}"


@dataclasses.dataclass
class RangeReport:
    """Outcome of one analysis: surviving findings, allowlist hits
    (entry.key -> count), the captured program's op census, the ops the
    domain does not model (name -> nodes), the kernel nodes whose address
    operands were certified (op -> count), and ``intervals``: every
    integer node's certified :class:`Iv` (top-level graph)."""

    name: str
    findings: list
    allowed: dict
    census: dict
    n_eqns: int = 0
    capture: object = None
    audit_s: float = 0.0
    unmodeled: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    intervals: dict = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return not self.findings

    def summary(self) -> str:
        lines = [
            f"[rangelint] {self.name}: {len(self.findings)} finding(s), "
            f"{sum(self.allowed.values())} allowlisted op(s) at "
            f"{len(self.allowed)} site(s), {self.n_eqns} nodes"
        ]
        lines += [f"  FINDING {f}" for f in self.findings]
        return "\n".join(lines)


class _Ctx:
    """Walk state: findings (dedup), allowlist hits, the branch
    predicates seen, and what the report carries."""

    def __init__(self, allowlist: Iterable):
        self.allowlist = tuple(allowlist)
        self.findings: dict = {}
        self.allowed: dict = {}
        self.preds: dict = {}  # bool node -> predicate descriptor
        self.unmodeled: Counter = Counter()
        self.kernels: Counter = Counter()
        self.intervals: dict = {}

    def flag(self, kind: str, node, message: str, site=None):
        f = RangeFinding(kind=kind, site=site or site_of(node), prim=op_name(node.target),
                         message=message)
        for entry in self.allowlist:
            if entry.matches(f):
                self.allowed[entry.key] = self.allowed.get(entry.key, 0) + 1
                return entry
        self.findings.setdefault((f.kind, f.site, f.prim), f)
        return None


# ----------------------------------------------------------------------
# transfer helpers
# ----------------------------------------------------------------------


def _val(node):
    v = node.meta.get("val") if isinstance(node, torch.fx.Node) else None
    return v


def _dtype(node):
    v = _val(node)
    return v.dtype if isinstance(v, torch.Tensor) else None


def _full(dtype) -> "Iv | None":
    """The whole range of ``dtype`` (int32: the full u32 lane)."""
    if dtype is None:
        return None
    if dtype == torch.int32:
        return Iv(*U32, "u32")
    rng = dtype_range(dtype)
    return None if rng is None else Iv(*rng)


def _const(c) -> "Iv | None":
    if isinstance(c, bool):
        return Iv(int(c), int(c))
    if isinstance(c, int):
        return Iv(c, c)
    return None


def _arith(ctx, node, r: "tuple | None", lane, dtype, what: str) -> "Iv | None":
    """Check an arithmetic result ``r`` (exact, under ``lane``) against
    its lane (int32) or dtype, flag an escape, clamp."""
    if r is None or dtype is None:
        return _full(dtype)
    if dtype != torch.int32:
        rng = dtype_range(dtype)
        if rng is None:
            return None
        if r[0] < rng[0] or r[1] > rng[1]:
            ctx.flag("overflow", node, f"{what}: interval [{r[0]}, {r[1]}] escapes {dtype} "
                     f"[{rng[0]}, {rng[1]}] — the lane wraps silently at this geometry")
            return Iv(*rng)
        return Iv(r[0], r[1])
    if lane is None:
        if I32[0] <= r[0] and r[1] <= I32[1]:
            return Iv(r[0], r[1])
        if U32[0] <= r[0] and r[1] <= U32[1]:
            return Iv(r[0], r[1], "u32")
        ctx.flag("overflow", node, f"{what}: interval [{r[0]}, {r[1]}] fits neither the "
                 "u32 nor the i32 reading of int32 — the value wraps")
        return Iv(*U32, "u32")
    rng = _lane_rng(lane)
    if r[0] < rng[0] or r[1] > rng[1]:
        entry = ctx.flag("overflow", node, f"{what}: interval [{r[0]}, {r[1]}] escapes the "
                         f"{lane} lane [{rng[0]}, {rng[1]}] — the lane wraps silently at "
                         "this geometry")
        if entry is not None and not getattr(entry, "wraps", True):
            # an invariant-backed entry: the wrap cannot happen, so the
            # value stays inside both its interval and its lane
            return Iv(max(r[0], rng[0]), min(r[1], rng[1]), lane)
        return Iv(*rng, lane)
    return Iv(r[0], r[1], lane)


def _operands(a: Iv, b: Iv, dtype):
    """Both operands under one reading: (lane, a, b) as tuples."""
    if dtype != torch.int32:
        return None, (a.lo, a.hi), (b.lo, b.hi)
    lane = _meet_lane(a, b)
    if lane == "u32":
        return lane, _read_u(a), _read_u(b)
    return lane, (a.lo, a.hi), (b.lo, b.hi)


def _corners(f, a: tuple, b: tuple) -> tuple:
    c = [f(x, y) for x in a for y in b]
    return (min(c), max(c))


def _bitwidth(hi: int) -> int:
    return (1 << max(1, hi.bit_length())) - 1


def _bitwise(name: str, a: Iv, b: Iv, dtype) -> Iv:
    """and/or/xor: never flag. int32 operands are read by their bits."""
    if dtype == torch.bool:
        return Iv(0, 1)
    if dtype != torch.int32:
        if a.lo < 0 or b.lo < 0:
            if name == "and" and (a.lo >= 0 or b.lo >= 0):
                return Iv(0, a.hi if a.lo >= 0 else b.hi)
            return _full(dtype)
        if name == "and":
            return Iv(0, min(a.hi, b.hi))
        return Iv(0, _bitwidth(max(a.hi, b.hi)))
    ua, ub = _read_u(a), _read_u(b)
    if name == "and":
        r = (0, min(ua[1], ub[1]))
    else:
        r = (0, _bitwidth(max(ua[1], ub[1])))
    lane = _meet_lane(a, b)
    if lane == "i32":
        return Iv(*r, "i32") if r[1] < (1 << 31) else Iv(*I32, "i32")
    return Iv(r[0], r[1], "u32" if (lane == "u32" or r[1] >= (1 << 31)) else None)


# ----------------------------------------------------------------------
# predicates (where-narrowing)
# ----------------------------------------------------------------------

_FLIP = {"lt": "gt", "gt": "lt", "le": "ge", "ge": "le", "eq": "eq", "ne": "ne"}
_NEG = {"lt": "ge", "ge": "lt", "le": "gt", "gt": "le", "eq": "ne", "ne": "eq"}


def _unflip(ref, env):
    """``x ^ 0x80000000`` (``u32.ult``'s flip) -> ``x``; a constant c ->
    its unflipped u32 value."""
    if isinstance(ref, torch.fx.Node) and op_name(ref.target) == "aten.bitwise_xor.Scalar" \
            and ref.args[1] == _SIGN:
        return ref.args[0], True
    if isinstance(ref, int) and not isinstance(ref, bool):
        return (ref ^ _SIGN) & _MASK32, True
    return None, False


def _narrow_by(civ: Iv, case, pred, truth: bool, read) -> Iv:
    """Narrow a where-case's interval by the predicate (or its negation)."""
    if civ is None or _is_bot(civ) or pred is None:
        return civ
    kind = pred[0]
    if kind == "not":
        return _narrow_by(civ, case, pred[1], not truth, read)
    if kind == "and":
        if not truth:
            return civ
        for p in pred[1]:
            civ = _narrow_by(civ, case, p, True, read)
        return civ
    _, rel, a, b, unsigned = pred
    if case is a:
        other, r = b, rel
    elif case is b:
        other, r = a, _FLIP[rel]
    else:
        return civ
    if not truth:
        r = _NEG[r]
    o = read(other)
    if o is None or _is_bot(o):
        return civ
    int32 = _dtype(case) == torch.int32
    if unsigned:
        lo, hi = _read_u(civ)
        olo, ohi = (o.lo, o.hi) if isinstance(other, int) else _read_u(o)
    elif int32:
        lo, hi = _read_s(civ)
        olo, ohi = _read_s(o)
    else:
        lo, hi = civ.lo, civ.hi
        olo, ohi = o.lo, o.hi
    if r == "lt":
        hi = min(hi, ohi - 1)
    elif r == "le":
        hi = min(hi, ohi)
    elif r == "gt":
        lo = max(lo, olo + 1)
    elif r == "ge":
        lo = max(lo, olo)
    elif r == "eq":
        lo, hi = max(lo, olo), min(hi, ohi)
    if lo > hi:  # a branch never taken: keep sound
        return civ
    if not int32:
        return Iv(lo, hi, civ.lane)
    if unsigned:
        return Iv(lo, hi, "u32") if (civ.lane == "u32" or hi >= (1 << 31)) \
            else Iv(lo, hi, civ.lane)
    return _from_s((lo, hi), civ.lane)


# ----------------------------------------------------------------------
# the walk
# ----------------------------------------------------------------------

#: ops whose output holds exactly the input's values (layout and copies)
_SAME = {
    "aten.view", "aten._unsafe_view", "aten.reshape", "aten.unsqueeze", "aten.squeeze",
    "aten.expand", "aten.permute", "aten.transpose", "aten.t", "aten.clone",
    "aten.alias", "aten.contiguous", "aten.flip", "aten.roll", "aten.detach",
    "aten.lift_fresh_copy", "aten.slice", "aten.select", "aten.narrow", "aten.repeat",
    "aten.unfold", "aten.as_strided", "aten.diagonal", "aten.movedim", "aten.amax",
    "aten.amin", "aten.max", "aten.min", "aten.unflatten", "aten.flatten",
    "aten.expand_as", "aten.view_as", "aten.reshape_as", "aten.pin_memory",
}
#: ops that return a tuple of views of the input
_SPLITS = {"aten.split", "aten.split_with_sizes", "aten.chunk", "aten.unbind",
           "aten.tensor_split"}
_COMPARE = {"aten.lt": "lt", "aten.le": "le", "aten.gt": "gt", "aten.ge": "ge",
            "aten.eq": "eq", "aten.ne": "ne"}
_BOOL_OUT = {"aten.any", "aten.all", "aten.logical_and", "aten.logical_or",
             "aten.logical_not", "aten.logical_xor", "aten.isnan", "aten.isinf",
             "aten.isfinite", "aten.eye"}
_FILLS = {"aten.full", "aten.full_like", "aten.new_full", "aten.scalar_tensor",
          "aten.zeros", "aten.zeros_like", "aten.new_zeros", "aten.ones", "aten.ones_like",
          "aten.new_ones", "aten.fill", "aten.zero"}
_EMPTIES = {"aten.empty", "aten.empty_like", "aten.new_empty", "aten.empty_strided",
            "aten.new_empty_strided"}
_IGNORED = {"profiler._record_function_enter_new", "profiler._record_function_exit",
            "gv_analysis.host_read", "aten._assert_async", "aten._assert_scalar",
            "aten.sym_constrain_range_for_size"}


def _packet(name: str) -> str:
    parts = name.split(".")
    return ".".join(parts[:2]) if len(parts) >= 2 else name


def _extent_check(ctx, node, idx: "Iv | None", extent: int, idx_node, what: str):
    """Flag an index interval that can leave ``[0, extent - 1]``. int32
    indices are read signed, as torch reads them."""
    if idx is None or _is_bot(idx):
        return
    dt = _dtype(idx_node)
    if dt == torch.bool:
        return  # a mask: no address
    lo, hi = _read_s(idx) if dt == torch.int32 else (idx.lo, idx.hi)
    if lo < 0 or hi > extent - 1:
        ctx.flag("oob-index", node,
                 f"{what} interval [{lo}, {hi}] can leave the axis extent [0, {extent - 1}]"
                 " — the op (or the kernel) reads or writes the wrong row")


def _is_rotate(node) -> bool:
    """``x << n`` whose every user ORs it with ``shr(x, 32 - n)``: the
    rotate-left of ``u32.rotl``."""
    x, n = node.args[0], node.args[1]
    if not isinstance(n, int) or not node.users:
        return False
    for u in node.users:
        if op_name(u.target) != "aten.bitwise_or.Tensor":
            return False
        other = u.args[1] if u.args[0] is node else u.args[0]
        if not (isinstance(other, torch.fx.Node)
                and op_name(other.target) == "aten.bitwise_and.Scalar"
                and other.args[1] == (1 << n) - 1):
            return False
        sh = other.args[0]
        if not (isinstance(sh, torch.fx.Node) and op_name(sh.target) == "aten.__rshift__.Scalar"
                and sh.args[0] is x and sh.args[1] == 32 - n):
            return False
    return True


def _mask_consumed(node) -> bool:
    """Every user of ``node`` masks it to ``[0, 2^32)`` (``widen``)."""
    users = list(node.users)
    return bool(users) and all(
        op_name(u.target) == "aten.bitwise_and.Scalar" and u.args[0] is node
        and isinstance(u.args[1], int) and 0 <= u.args[1] <= _MASK32 for u in users)


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _same_predicate(case, cond, truth: bool):
    """A where-case that is itself selected by the same predicate:
    ``where(c, where(c, a, b), d)`` takes ``a`` where c holds, and
    ``where(c[p], where(c, a, b)[p], d)`` takes ``a[p]`` (a gather by one
    permutation keeps the pairing); returns the case to read."""
    while isinstance(case, torch.fx.Node):
        if op_name(case.target) == "aten.where.self" and case.args[0] is cond:
            case = case.args[1 if truth else 2]
            continue
        if (isinstance(cond, torch.fx.Node) and op_name(case.target) == "aten.index.Tensor"
                and op_name(cond.target) == "aten.index.Tensor"
                and list(case.args[1]) == list(cond.args[1])
                and isinstance(case.args[0], torch.fx.Node)
                and op_name(case.args[0].target) == "aten.where.self"
                and case.args[0].args[0] is cond.args[0]):
            case = case.args[0].args[1 if truth else 2]
            continue
        break
    return case


def _propagate(gm, in_vals: list, ctx: _Ctx, top: bool = False) -> list:
    """Walk one graph; returns the output values."""
    env: dict = {}

    def rd(a):
        if isinstance(a, torch.fx.Node):
            return env.get(a, _full(_dtype(a)))
        if isinstance(a, (list, tuple)):
            return [rd(x) for x in a]
        return _const(a)

    placeholders = [n for n in gm.graph.nodes if n.op == "placeholder"]
    for n, v in zip(placeholders, in_vals):
        env[n] = v
    outs: list = []
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            continue
        if node.op == "get_attr":  # a constant the capture lifted
            t = getattr(gm, node.target, None)
            if isinstance(t, torch.Tensor) and not t.dtype.is_floating_point:
                env[node] = Iv(int(t.min()), int(t.max())) if t.numel() else BOT
            continue
        if node.op == "output":
            res = node.args[0]
            outs = [rd(x) for x in (res if isinstance(res, (list, tuple)) else [res])]
            continue
        res = _transfer(gm, node, rd, ctx)
        env[node] = res
        if top and isinstance(res, Iv):
            ctx.intervals[node] = res
    return outs


def _transfer(gm, node, rd, ctx: _Ctx):
    """One node's value (an :class:`Iv`, None, or a list for tuples)."""
    name = op_name(node.target)
    pk = _packet(name)
    dt = _dtype(node)
    args = node.args
    val = _val(node)

    def a(i):
        return rd(args[i]) if i < len(args) else None

    if pk in _IGNORED or name.startswith("profiler."):
        return None
    if name == "getitem":
        src = rd(args[0])
        i = args[1]
        if isinstance(src, list) and isinstance(i, int) and i < len(src):
            return src[i]
        return _full(dt)
    if dt is not None and (dt.is_floating_point or dt.is_complex):
        return _float_transfer(pk, node, args, rd, dt)

    # ---- arithmetic ---------------------------------------------------
    if pk in ("aten.add", "aten.sub", "aten.mul", "aten.rsub"):
        x, y = a(0), a(1)
        if node.kwargs.get("alpha", 1) != 1:
            return _full(dt)
        if x is None or y is None or dt is None:
            return _full(dt)
        if _is_bot(x) or _is_bot(y):
            return BOT
        if pk == "aten.rsub":
            x, y = y, x
        cs = args[0] if isinstance(args[0], torch.fx.Node) else None
        if cs is not None and _packet(op_name(cs.target)) == "aten._to_copy":
            cs = cs.args[0] if isinstance(cs.args[0], torch.fx.Node) else None
        if pk == "aten.sub" and cs is not None and _packet(op_name(cs.target)) == "aten.cumsum" \
                and cs.args[0] is args[1] and y.lo >= 0:
            # cumsum(m) - m: the exclusive prefix count, never below 0 (a
            # prefix sum dominates its own last term)
            return Iv(0, x.hi)
        # narrow's middle steps: ((x & M) ^ 2^31) - 2^31 keeps the tag
        if pk == "aten.sub" and x.tag and x.tag[0] == "low32^" and y == Iv(1 << 31, 1 << 31):
            return Iv(*I32, None, ("low32s", x.tag[1]))
        lane, ra, rb = _operands(x, y, dt)
        if pk == "aten.mul":
            r = _corners(lambda p, q: p * q, ra, rb)
        elif pk == "aten.add":
            r = (ra[0] + rb[0], ra[1] + rb[1])
        else:
            r = (ra[0] - rb[1], ra[1] - rb[0])
        return _arith(ctx, node, r, lane, dt, pk.split(".")[1])
    if pk == "aten.neg":
        x = a(0)
        if x is None or _is_bot(x):
            return x
        lane, rx, _ = _operands(x, x, dt)
        return _arith(ctx, node, (-rx[1], -rx[0]), lane, dt, "neg")
    if pk in ("aten.__lshift__", "aten.bitwise_left_shift"):
        x, s = a(0), a(1)
        if x is None or s is None or _is_bot(x):
            return _full(dt) if x is None else x
        if dt == torch.int32 and _is_rotate(node):
            return Iv(*U32, "u32")  # rotl: the bits past 32 re-enter, none is lost
        lane, rx, _ = _operands(x, x, dt)
        s_lo, s_hi = max(0, min(s.lo, _SHIFT_CAP)), max(0, min(s.hi, _SHIFT_CAP))
        return _arith(ctx, node, _corners(lambda p, q: p << q, rx, (s_lo, s_hi)), lane, dt,
                      "shift_left")
    if pk in ("aten.__rshift__", "aten.bitwise_right_shift"):
        x, s = a(0), a(1)
        if x is None or s is None or _is_bot(x):
            return _full(dt) if x is None else x
        s_lo, s_hi = max(0, min(s.lo, _SHIFT_CAP)), max(0, min(s.hi, _SHIFT_CAP))
        if dt == torch.int32:
            sx = _read_s(x)
            r = _corners(lambda p, q: p >> q, sx, (s_lo, s_hi))
            tag = None
            if x.lane == "u32" and s_lo == s_hi and x.hi >= (1 << 31):
                tag = ("ashr", _read_u(x), s_lo)
            out = _from_s(r, x.lane if r[0] >= 0 else "i32")
            return out._replace(tag=tag)
        return Iv(*_corners(lambda p, q: p >> q, (x.lo, x.hi), (s_lo, s_hi)))
    if pk in ("aten.remainder", "aten.fmod"):
        x, m = a(0), a(1)
        if x is None or m is None or _is_bot(x):
            return _full(dt) if x is None else x
        if m.lo >= 1 and (pk == "aten.remainder" or x.lo >= 0):
            hi = m.hi - 1
            if x.lo >= 0 and (dt != torch.int32 or x.hi < (1 << 31)):
                hi = min(hi, x.hi)
            return Iv(0, hi, x.lane if dt == torch.int32 else None)
        return _full(dt)
    if pk in ("aten.div", "aten.floor_divide"):
        x, y = a(0), a(1)
        if x is None or y is None or _is_bot(x) or y.lo <= 0 or (
                dt == torch.int32 and _read_s(x)[0] < 0):
            return _full(dt)
        sx = _read_s(x) if dt == torch.int32 else (x.lo, x.hi)
        return Iv(sx[0] // y.hi, sx[1] // y.lo, x.lane)
    if pk == "aten.abs":
        x = a(0)
        if x is None or _is_bot(x):
            return x
        lo, hi = _read_s(x) if dt == torch.int32 else (x.lo, x.hi)
        r = (0 if lo <= 0 <= hi else min(abs(lo), abs(hi)), max(abs(lo), abs(hi)))
        return _arith(ctx, node, r, "i32" if dt == torch.int32 else None, dt, "abs")

    # ---- bitwise ------------------------------------------------------
    if pk in ("aten.bitwise_and", "aten.bitwise_or", "aten.bitwise_xor", "aten.__and__",
              "aten.__or__", "aten.__xor__"):
        op = pk.split(".")[1].strip("_").replace("bitwise_", "")
        x, y = a(0), a(1)
        if dt == torch.bool:
            if op == "and":
                # where the conjunction holds, each known conjunct holds
                ps = tuple(p for p in (ctx.preds.get(q) for q in args[:2]) if p is not None)
                if ps:
                    ctx.preds[node] = ("and", ps)
            return Iv(0, 1)
        if x is None or y is None:
            return _full(dt)
        if _is_bot(x) or _is_bot(y):
            return BOT
        c = args[1] if isinstance(args[1], int) else None
        if op == "and" and c is not None and 0 <= c <= _MASK32:
            if c == _MASK32 and dt == torch.int64 and x.lo >= 0 and x.hi <= _MASK32:
                return Iv(x.lo, x.hi)
            if x.tag and x.tag[0] == "sext":  # widen
                u = x.tag[1]
                return Iv(u[0], u[1]) if c == _MASK32 else Iv(0, min(u[1], c))
            if x.tag and x.tag[0] == "ashr" and dt == torch.int32 \
                    and c == (1 << (32 - x.tag[2])) - 1:  # shr
                u, n = x.tag[1], x.tag[2]
                return Iv(u[0] >> n, u[1] >> n, "u32")
            if dt == torch.int64 and c == _MASK32 and not (x.lo >= 0 and x.hi <= _MASK32):
                return Iv(0, _MASK32, None, ("low32", (x.lo, x.hi)))  # narrow, step 1
        if op == "xor" and dt == torch.int32 and c == _SIGN:  # ult/ule's flip
            u = _read_u(x)
            return Iv(u[0] - (1 << 31), u[1] - (1 << 31), "i32")
        if op == "xor" and dt == torch.int64 and c == (1 << 31):
            src = x.tag[1] if (x.tag and x.tag[0] == "low32") else (x.lo, x.hi)
            if x.tag or (0 <= x.lo and x.hi <= _MASK32):
                return Iv(0, _MASK32, None, ("low32^", src))
        return _bitwise(op, x, y, dt)
    if pk == "aten.bitwise_not":
        x = a(0)
        if dt == torch.bool:
            p = ctx.preds.get(args[0])
            if p is not None:
                ctx.preds[node] = ("not", p)
            return Iv(0, 1)
        if x is None or _is_bot(x):
            return _full(dt) if x is None else x
        if dt == torch.int32 and (x.lane == "u32" or x.lo >= 0):
            u = _read_u(x)
            return Iv(_MASK32 - u[1], _MASK32 - u[0], "u32")
        return Iv(-x.hi - 1, -x.lo - 1, x.lane)

    # ---- conversions --------------------------------------------------
    if pk in ("aten._to_copy", "aten.to", "aten._to_dtype", "aten.type_as"):
        x = a(0)
        src_dt = _dtype(args[0]) if isinstance(args[0], torch.fx.Node) else None
        if x is None or dt is None or src_dt is None or _is_bot(x):
            return _full(dt) if x is None else x
        if src_dt == dt:
            return x
        if dt == torch.bool:
            return Iv(0, 1)
        if src_dt == torch.bool:
            return Iv(0, 1)
        if src_dt == torch.int32:
            if x.lane == "u32" and x.hi >= (1 << 31):
                if dt == torch.int64 and _mask_consumed(node):
                    return Iv(*_read_s(x), None, ("sext", (x.lo, x.hi)))
                entry = ctx.flag(
                    "trunc-cast", node, f"sign-extending int32->{dt}: the u32 lane's "
                    f"interval [{x.lo}, {x.hi}] reaches 2^31, so values above it turn "
                    "negative (widen it: .to(int64) & 0xFFFFFFFF)")
                if entry is not None and not getattr(entry, "wraps", True):
                    return Iv(x.lo, min(x.hi, I32[1]))  # the invariant: below 2^31
                return _full(dt) if dt != torch.int64 else Iv(*I32)
            s = _read_s(x)
            rng = dtype_range(dt)
            if s[0] < rng[0] or s[1] > rng[1]:
                ctx.flag("trunc-cast", node, f"int32->{dt}: source interval [{s[0]}, "
                         f"{s[1]}] does not fit [{rng[0]}, {rng[1]}]")
                return _full(dt)
            return Iv(s[0], s[1])
        if dt == torch.int32:
            if x.tag and x.tag[0] == "low32s":  # narrow, last step
                lo, hi = x.tag[1]
                if 0 <= lo and hi <= _MASK32:
                    return Iv(lo, hi, "u32" if hi >= (1 << 31) else None)
                if I32[0] <= lo and hi <= I32[1]:
                    return Iv(lo, hi, "i32")
                ctx.flag("trunc-cast", node,
                         f"narrow: int64 interval [{lo}, {hi}] fits neither the u32 nor the "
                         "i32 lane — its low 32 bits wrap")
                return Iv(*U32, "u32")
            if I32[0] <= x.lo and x.hi <= I32[1]:
                return Iv(x.lo, x.hi)
            if 0 <= x.lo and x.hi <= _MASK32:
                return Iv(x.lo, x.hi, "u32")
            ctx.flag("trunc-cast", node, f"{src_dt}->int32: source interval [{x.lo}, "
                     f"{x.hi}] fits neither the u32 nor the i32 lane")
            return Iv(*U32, "u32")
        rng = dtype_range(dt)
        if rng is not None and (x.lo < rng[0] or x.hi > rng[1]):
            ctx.flag("trunc-cast", node, f"{src_dt}->{dt}: source interval [{x.lo}, "
                     f"{x.hi}] does not fit [{rng[0]}, {rng[1]}]")
            return _full(dt)
        return Iv(x.lo, x.hi)

    # ---- comparisons / selects ----------------------------------------
    if pk in _COMPARE:
        rel = _COMPARE[pk]
        x_ref, y_ref = args[0], args[1]
        ux, fx = _unflip(x_ref, None)
        uy, fy = _unflip(y_ref, None)
        if fx and fy and isinstance(ux, torch.fx.Node):
            ctx.preds[node] = ("rel", rel, ux, uy, True)
        elif isinstance(x_ref, torch.fx.Node):
            ctx.preds[node] = ("rel", rel, x_ref, y_ref, False)
        return Iv(0, 1)
    if pk == "aten.where":
        cond = args[0]
        if len(args) < 3:
            return _full(dt)
        pred = ctx.preds.get(cond)
        out = None
        for truth, case in ((True, args[1]), (False, args[2])):
            case = _same_predicate(case, cond, truth)
            civ = rd(case)
            if civ is None:
                return _full(dt)
            civ = _narrow_by(civ, case, pred, truth, rd)
            out = civ if out is None else _join(out, civ)
        return out if dt != torch.bool else Iv(0, 1)
    if pk == "aten.clamp" or pk == "aten.clamp_min" or pk == "aten.clamp_max":
        x = a(0)
        if x is None or _is_bot(x):
            return _full(dt) if x is None else x
        lo_v = a(1) if pk != "aten.clamp_max" else None
        hi_v = (a(2) if pk == "aten.clamp" else a(1)) if pk != "aten.clamp_min" else None
        s = _read_s(x) if dt == torch.int32 else (x.lo, x.hi)
        lo, hi = s
        if isinstance(lo_v, Iv):
            lo, hi = max(lo, lo_v.lo), max(hi, lo_v.hi)
        if isinstance(hi_v, Iv):
            lo, hi = min(lo, hi_v.lo), min(hi, hi_v.hi)
        return _from_s((lo, hi), x.lane) if dt == torch.int32 else Iv(lo, hi)
    if pk in ("aten.minimum", "aten.maximum"):
        x, y = a(0), a(1)
        if x is None or y is None:
            return _full(dt)
        if _is_bot(x) or _is_bot(y):
            return BOT
        sx = _read_s(x) if dt == torch.int32 else (x.lo, x.hi)
        sy = _read_s(y) if dt == torch.int32 else (y.lo, y.hi)
        f = min if pk == "aten.minimum" else max
        r = (f(sx[0], sy[0]), f(sx[1], sy[1]))
        return _from_s(r, _meet_lane(x, y)) if dt == torch.int32 else Iv(*r)

    # ---- layout, fills, structure -------------------------------------
    if pk in _SAME:
        x = a(0)
        if isinstance(x, list):
            return _full(dt)
        if isinstance(val, (list, tuple)):  # max.dim / min.dim: (values, indices)
            n = _val(args[0]).shape[args[1]] if len(args) > 1 and isinstance(args[1], int) \
                else 1
            return [x._replace(tag=None) if isinstance(x, Iv) else x, Iv(0, max(0, n - 1))]
        return x._replace(tag=None) if isinstance(x, Iv) else x
    if pk in _SPLITS:
        x = a(0)
        n = len(val) if isinstance(val, (list, tuple)) else 1
        return [x] * n
    if pk in ("aten.cat", "aten.stack", "aten.hstack", "aten.vstack"):
        vs = rd(args[0])
        if any(v is None for v in vs):
            return _full(dt)
        out = BOT
        for v in vs:
            out = _join(out, v)
        return out
    if pk in _FILLS:
        if pk in ("aten.full", "aten.full_like", "aten.new_full", "aten.fill"):
            v = a(1) if pk != "aten.new_full" else a(2)
        elif pk == "aten.scalar_tensor":
            v = a(0)
        elif pk in ("aten.zeros", "aten.zeros_like", "aten.new_zeros", "aten.zero"):
            v = Iv(0, 0)
        else:
            v = Iv(1, 1)
        if v is None or dt is None:
            return _full(dt)
        if dt == torch.bool:
            return Iv(0, 1)
        return v
    if pk in _EMPTIES:
        return BOT
    if pk == "aten.arange":
        nums = [x for x in args if isinstance(x, int)]
        if len(nums) == 1:
            lo, hi, step = 0, nums[0], 1
        elif len(nums) >= 2:
            lo, hi = nums[0], nums[1]
            step = nums[2] if len(nums) > 2 else 1
        else:
            return _full(dt)
        if hi <= lo:
            return BOT
        last = lo + ((hi - lo - 1) // step) * step
        return _arith(ctx, node, (lo, last), None, dt, "arange")
    if pk in _BOOL_OUT:
        return Iv(0, 1)
    if pk in ("aten.copy", "aten.copy_"):
        return a(1)
    if pk in ("aten.masked_fill",):
        return _join(a(0), a(2)) if a(0) is not None and a(2) is not None else _full(dt)
    if pk in ("aten.argmax", "aten.argmin", "aten.argsort", "aten.bucketize",
              "aten.searchsorted"):
        x = _val(args[0]) if pk != "aten.bucketize" else _val(args[1])
        dim = args[1] if len(args) > 1 and isinstance(args[1], int) else node.kwargs.get(
            "dim")
        n = (x.shape[dim] if dim is not None else x.numel()) if isinstance(
            x, torch.Tensor) else 1 << 62
        hi = n if pk in ("aten.bucketize", "aten.searchsorted") else max(0, n - 1)
        return Iv(0, hi)
    if pk in ("aten.sort", "aten.topk", "aten.kthvalue", "aten.cummax", "aten.cummin",
              "aten.mode", "aten.median"):
        x = a(0)
        src = _val(args[0])
        dim = bound_args(node).get("dim", -1)
        n = src.shape[dim] if isinstance(src, torch.Tensor) and src.dim() else 1
        return [x, Iv(0, max(0, n - 1))]
    if pk in ("aten.sum", "aten.cumsum", "aten.prod", "aten.cumprod"):
        x = a(0)
        src = _val(args[0])
        if x is None or not isinstance(src, torch.Tensor) or dt is None:
            return _full(dt)
        if _is_bot(x):
            return BOT
        if pk in ("aten.prod", "aten.cumprod"):
            return _full(dt)
        if pk == "aten.cumsum":
            n = src.shape[args[1]] if src.dim() else 1
        elif len(args) > 1 and args[1] is not None and isinstance(args[1], (list, tuple)) \
                and len(args[1]):
            n = _numel(src.shape[d] for d in args[1])
        else:
            n = src.numel()
        src_dt = src.dtype
        if src_dt == torch.int32:
            lane = x.lane if dt == torch.int32 else None
            s = _read_u(x) if lane == "u32" else _read_s(x)
        else:
            lane, s = None, (x.lo, x.hi)
        r = (min(n * s[0], s[0]), max(n * s[1], s[1]))
        return _arith(ctx, node, r, lane, dt, f"{pk.split('.')[1]}[n={n}]")

    # ---- memory ops: index checks -------------------------------------
    if pk in ("aten.index", "aten._unsafe_index", "aten.index_put", "aten._unsafe_index_put",
              "aten._index_put_impl"):
        ba = bound_args(node)
        src_node = ba.get("self")
        shape = _val(src_node).shape if isinstance(_val(src_node), torch.Tensor) else None
        d = 0
        for ix in ba.get("indices") or []:
            if ix is not None and shape is not None and d < len(shape):
                _extent_check(ctx, node, rd(ix), int(shape[d]), ix, "index")
            d += 1
        base = rd(src_node)
        if pk in ("aten.index", "aten._unsafe_index"):
            return base
        upd = rd(ba.get("values"))
        if ba.get("accumulate"):
            return _accumulate(ctx, node, base, upd, ba.get("values"), dt)
        return _join(base, upd) if base is not None and upd is not None else _full(dt)
    if pk in ("aten.index_select", "aten.gather", "aten.take", "aten.embedding"):
        ba = bound_args(node)
        src_node = ba.get("self", ba.get("weight"))
        idx_node = ba.get("index", ba.get("indices"))
        dim = ba.get("dim", 0)
        shape = _val(src_node).shape
        extent = _numel(shape) if pk == "aten.take" else int(shape[dim]) if len(shape) else 1
        _extent_check(ctx, node, rd(idx_node), extent, idx_node, "index")
        return rd(src_node)
    if pk in ("aten.scatter", "aten.scatter_add", "aten.scatter_reduce", "aten.index_add",
              "aten.index_copy", "aten.index_fill", "aten.index_reduce"):
        ba = bound_args(node)
        src_node = ba.get("self")
        idx_node = ba.get("index")
        dim = ba.get("dim", 0)
        shape = _val(src_node).shape
        if len(shape):
            _extent_check(ctx, node, rd(idx_node), int(shape[dim]), idx_node, "index")
        base = rd(src_node)
        upd_node = ba.get("src", ba.get("source", ba.get("value")))
        upd = rd(upd_node)
        if base is None or upd is None:
            return _full(dt)
        reduce = ba.get("reduce")
        if pk in ("aten.scatter_add", "aten.index_add") or reduce in ("sum", "add"):
            return _accumulate(ctx, node, base, upd, upd_node, dt)
        if reduce in ("amin", "min") and not _is_bot(base) and not _is_bot(upd):
            j = _join(base, upd)
            return j._replace(hi=_join(base, base).hi) if ba.get("include_self", True) \
                else j
        if reduce in ("amax", "max") and not _is_bot(base) and not _is_bot(upd):
            j = _join(base, upd)
            return j._replace(lo=_join(base, base).lo) if ba.get("include_self", True) \
                else j
        if reduce in ("prod", "multiply", "mean"):
            return _full(dt)
        return _join(base, upd)
    if pk in ("aten.select_scatter", "aten.slice_scatter", "aten.diagonal_scatter",
              "aten.as_strided_scatter"):
        return _join(a(0), a(1)) if a(0) is not None and a(1) is not None else _full(dt)

    # ---- the port's kernels -------------------------------------------
    kern = op_name(inner_op(node) or node.target)
    kpk = _packet(kern)
    if kpk in KERNEL_ADDRESS_OPERANDS:
        operands, tree = KERNEL_ADDRESS_OPERANDS[kpk]
        ba = bound_args(node)
        if tree is not None:
            rows = int(_val(ba[tree]).shape[0])
            for o in operands:
                addr = rd(ba.get(o))
                if "owner" in ba:  # a scatter skips non-owner rows whole
                    addr = _narrow_by(addr, ba.get(o), ctx.preds.get(ba["owner"]), True, rd)
                _extent_check(ctx, node, addr, rows, ba.get(o), f"{kpk} address operand {o}")
        ctx.kernels[kpk] += 1
        return _outputs_full(val)

    # ---- control flow -------------------------------------------------
    if name == "higher_order.cond":
        ops = [rd(x) for x in args[3]]
        res = None
        for br in subgraphs(gm, node)[:2]:
            bouts = _propagate(br, ops, ctx)
            res = bouts if res is None else [_join(p, q) for p, q in zip(res, bouts)]
        return res or []
    if name == "higher_order.while_loop":
        cond_gm, body_gm = subgraphs(gm, node)[:2]
        carry = [rd(x) for x in args[2]]
        extra = [rd(x) for x in args[3]] if len(args) > 3 else []
        for _ in range(3):
            nxt = _propagate(body_gm, carry + extra, ctx)
            merged = [_join(p, q) for p, q in zip(carry, nxt)]
            if merged == carry:
                break
            carry = merged
        else:
            # no fixpoint in 3 joins: the loop does not bound its carry —
            # widen to the lane and re-walk (in-body escapes flag there)
            carry = [_full(_dtype(x)) for x in args[2]]
            _propagate(body_gm, carry + extra, ctx)
        _propagate(cond_gm, carry + extra, ctx)
        return carry

    # ---- anything else: its dtype's full range, sound and quiet --------
    ctx.unmodeled[pk] += 1
    for sub in subgraphs(gm, node):  # walk any other subgraph for its own ops
        n_in = sum(1 for n in sub.graph.nodes if n.op == "placeholder")
        _propagate(sub, [None] * n_in, ctx)
    return _outputs_full(val)


#: integers a float dtype holds exactly
_EXACT = {torch.float64: 1 << 53, torch.float32: 1 << 24}


def _float_transfer(pk, node, args, rd, dt):
    """Integer-valued floats (an int cast up, products of them: the
    port's exact float64 matmul counts) keep their interval while every
    value is an exact integer of the dtype; anything else on floats is
    unknown (None)."""
    limit = _EXACT.get(dt)
    if limit is None:
        return None

    def ok(r):
        return Iv(r[0], r[1]) if -limit <= r[0] and r[1] <= limit else None

    x = rd(args[0]) if args else None
    if pk in ("aten._to_copy", "aten.to", "aten._to_dtype"):
        src = _dtype(args[0]) if isinstance(args[0], torch.fx.Node) else None
        if isinstance(x, Iv) and src is not None and not src.is_floating_point \
                and not _is_bot(x):
            return ok(_read_s(x) if src == torch.int32 else (x.lo, x.hi))
        return x if src in _EXACT and isinstance(x, Iv) else None
    if pk in _SAME and isinstance(x, Iv) and not isinstance(_val(node), (list, tuple)):
        return x
    if pk in ("aten.mm", "aten.bmm", "aten.matmul", "aten.mv", "aten.dot"):
        y = rd(args[1])
        if not (isinstance(x, Iv) and isinstance(y, Iv)) or _is_bot(x) or _is_bot(y):
            return None
        k = int(_val(args[0]).shape[-1])
        p = _corners(lambda a, b: a * b, (x.lo, x.hi), (y.lo, y.hi))
        return ok((min(0, k * p[0]), max(0, k * p[1])))
    return None


def _outputs_full(val):
    if isinstance(val, (list, tuple)):
        return [_full(v.dtype) if isinstance(v, torch.Tensor) else None for v in val]
    return _full(val.dtype) if isinstance(val, torch.Tensor) else None


def _accumulate(ctx, node, base, upd, upd_node, dt):
    """Scatter-add: worst case every update lands on one element."""
    if base is None or upd is None:
        return _full(dt)
    if _is_bot(upd):
        return base
    uv = _val(upd_node)
    n = uv.numel() if isinstance(uv, torch.Tensor) else 1
    b = Iv(0, 0) if _is_bot(base) else base
    lane, rb, ru = _operands(b, upd, dt)
    r = (rb[0] + min(0, n * ru[0]), rb[1] + max(0, n * ru[1]))
    return _arith(ctx, node, r, lane, dt, f"scatter-add[n={n}]")


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------


def _bound_for(label: str, bounds: dict):
    """Longest declared dotted-prefix match wins; None = lane default."""
    best, best_len = None, -1
    for prefix, iv in bounds.items():
        if (label == prefix or label.startswith(prefix + ".")) and len(prefix) > best_len:
            best, best_len = iv, len(prefix)
    return best


def input_interval(label: str, t: torch.Tensor, bounds: dict) -> "Iv | None":
    """A placeholder's declared interval: ``bounds[label]`` is ``(lo, hi)``
    (an int32 leaf is a u32 lane) or ``(lo, hi, lane)``; undeclared leaves
    take their full lane."""
    declared = _bound_for(label, bounds)
    if declared is None:
        return _full(t.dtype)
    lo, hi = int(declared[0]), int(declared[1])
    lane = declared[2] if len(declared) > 2 else ("u32" if t.dtype == torch.int32 else None)
    return Iv(lo, hi, lane)


def audit_ranges(cap, bounds: "dict | None" = None, allowlist: Iterable = ()) -> RangeReport:
    """Interval-check one :class:`.fx_walk.Capture`."""
    bounds = dict(bounds or {})
    if cap.gm is None:
        site, msg = cap.dependence
        f = RangeFinding(kind="trace-abort", site=site, prim="",
                         message=f"capture stopped on a data-dependent guard: {msg}")
        return RangeReport(cap.name, [f], {}, {}, capture=cap)
    t0 = time.perf_counter()
    ctx = _Ctx(allowlist)
    phs = [n for n in cap.gm.graph.nodes if n.op == "placeholder"]
    if len(phs) != len(cap.labels):
        raise ValueError(f"rangelint: {len(cap.labels)} labelled inputs vs {len(phs)} "
                         "placeholders")
    in_vals = [input_interval(lb, _val(n), bounds) if isinstance(_val(n), torch.Tensor)
               else None for lb, n in zip(cap.labels, phs)]
    for n, v in zip(phs, in_vals):
        if isinstance(v, Iv):
            ctx.intervals[n] = v
    _propagate(cap.gm, in_vals, ctx, top=True)
    return RangeReport(
        name=cap.name,
        findings=sorted(ctx.findings.values(), key=lambda f: (f.site, f.kind, f.prim)),
        allowed=dict(ctx.allowed),
        census=dict(census(cap.gm)),
        n_eqns=sum(1 for _ in walk_nodes(cap.gm)),
        capture=cap,
        audit_s=time.perf_counter() - t0,
        unmodeled=dict(ctx.unmodeled),
        kernels=dict(ctx.kernels),
        intervals=ctx.intervals,
    )


def analyze_ranges(fn: Callable, args: dict, bounds: "dict | None" = None,
                   allowlist: Iterable = (), name: str = "program",
                   tracing_mode: str = "fake") -> RangeReport:
    """Capture ``fn(*args.values())`` and interval-check the graph.

    ``args`` maps argument name -> example value (tensors or pytrees of
    them; fake tensors or tensors on ``meta`` build a geometry without
    allocating it). ``bounds`` maps dotted label prefixes over those names
    (``"idxs"``, ``"state.rec.posmap"``) to declared input intervals — the
    RANGELINT_BOUNDS anchors; undeclared leaves take their full lane.

    A builder that refuses the geometry (``OverflowError``/``ValueError``
    while capturing) or a capture that stops on a data-dependent guard is
    a ``trace-abort`` finding, not a crash."""
    try:
        cap = capture(fn, *args.values(), names=list(args), name=name,
                      tracing_mode=tracing_mode)
    except (OverflowError, ValueError) as exc:
        f = RangeFinding(kind="trace-abort", site=name, prim="",
                         message=f"capture aborted before any device op: "
                                 f"{type(exc).__name__}: {exc}")
        return RangeReport(name, [f], {}, {})
    return audit_ranges(cap, bounds, allowlist)


# ----------------------------------------------------------------------
# the witness: certified intervals held against values the device computes
# ----------------------------------------------------------------------

_EMPTY_TARGETS = ("aten.empty.memory_format", "aten.empty_like.default",
                  "aten.new_empty.default", "aten.empty_strided.default",
                  "aten.new_empty_strided.default")


def _is_full(iv: Iv, dtype) -> bool:
    if dtype == torch.int32:
        return (iv.lo, iv.hi) in (U32, I32) or (iv.lo <= I32[0] and iv.hi >= U32[1])
    rng = dtype_range(dtype)
    return rng is not None and iv.lo <= rng[0] and iv.hi >= rng[1]


def witness(rep: RangeReport, *inputs) -> dict:
    """Replay ``rep``'s captured graph on ``inputs`` (its placeholders'
    tensors, in order) and hold every integer node's observed minimum and
    maximum, under the node's own lane reading, against the interval the
    analysis certified for it.

    Returns ``out`` (the replay's outputs), ``checked`` (nodes whose
    values were read), ``full_lane`` (nodes certified only to their whole
    lane: trivially inside), ``violations`` (node, certified, observed)
    and ``margin``: the least distance from an observation to its bound.
    Buffers the graph makes with ``empty`` are replayed as zeros: the
    program writes every row it reads (the domain's ``empty`` rule), so
    the fill changes no output, and the observations stay deterministic.
    All reads stay on the device until one copy at the end."""
    pending, full = [], 0

    class Recorder(torch.fx.Interpreter):
        def call_function(self, target, args, kwargs):
            if op_name(target) in _EMPTY_TARGETS:
                return torch.zeros_like(super().call_function(target, args, kwargs))
            return super().call_function(target, args, kwargs)

        def run_node(self, n):
            nonlocal full
            res = super().run_node(n)
            iv = rep.intervals.get(n)
            if iv is None or _is_bot(iv) or not isinstance(res, torch.Tensor) \
                    or res.numel() == 0 or res.dtype.is_floating_point:
                return res
            if _is_full(iv, res.dtype):
                full += 1
                return res
            t, off = res, 0
            if res.dtype == torch.bool:
                t = res.to(torch.uint8)
            elif res.dtype == torch.int32 and iv.lane == "u32":
                t, off = res ^ _SIGN, 1 << 31  # unsigned order, read back +2^31
            mn, mx = torch.aminmax(t)
            pending.append((n, iv, off, torch.stack([mn.to(torch.int64), mx.to(torch.int64)])))
            return res

    out = Recorder(rep.capture.gm).run(*inputs)
    seen = torch.stack([p[3] for p in pending]).cpu().tolist() if pending else []
    violations, margin = [], None
    for (n, iv, off, _), (mn, mx) in zip(pending, seen):
        lo, hi = mn + off, mx + off
        if lo < iv.lo or hi > iv.hi:
            violations.append((n.name, (iv.lo, iv.hi, iv.lane), (lo, hi)))
        m = min(lo - iv.lo, iv.hi - hi)
        margin = m if margin is None else min(margin, m)
    return dict(out=out, checked=len(pending), full_lane=full, violations=violations,
                margin=margin)
