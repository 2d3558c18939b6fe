"""Capture layer of the obliviousness analysis (counterpart of
``grapevine_tpu/analysis/jaxpr_walk.py``).

:func:`capture` turns a port function into an FX graph of aten ops:
``make_fx`` over the function run under Python functionalization, so
every in-place op (``index_put_``, the sweep's ``out=`` writes, the
kernels that write the trees) becomes an SSA value and a later read of
a mutated tensor points at the node that produced its new value. The
taint walk (:mod:`.oblint`), the census and the plane-row accounting all
read the one node stream :func:`walk_nodes` yields, recursing into the
subgraphs of higher-order ops (``cond``, ``while_loop``), so a subgraph
the census sees is a subgraph the taint walk sees.

Arguments are pytrees (NamedTuples, dicts, sequences, sharded planes)
flattened to tensor leaves under dotted labels (``state.rec.stash_idx``,
``batch.auth``, ``draws.nl_a``), the labels the reference's
``_path_str`` gives; anything that is not a tensor (configs, generators,
ints) is closed over as a constant.

Each node carries the site that made it (``node.meta["gv_site"]``,
``file.py:function`` of the innermost frame inside the package): a hook
on the capture's tracer reads the Python stack when the node is
created. Reads of a tensor's values by the host (``item``, ``tolist``,
``numpy``, ``bool``/``int``/``index``, ``repr``/``format``, a copy to
the CPU of a CUDA tensor) are recorded during the capture as
``gv_analysis.host_read`` nodes on their operand: fake mode refuses most
of them, but it formats a fake tensor without reading it, so a
``print(secret)`` would otherwise pass unseen.

A capture that stops on a data-dependent guard
(``GuardOnDataDependentSymNode``, ``DataDependentOutputException``,
``DynamicOutputShapeException``) returns no graph and a
:attr:`Capture.dependence` naming the innermost package frame of the
traceback: the analyzer reports it as a ``trace-dependence`` violation
(the reference's handling of a concretization error).

Capture API used, present in torch 2.11 and 2.13:
``torch.fx.experimental.proxy_tensor.make_fx`` (``tracing_mode`` "fake"
or "real") and ``get_proxy_mode``,
``torch._subclasses.functional_tensor.dispatch_functionalize`` with a
fresh ``FunctionalTensorMode``, ``torch.overrides.TorchFunctionMode``,
``torch.library.custom_op``, and ``torch._guards.tracing`` /
``TracingContext`` (one fake mode for a real capture's metadata).
"""

from __future__ import annotations

import dataclasses
import operator
import os
import sys
import time
import traceback
from collections import Counter
from typing import Callable

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: frames of the analyzer itself, never a site
_SELF = tuple(os.path.join(_PKG_DIR, "analysis", f)
              for f in ("fx_walk.py", "oblint.py", "rangelint.py"))
#: exception type names that mean "the program branched or shaped itself
#: on a value the capture cannot know"
DEPENDENCE_ERRORS = ("GuardOnDataDependentSymNode", "DataDependentOutputException",
                     "DynamicOutputShapeException")
#: the same refusal in a real-mode capture (a value read from a traced input)
_REAL_MODE_DEPENDENCE = "get value out of a tracing tensor"


@torch.library.custom_op("gv_analysis::host_read", mutates_args=())
def host_read(t: torch.Tensor, how: str) -> None:
    """Marker of a host read of ``t`` (a no-op when run)."""


@host_read.register_fake
def _host_read_fake(t, how):
    return None


# ----------------------------------------------------------------------
# pytrees with dotted labels
# ----------------------------------------------------------------------


def flatten(value, label: str) -> tuple[list, list, Callable]:
    """``(labels, tensors, rebuild)`` of one argument: its tensor leaves
    in order, their dotted labels, and ``rebuild(tensors)`` giving the
    argument back with those tensors in place."""
    from ..oram.path_oram import ShardedPlane

    def sub(lbl, k):
        return f"{lbl}.{k}" if lbl else str(k)

    if isinstance(value, torch.Tensor):
        return [label], [value], lambda ts: ts[0]
    if isinstance(value, ShardedPlane):
        parts = [flatten(s, sub(label, f"shards.{i}")) for i, s in enumerate(value.shards)]
        n_local = value.n_local
        return _join(parts, lambda vs: ShardedPlane(vs, n_local))
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        parts = [flatten(getattr(value, f), sub(label, f)) for f in value._fields]
        return _join(parts, lambda vs: type(value)(*vs))
    if isinstance(value, dict):
        keys = list(value)
        parts = [flatten(value[k], sub(label, k)) for k in keys]
        return _join(parts, lambda vs: dict(zip(keys, vs)))
    if isinstance(value, (list, tuple)):
        parts = [flatten(v, sub(label, i)) for i, v in enumerate(value)]
        return _join(parts, lambda vs: type(value)(vs))
    return [], [], lambda ts: value


def _join(parts, build):
    labels, tensors, sizes = [], [], []
    for lb, ts, _ in parts:
        labels += lb
        tensors += ts
        sizes.append(len(ts))

    def rebuild(ts):
        out, i = [], 0
        for (_, _, rb), n in zip(parts, sizes):
            out.append(rb(ts[i:i + n]))
            i += n
        return build(out)

    return labels, tensors, rebuild


def _tensor_leaves(value) -> list:
    return flatten(value, "")[1]


# ----------------------------------------------------------------------
# sites
# ----------------------------------------------------------------------


#: helpers that stand for one JAX primitive (a drop-mode or
#: fresh-row scatter, a 1-element index, a u32 one-hot sum, the u32
#: lane helpers of ``u32.py``) and the kernels' wrappers: their caller is
#: the site, as the primitive's would be in the reference
_TRANSPARENT = {("oblivious/primitives.py", "scatter_drop"),
                ("oblivious/primitives.py", "scatter_fresh"),
                ("oblivious/primitives.py", "index1"),
                ("oblivious/primitives.py", "onehot_select"),
                ("engine/vphases.py", "_narrow_sum")}
_TRANSPARENT_MODULES = ("oblivious/gather_kernels.py", "oblivious/cipher_kernels.py", "u32.py")


def _site_of_frames(frames) -> str:
    """``file.py:function`` of the innermost package frame of ``frames``
    (innermost first), else of the innermost frame outside torch."""
    best = None
    for fname, func in frames:
        if fname in _SELF:
            continue
        if fname.startswith(_PKG_DIR + os.sep):
            rel = os.path.relpath(fname, _PKG_DIR)
            if (rel, func) in _TRANSPARENT or rel in _TRANSPARENT_MODULES:
                continue
            return f"{rel}:{func}"
        if best is None and "site-packages" not in fname and "/torch/" not in fname \
                and not fname.startswith("<"):
            best = f"{os.path.basename(fname)}:{func}"
    return best or "<unknown>"


def _stack_site() -> str:
    frames = []
    f = sys._getframe(2)
    while f is not None:
        frames.append((f.f_code.co_filename, f.f_code.co_name))
        f = f.f_back
    return _site_of_frames(frames)


def _traceback_site(exc: BaseException) -> str:
    frames = [(fs.filename, fs.name) for fs in traceback.extract_tb(exc.__traceback__)]
    return _site_of_frames(frames[::-1])


def site_of(node) -> str:
    """Stable source-site key of a node: ``file.py:function`` of the
    innermost package frame that created it (function granularity, no
    line numbers, so the allowlist survives line churn)."""
    return node.meta.get("gv_site", "<unknown>")


# ----------------------------------------------------------------------
# host reads
# ----------------------------------------------------------------------

#: Tensor methods that hand a tensor's values to the host
_HOST_READS = ("item", "tolist", "numpy", "__bool__", "__int__", "__index__",
               "__float__", "__complex__", "__repr__", "__str__", "__format__",
               "__array__")


def _to_cpu(name: str, args, kwargs) -> bool:
    """Is this call a copy of a CUDA tensor to the CPU?"""
    src = args[0] if args else None
    if not isinstance(src, torch.Tensor) or src.device.type == "cpu":
        return False
    if name == "cpu":
        return True
    if name == "to":
        for a in list(args[1:]) + list(kwargs.values()):
            if isinstance(a, (str, torch.device)) and torch.device(a).type == "cpu":
                return True
            if isinstance(a, torch.Tensor) and a is not src and a.device.type == "cpu":
                return True
    return False


class _HostReadMode(torch.overrides.TorchFunctionMode):
    """Records every host read of a tensor as a ``host_read`` node."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        if name in _HOST_READS or _to_cpu(name, args, kwargs):
            src = args[0] if args else None
            if isinstance(src, torch.Tensor):
                torch.ops.gv_analysis.host_read(src, name)
        elif name == "copy_" and len(args) > 1 and isinstance(args[1], torch.Tensor) \
                and args[0].device.type == "cpu" and args[1].device.type != "cpu":
            torch.ops.gv_analysis.host_read(args[1], "copy_")
        return func(*args, **kwargs)


# ----------------------------------------------------------------------
# capture
# ----------------------------------------------------------------------


@dataclasses.dataclass
class Capture:
    """One captured program: ``gm`` its graph (None when the capture
    stopped on a data-dependent guard, then ``dependence`` is
    ``(site, message)``), ``labels`` one per placeholder, ``seconds`` the
    capture's wall time."""

    name: str
    gm: object
    labels: list
    seconds: float
    dependence: tuple | None = None


def fake_inputs(build: Callable):
    """``build()``'s tensors made under a fake tensor mode: shapes and
    dtypes, no storage — the capture's own ``fake`` mode accepts them, so
    a 2^30-record engine is captured without allocating it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return build()


def _one_fake_mode(tracing_mode: str):
    """In real mode each node's metadata is a fake tensor made under a new
    ``FakeTensorMode`` unless a tracing context holds one; one mode for the
    whole capture makes a real capture about three times quicker."""
    import contextlib

    if tracing_mode != "real":
        return contextlib.nullcontext()
    from torch._guards import TracingContext, tracing
    from torch._subclasses.fake_tensor import FakeTensorMode

    return tracing(TracingContext(FakeTensorMode(allow_fallback_kernels=True)))


def capture(fn: Callable, *args, names=None, tracing_mode: str = "fake",
            name: str = "program") -> Capture:
    """Capture ``fn(*args)`` as a functional FX graph of aten ops.

    ``names`` labels the arguments (default ``arg0``, ``arg1``...);
    ``tracing_mode`` "fake" runs nothing (shapes only), "real" runs the
    program on its inputs while recording it (a kernel op launches)."""
    from torch._subclasses.functional_tensor import (
        FunctionalTensorMode,
        dispatch_functionalize,
    )
    from torch.fx.experimental.proxy_tensor import get_proxy_mode, make_fx

    names = list(names) if names is not None else [f"arg{i}" for i in range(len(args))]
    flat = [flatten(a, n) for a, n in zip(args, names)]
    labels = [lb for lbs, _, _ in flat for lb in lbs]
    tensors = [t for _, ts, _ in flat for t in ts]
    sizes = [len(ts) for _, ts, _ in flat]

    def run(*ts):
        vals, i = [], 0
        for (_, _, rebuild), n in zip(flat, sizes):
            vals.append(rebuild(list(ts[i:i + n])))
            i += n
        return _tensor_leaves(fn(*vals))

    def traced(*ts):
        tracer = get_proxy_mode().tracer
        create = tracer.create_node

        def create_node(*a, **k):
            node = create(*a, **k)
            node.meta["gv_site"] = _stack_site()
            return node

        tracer.create_node = create_node
        try:
            with _HostReadMode():
                return dispatch_functionalize(run, FunctionalTensorMode())(*ts)
        finally:
            del tracer.create_node

    t0 = time.perf_counter()
    try:
        with _one_fake_mode(tracing_mode):
            gm = make_fx(traced, tracing_mode=tracing_mode)(*tensors)
    except Exception as exc:  # a data-dependent capture is a finding
        if type(exc).__name__ not in DEPENDENCE_ERRORS \
                and _REAL_MODE_DEPENDENCE not in str(exc):
            raise
        return Capture(name, None, labels, time.perf_counter() - t0,
                       (_traceback_site(exc), f"{type(exc).__name__}: "
                        f"{str(exc).splitlines()[0] if str(exc) else ''}"))
    return Capture(name, gm, labels, time.perf_counter() - t0)


# ----------------------------------------------------------------------
# walking
# ----------------------------------------------------------------------


def subgraphs(gm, node) -> list:
    """The GraphModules a higher-order op node runs (cond branches,
    while_loop's cond and body), in argument order."""
    out = []

    def visit(a):
        if isinstance(a, torch.fx.Node) and a.op == "get_attr":
            sub = getattr(gm, a.target, None)
            if isinstance(sub, torch.fx.GraphModule):
                out.append(sub)
        elif isinstance(a, (list, tuple)):
            for x in a:
                visit(x)

    for a in node.args:
        visit(a)
    return out


def walk_nodes(gm):
    """Yield every ``call_function`` node, recursing into every subgraph."""
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        yield node
        for sub in subgraphs(gm, node):
            yield from walk_nodes(sub)


def op_name(target) -> str:
    """``aten.index.Tensor``-style name of a node target; a higher-order
    op is ``higher_order.<name>``, a Python function its ``__name__``."""
    if isinstance(target, torch._ops.OpOverload):
        return str(target)
    if isinstance(target, torch._ops.HigherOrderOperator):
        return f"higher_order.{target.name()}"
    if target is operator.getitem:
        return "getitem"
    return getattr(target, "__name__", str(target))


def inner_op(node):
    """The op an ``auto_functionalized`` node applies (else None)."""
    if op_name(node.target).startswith("higher_order.auto_functionalized"):
        return node.args[0]
    return None


def bound_args(node) -> dict:
    """A call's operands by schema name. An ``auto_functionalized`` node
    passes its op's operands by name; the v2 form passes each mutated
    one as ``_<name>_base_index`` into ``_all_bases``, resolved here."""
    if inner_op(node) is not None:
        kw = dict(node.kwargs)
        bases = kw.pop("_all_bases", None) or []
        for k in [k for k in kw if k.startswith("_") and k.endswith("_base_index")]:
            i = kw.pop(k)
            if isinstance(i, int) and i < len(bases):
                kw[k[1:-len("_base_index")]] = bases[i]
        return kw
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return dict(node.kwargs)
    return {**dict(zip((a.name for a in schema.arguments), node.args)), **node.kwargs}


def node_ops(node) -> list:
    """The op names a node stands for: its own, and for an
    ``auto_functionalized`` node the mutating op it wraps too."""
    names = [op_name(node.target)]
    inner = inner_op(node)
    if inner is not None:
        names.append(op_name(inner))
    return names


def _shape_sig(node) -> tuple:
    vals = node.meta.get("val")
    vals = vals if isinstance(vals, (list, tuple)) else [vals]
    return tuple(tuple(str(d) for d in v.shape) if isinstance(v, torch.Tensor) else None
                 for v in vals)


def census(gm, shapes: bool = False) -> Counter:
    """Op-name counts over a captured graph, recursively (an
    ``auto_functionalized`` node counts its wrapped op too). With
    ``shapes`` each key also carries the node's output shapes."""
    c: Counter = Counter()
    for node in walk_nodes(gm):
        for nm in node_ops(node):
            c[(nm, _shape_sig(node)) if shapes else nm] += 1
    return c


def kernel_nodes(gm) -> Counter:
    """Nodes of the port's kernel ops (namespace ``gv``), by kernel name."""
    return Counter(nm.split(".")[1] for node in walk_nodes(gm) for nm in node_ops(node)
                   if nm.startswith("gv."))


#: ops that move data between arrays at tensor-valued addresses — the
#: access schedule the transcript argument is about (the reference's
#: ``jaxpr_walk.ACCESS_PRIMS``: gather, every scatter). A slice or select
#: at Python-int bounds is a constant of the program, not an access; its
#: counterpart of JAX's ``dynamic_slice`` (a start read from a tensor) is
#: a host read first. The gather and scatter kernel ops count too
#: (:func:`is_access`); B2 (``gv.cipher_rows_pallas``) addresses no row.
GATHER_OPS = ("aten.index.Tensor", "aten.index_select.default", "aten.gather.default")
SCATTER_OPS = ("aten.index_put.default", "aten._unsafe_index_put.default",
               "aten.index_copy.default", "aten.index_add.default", "aten.scatter.src",
               "aten.scatter.value", "aten.scatter_add.default", "aten.scatter_reduce.two")
ACCESS_OPS = GATHER_OPS + SCATTER_OPS
#: data-dependent control: a host read of a value (``fx_walk.host_read``,
#: ``_local_scalar_dense``) or a ``cond``/``while_loop`` — forbidden
#: anywhere in a captured round (the reference's ``CONTROL_PRIMS``)
CONTROL_OPS = ("gv_analysis.host_read.default", "aten._local_scalar_dense.default",
               "higher_order.cond", "higher_order.while_loop")
#: sort-family ops (the reference counts the one ``sort`` primitive)
SORT_OPS = ("aten.sort.", "aten.argsort.", "aten.msort.", "aten.topk.", "aten.kthvalue.")


def is_access(name: str) -> bool:
    """Is this census key an access op (a gather, a scatter, or a kernel
    op that gathers or scatters rows)?"""
    return name in ACCESS_OPS or name.startswith(("gv.gather", "gv.scatter"))


def access_counts(c: Counter) -> dict:
    """``{"accesses", "gathers", "scatters"}`` of a census: a kernel op
    counts with the gathers or the scatters by its name."""
    def kern(prefix):
        return sum(v for k, v in c.items() if k.startswith(f"gv.{prefix}"))

    g = sum(c[k] for k in GATHER_OPS) + kern("gather")
    s = sum(c[k] for k in SCATTER_OPS) + kern("scatter")
    return {"accesses": sum(v for k, v in c.items() if is_access(k)), "gathers": g,
            "scatters": s}


def control_counts(c: Counter) -> dict:
    """The census's control ops and their counts (empty when oblivious)."""
    return {k: c[k] for k in CONTROL_OPS if c[k]}


def sort_census(gm) -> Counter:
    """Sort-family nodes of a captured graph, by site (``file.py:function``)."""
    return Counter(site_of(node) for node in walk_nodes(gm)
                   if any(nm.startswith(SORT_OPS) for nm in node_ops(node)))


def _val_shape(a):
    v = a.meta.get("val") if isinstance(a, torch.fx.Node) else None
    return tuple(v.shape) if isinstance(v, torch.Tensor) else None


#: gathers (rows = the output's leading dim) and scatters (rows = the
#: updates' leading dim, by operand name), both reading or writing "self"
_GATHERS = ("aten.index.Tensor", "aten.index_select.default", "aten.gather.default")
_SCATTERS = {"aten.index_put.default": "values", "aten.index_copy.default": "source",
             "aten.scatter.src": "src", "aten.scatter_add.default": "src"}
#: the kernel ops that move ``tree_val`` rows (``flat_b`` of them)
_KERNEL_ROWS = ("gather_decrypt_rows", "gather_decrypt_rows_tiled",
                "scatter_encrypt_rows", "scatter_encrypt_rows_tiled")


def _spill_base(node):
    """A scatter target made by ``primitives.scatter_drop`` is its plane
    with one spill row appended (``cat([plane, empty(1, ...)])``): the
    scatter writes that plane, as the reference's drop-mode scatter does."""
    if isinstance(node, torch.fx.Node) and op_name(node.target) == "aten.cat.default":
        parts = node.args[0]
        if len(parts) == 2 and all(isinstance(p, torch.fx.Node) for p in parts):
            a, b = (_val_shape(p) for p in parts)
            if a and b and b[0] == 1 and a[1:] == b[1:] and \
                    op_name(parts[1].target) in ("aten.new_empty.default", "aten.empty.memory_format"):
                return parts[0]
    return node


#: ops whose output is their first operand's plane (a view, a copy, or
#: its functional update)
_CARRIES = ("aten.view.", "aten._unsafe_view.", "aten.reshape.", "aten.alias.",
            "aten.slice.", "aten.clone.", "aten.detach.", "aten.index_put.",
            "aten._unsafe_index_put.", "aten.index_copy.", "aten.scatter.",
            "aten.scatter_add.", "aten.scatter_reduce.", "aten.slice_scatter.",
            "aten.select_scatter.", "aten.copy.", "aten.contiguous.")


def derived_planes(gm, sources) -> set:
    """The nodes of ``gm`` holding one of the ``sources`` placeholders'
    planes: the sources, their views and copies, their functional updates
    (a scatter's result, a ``scatter_drop`` buffer, a kernel's updated
    bases)."""
    out = set(sources)
    for node in gm.graph.nodes:
        if node.op != "call_function":
            continue
        name = op_name(node.target)
        first = node.args[0] if node.args else None
        if name.startswith(_CARRIES) and first in out:
            out.add(node)
        elif name == "aten.cat.default" and _spill_base(node) in out:
            out.add(node)
        elif name == "getitem" and inner_op(first) is not None and node.args[1] >= 1:
            bases = first.kwargs.get("_all_bases") or []
            if node.args[1] - 1 < len(bases) and bases[node.args[1] - 1] in out:
                out.add(node)
    return out


def plane_rows(gm, planes: dict, sources=None) -> dict:
    """Rows moved per named plane by every gather/scatter in the graph.

    ``planes`` maps name -> ``(shape, divisor)``: an operand whose shape
    equals ``shape`` is that plane; the moved leading dim is divided by
    ``divisor``. With ``sources`` (placeholder nodes) the operand must
    also hold one of their planes (:func:`derived_planes`), so a private
    array that happens to share a plane's shape is not counted. A
    gather's rows are its output's leading dim, a scatter's its updates'
    leading dim; a kernel node moves ``flat_b``'s length of rows of the
    ``(n, Z*V)`` value, ``(n, Z)`` slot and ``(n, 2)`` nonce planes.
    Entries are ``(op name, rows)``."""
    out: dict = {k: [] for k in planes}
    keep = derived_planes(gm, sources) if sources is not None else None
    for node in walk_nodes(gm):
        name = op_name(node.target)
        kern = op_name(inner_op(node) or node.target)
        args = bound_args(node)
        if kern.startswith("gv.") and kern.split(".")[1] in _KERNEL_ROWS:
            if keep is not None and args.get("tree_val") not in keep:
                continue
            name = kern.rsplit(".", 1)[0]
            rows = (_val_shape(args.get("flat_b")) or (0,))[0]
            n, zv = _val_shape(args.get("tree_val"))
            z = int(args["z"])
            # one kernel node moves flat_b's rows of the slot, value and
            # nonce planes: the (n, Z), (n, Z*V) and (n, 2) shapes the
            # plain path's three gathers (or scatters) move
            for shape in {(n, zv), (n, z), tuple(_val_shape(args.get("nonces")))}:
                for pname, (pshape, div) in planes.items():
                    if shape == tuple(pshape):
                        out[pname].append((name, rows // div))
            continue
        elif name in _GATHERS:
            target = args.get("self")
            moved = node.meta.get("val")
            rows = moved.shape[0] if isinstance(moved, torch.Tensor) and moved.dim() else 0
        elif name in _SCATTERS:
            target = _spill_base(args.get("self"))
            rows = (_val_shape(args.get(_SCATTERS[name])) or (0,))[0]
        else:
            continue
        if keep is not None and target not in keep:
            continue
        op_shape = _val_shape(target)
        for pname, (pshape, div) in planes.items():
            if op_shape == tuple(pshape):
                out[pname].append((name, rows // div))
    return out
