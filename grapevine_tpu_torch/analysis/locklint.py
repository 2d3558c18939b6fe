"""Locklint: static lock-discipline lint for the port's pipelined host
path (a copy of ``grapevine_tpu/analysis/locklint.py`` pointed at the
port's ``engine/batcher.py``, ``server/scheduler.py``,
``engine/journal.py`` and ``server/hostpipe.py``; its reviewed list adds
the port's admission bound).

The device path's obliviousness proof (:mod:`.oblint`) has a host-side
twin: the batcher is a staged pipeline whose correctness hangs on a lock
discipline that exists only in docstrings. This lint derives the
discipline from the AST of those files and asserts it statically:

1. **Single-hold**: ``GrapevineEngine.handle_queries_async``
   journals AND dispatches inside exactly one ``self._lock`` hold —
   journal order IS dispatch order, so replay order is journal order at
   every pipeline depth. Neither stage acquires a lock of its own.
2. **Stage 1 outside the lock**: assemble/validate/pack
   (``_assemble_round``, ``pack_batch``, ``validate_request``) never
   run under any engine lock — the pipeline's whole point is that the
   next round's host work overlaps the device.
3. **Journal is lock-free**: ``BatchJournal`` documents "every call
   runs under the engine lock" — it must never grow a lock of its own
   (a second lock under the engine hold is an ordering hazard).
4. **No lock-ordering cycle**: the acquired-while-holding graph over
   every discovered lock (collector cv, engine lock, and any future
   addition) must be acyclic, including cross-object edges through
   known bindings (``BatchScheduler.engine`` is a GrapevineEngine).
5. **Shared-attribute coverage**: any attribute written outside
   ``__init__`` and touched from more than one thread role (the
   collector thread vs submitter/probe threads, derived from
   ``threading.Thread(target=self._run)``) must hold a lock at every
   access — unless a reviewed entry in LOCK_ALLOW documents the benign
   race. A new unprotected shared attribute fails the lint by default.

Nested helper functions (e.g. ``settle_head`` inside ``_run_inner``)
are folded into their defining method with the def-site lock context;
this matches current call sites and over-reports rather than misses.
"""

from __future__ import annotations

import ast
import dataclasses
import os

_LOCK_CTORS = ("Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore")


@dataclasses.dataclass(frozen=True)
class LockViolation:
    kind: str  # same-hold | stage1-under-lock | journal-lock |
    #            lock-cycle | shared-attr | missing-code
    where: str  # "Class.method" or "Class.attr"
    message: str

    def __str__(self) -> str:
        return f"{self.kind}: {self.where} — {self.message}"


@dataclasses.dataclass(frozen=True)
class LockAllow:
    """One reviewed benign race: (class, attr) plus its argument.

    ``reads_only=True`` tolerates unlocked *reads* while still failing
    an unlocked write — the single-writer-behind-the-lock pattern."""

    cls: str
    attr: str
    reason: str
    reads_only: bool = False


#: the reviewed benign-race list (the locklint analog of the oblint
#: allowlist; every entry carries its argument)
LOCK_ALLOW: tuple = (
    LockAllow("BatchScheduler", "_inflight_since",
              "single-writer collector float (written off-lock on the "
              "collector only); stall_age's unlocked read is "
              "monotonic-clock math, worst case one stale probe"),
    LockAllow("BatchScheduler", "_shutdown",
              "monotonic bool: set only under the cv by close(); the "
              "crash handler's unlocked read risks one extra supervised "
              "restart, never a wrong drain", reads_only=True),
    LockAllow("GrapevineEngine", "state",
              "every write runs under the engine lock (in-body or via "
              "the lock-held dispatch stage); message_count/"
              "recipient_count take an unlocked reference snapshot for "
              "gauges — atomic in CPython, one round stale at worst",
              reads_only=True),
    LockAllow("HostPipeline", "_closing",
              "monotonic shutdown latch (False -> True once, in "
              "close()): reader threads and submitters take unlocked "
              "reads; a stale False risks one submit racing close — it "
              "fails on the closed pipe with HostWorkerCrash, never a "
              "wrong result — and a stale True only skips crash "
              "handling the close path is about to do anyway"),
    LockAllow("GrapevineEngine", "_rounds_since_flush",
              "every write runs under the engine lock "
              "(_flush_window_locked / recovery); flush_bubble_pending "
              "takes one unlocked int read for the scheduler's window "
              "decision — CPython-atomic, one round stale at worst, "
              "and a stale read only mistimes a collection-window "
              "stretch (latency, never correctness or cadence: the "
              "flush itself still fires strictly every evict_every "
              "rounds under the lock)", reads_only=True),
    LockAllow("GrapevineEngine", "leakmon",
              "attach-before-serve single reference assignment"),
    LockAllow("GrapevineEngine", "tracer",
              "attach-before-serve single reference assignment"),
    LockAllow("GrapevineEngine", "slo",
              "attach-before-serve single reference assignment"),
    LockAllow("GrapevineEngine", "workload",
              "attach-before-serve single reference assignment"),
    LockAllow("GrapevineEngine", "costmon",
              "attach-before-serve single reference assignment"),
    LockAllow("GrapevineEngine", "_replay_since",
              "recovery-only scratch (the replay cadence audit): "
              "written exclusively inside __init__'s single-threaded "
              "journal replay, before any scheduler/collector thread "
              "exists; never touched after construction"),
    # the port's admission bound (engine/batcher.py ``_admission``): its
    # state is touched only under the engine lock, through methods the
    # lint cannot see into; resolving threads hand values over through
    # the ``_resolved`` deque and never write these
    LockAllow("GrapevineEngine", "_known",
              "every write runs under the engine lock: _fold_resolved "
              "and _admission run only inside the lock-held dispatch "
              "stage, and _read_bound_locked inside it, inside expire's "
              "hold, or in __init__ before any thread exists"),
    LockAllow("GrapevineEngine", "_bound_version",
              "the state version the bound belongs to: written with "
              "_known, under the engine lock (same argument)"),
    LockAllow("GrapevineEngine", "_state_version",
              "bumped only by _set_state, which runs under the engine "
              "lock (the dispatch stage, the flush, the sweep, a "
              "standby's apply and install) or in __init__ before any "
              "thread exists; read with _known (same argument)"),
    # the round graph (engine/round_graph.py): the state behind the
    # ``state`` property and the graph are written through methods the
    # lint cannot see into, each called under the engine lock
    LockAllow("GrapevineEngine", "_state",
              "rebound only by _set_state (under the engine lock or in "
              "__init__, as _state_version), never once the round graph "
              "exists (copied into instead); the property's unlocked "
              "reads are the reference snapshots the 'state' entry "
              "argues"),
    LockAllow("GrapevineEngine", "_graph",
              "set once, in the lock-held dispatch stage; read by "
              "_eager_reason inside that stage and by _set_state under "
              "the same lock"),
    LockAllow("GrapevineEngine", "_dispatched",
              "the dispatch counter: incremented only in the lock-held "
              "dispatch stage; _read_bound_locked's read runs under the "
              "same lock (same argument)", reads_only=True),
)


# ---------------------------------------------------------------------------
# per-class fact extraction


@dataclasses.dataclass
class _Method:
    name: str
    acquired: set = dataclasses.field(default_factory=set)  # lock names
    #: (lock, region_id) -> set of callee keys in that region
    regions: dict = dataclasses.field(default_factory=dict)
    #: callee key -> set of frozenset(held) contexts it was called under
    calls: dict = dataclasses.field(default_factory=dict)
    #: attr -> list of (is_write, frozenset(held))
    attrs: dict = dataclasses.field(default_factory=dict)
    #: (held_lock, acquired_lock) pairs from directly nested `with`s
    nested: set = dataclasses.field(default_factory=set)
    worker_root: bool = False  # threading.Thread(target=self.<this>)


@dataclasses.dataclass
class _Class:
    name: str
    locks: set = dataclasses.field(default_factory=set)
    methods: dict = dataclasses.field(default_factory=dict)
    #: self.<attr> -> bound class name (constructor annotations)
    bindings: dict = dataclasses.field(default_factory=dict)


def _self_attr(node) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _callee_key(call: ast.Call):
    """'m' for self.m(), 'f' for f(), ('attr', 'm') for self.attr.m()."""
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        base = _self_attr(f)
        if base is not None:
            return f.attr  # self.m(...)
        inner = _self_attr(f.value) if isinstance(f.value, ast.AST) else None
        if inner is not None:
            return (inner, f.attr)  # self.attr.m(...)
    return None


class _MethodVisitor(ast.NodeVisitor):
    def __init__(self, cls: _Class, meth: _Method):
        self.cls = cls
        self.m = meth
        self.held: list = []
        self._region_n = 0

    # -- lock regions ---------------------------------------------------

    def visit_With(self, node: ast.With):
        lock_items = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr in self.cls.locks:
                lock_items.append(attr)
        for lk in lock_items:
            for held_lk, _ in self.held:
                if held_lk != lk:
                    self.m.nested.add((held_lk, lk))
            self._region_n += 1
            self.m.acquired.add(lk)
            self.m.regions[(lk, self._region_n)] = set()
            self.held.append((lk, self._region_n))
        for stmt in node.body:
            self.visit(stmt)
        for _ in lock_items:
            self.held.pop()
        # visit the context expressions too (e.g. time_phase(...) calls)
        for item in node.items:
            if _self_attr(item.context_expr) not in self.cls.locks:
                self.visit(item.context_expr)

    # -- calls ----------------------------------------------------------

    def visit_Call(self, node: ast.Call):
        key = _callee_key(node)
        held = frozenset(lk for lk, _ in self.held)
        if key is not None and not (
            isinstance(key, str) and key in self.cls.locks
        ):
            self.m.calls.setdefault(key, set()).add(held)
            for lk, rid in self.held:
                self.m.regions[(lk, rid)].add(key)
        # worker-root detection: threading.Thread(target=self._run)
        fn = node.func
        if (isinstance(fn, ast.Attribute) and fn.attr == "Thread") or (
            isinstance(fn, ast.Name) and fn.id == "Thread"
        ):
            for kw in node.keywords:
                tgt = kw.value
                if kw.arg == "target" and _self_attr(tgt) is not None:
                    root = _self_attr(tgt)
                    if root in self.cls.methods:
                        self.cls.methods[root].worker_root = True
                    else:  # method parsed later; mark via sentinel
                        self.cls.methods.setdefault(
                            root, _Method(root)
                        ).worker_root = True
        self.generic_visit(node)

    # -- attribute access ----------------------------------------------

    def visit_Attribute(self, node: ast.Attribute):
        attr = _self_attr(node)
        if attr is not None and attr not in self.cls.locks:
            is_write = isinstance(node.ctx, (ast.Store, ast.Del))
            self.m.attrs.setdefault(attr, []).append(
                (is_write, frozenset(lk for lk, _ in self.held))
            )
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign):
        attr = _self_attr(node.target)
        if attr is not None and attr not in self.cls.locks:
            self.m.attrs.setdefault(attr, []).append(
                (True, frozenset(lk for lk, _ in self.held))
            )
        self.generic_visit(node)


def _extract(tree: ast.Module) -> dict:
    """module AST -> {class name: _Class facts}."""
    out: dict = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        cls = _Class(node.name)
        out[cls.name] = cls
        # pass 1: lock attributes + constructor bindings
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                attr = _self_attr(sub.targets[0])
                v = sub.value
                if attr and isinstance(v, ast.Call):
                    ctor = (
                        v.func.attr if isinstance(v.func, ast.Attribute)
                        else v.func.id if isinstance(v.func, ast.Name)
                        else None
                    )
                    if ctor in _LOCK_CTORS:
                        cls.locks.add(attr)
        for sub in node.body:
            if isinstance(sub, ast.FunctionDef) and sub.name == "__init__":
                for a in sub.args.args:
                    ann = a.annotation
                    if ann is not None:
                        nm = (
                            ann.id if isinstance(ann, ast.Name)
                            else ann.attr if isinstance(ann, ast.Attribute)
                            else None
                        )
                        if nm:
                            cls.bindings[a.arg] = nm
                # self.x = <argname> carries the annotation to the attr
                for st in ast.walk(sub):
                    if (isinstance(st, ast.Assign)
                            and len(st.targets) == 1
                            and isinstance(st.value, ast.Name)):
                        attr = _self_attr(st.targets[0])
                        argname = st.value.id
                        if attr and argname in cls.bindings:
                            cls.bindings[attr] = cls.bindings[argname]
        # pass 2: per-method walk
        for sub in node.body:
            if isinstance(sub, ast.FunctionDef):
                m = cls.methods.setdefault(sub.name, _Method(sub.name))
                m.name = sub.name
                _MethodVisitor(cls, m).visit(sub)
    return out


# ---------------------------------------------------------------------------
# derived facts


def _transitive_acquires(cls: _Class) -> dict:
    """method -> set of locks it may acquire (self-calls followed)."""
    acq = {n: set(m.acquired) for n, m in cls.methods.items()}
    changed = True
    while changed:
        changed = False
        for n, m in cls.methods.items():
            for key in m.calls:
                if isinstance(key, str) and key in acq:
                    if not acq[key] <= acq[n]:
                        acq[n] |= acq[key]
                        changed = True
    return acq


def _roles(cls: _Class) -> dict:
    """method -> {'worker'} | {'caller'} | both; worker = transitive
    closure of Thread-target roots, caller = everything else public or
    reachable from elsewhere. ``__init__`` is excluded entirely."""
    worker = {n for n, m in cls.methods.items() if m.worker_root}
    changed = True
    while changed:
        changed = False
        for n in list(worker):
            m = cls.methods.get(n)
            if m is None:
                continue
            for key in m.calls:
                if isinstance(key, str) and key in cls.methods \
                        and key not in worker:
                    worker.add(key)
                    changed = True
    roles = {}
    for n in cls.methods:
        if n == "__init__":
            continue
        roles[n] = {"worker"} if n in worker else {"caller"}
    return roles


def _lock_graph(classes: dict) -> list:
    """Edges (held_lock, acquired_lock) as (Class.lock, Class.lock)."""
    edges = set()
    for cls in classes.values():
        acq = _transitive_acquires(cls)
        for m in cls.methods.values():
            for (lk, _rid), callees in m.regions.items():
                src = f"{cls.name}.{lk}"
                for key in callees:
                    if isinstance(key, str):
                        if key in cls.locks:
                            continue
                        for lk2 in acq.get(key, ()):  # self.m() acquiring
                            edges.add((src, f"{cls.name}.{lk2}"))
                    elif isinstance(key, tuple):  # self.attr.m()
                        bound = cls.bindings.get(key[0])
                        tgt = classes.get(bound) if bound else None
                        if tgt is not None:
                            tacq = _transitive_acquires(tgt)
                            for lk2 in tacq.get(key[1], ()):
                                edges.add((src, f"{tgt.name}.{lk2}"))
            # directly nested `with` acquisitions (recorded at
            # acquisition time with the precise held set)
            for held_lk, acq_lk in m.nested:
                edges.add(
                    (f"{cls.name}.{held_lk}", f"{cls.name}.{acq_lk}")
                )
    return sorted(edges)


def _find_cycle(edges: list) -> list | None:
    graph: dict = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    seen, stack = set(), []

    def dfs(n):
        if n in stack:
            return stack[stack.index(n):] + [n]
        if n in seen:
            return None
        seen.add(n)
        stack.append(n)
        for nxt in graph.get(n, ()):
            cyc = dfs(nxt)
            if cyc:
                return cyc
        stack.pop()
        return None

    for n in list(graph):
        cyc = dfs(n)
        if cyc:
            return cyc
    return None


# ---------------------------------------------------------------------------
# the lint


def lint_sources(sources: dict, allow: tuple = LOCK_ALLOW) -> list:
    """Lint {filename: python source}; returns LockViolations.

    The invariant spec is fixed (it IS the repo's documented
    discipline): GrapevineEngine/_lock single-hold over
    _journal_round+_dispatch_round, stage-1 callees outside every lock,
    BatchJournal lock-free, acyclic lock graph, role-covered shared
    attributes in BatchScheduler and GrapevineEngine."""
    classes: dict = {}
    for fname, src in sources.items():
        classes.update(_extract(ast.parse(src, filename=fname)))
    out: list = []

    # 1. single hold ------------------------------------------------------
    eng = classes.get("GrapevineEngine")
    if eng is None or "handle_queries_async" not in eng.methods:
        out.append(LockViolation(
            "missing-code", "GrapevineEngine.handle_queries_async",
            "the pipelined dispatch path is gone — the single-hold invariant "
            "cannot be checked"))
    else:
        m = eng.methods["handle_queries_async"]
        lock_regions = [
            callees for (lk, _), callees in m.regions.items()
            if lk == "_lock"
        ]
        both = [
            r for r in lock_regions
            if "_journal_round" in r and "_dispatch_round" in r
        ]
        if len(lock_regions) != 1 or not both:
            out.append(LockViolation(
                "same-hold", "GrapevineEngine.handle_queries_async",
                f"journal+dispatch must share exactly ONE _lock hold "
                f"(found {len(lock_regions)} hold(s), "
                f"{len(both)} containing both stages) — split holds let "
                "another round dispatch between append and enqueue, and "
                "replay order stops being journal order"))
        acq = _transitive_acquires(eng)
        for stage in ("_journal_round", "_dispatch_round"):
            if acq.get(stage):
                out.append(LockViolation(
                    "same-hold", f"GrapevineEngine.{stage}",
                    f"stage acquires {sorted(acq[stage])} of its own — "
                    "stages run inside the caller's hold, a nested "
                    "acquire is an ordering hazard"))

    # 2. stage-1 outside every lock ----------------------------------------
    stage1 = ("_assemble_round", "pack_batch", "validate_request")
    if eng is not None:
        # does method m (when called) transitively reach a stage-1 fn?
        reaches: dict = {n: False for n in eng.methods}
        changed = True
        while changed:
            changed = False
            for n, m in eng.methods.items():
                if reaches[n]:
                    continue
                for key in m.calls:
                    if key in stage1 or (
                        isinstance(key, str) and reaches.get(key, False)
                    ):
                        reaches[n] = True
                        changed = True
        for n, m in eng.methods.items():
            for key, helds in m.calls.items():
                hits_stage1 = key in stage1 or (
                    isinstance(key, str) and reaches.get(key, False)
                )
                if hits_stage1 and any(helds_i for helds_i in helds
                                       if helds_i):
                    out.append(LockViolation(
                        "stage1-under-lock", f"GrapevineEngine.{n}",
                        f"{key} runs under "
                        f"{sorted(h for hs in helds for h in hs)} — "
                        "stage-1 host work under the engine lock "
                        "serializes the pipeline it exists to overlap"))

    # 3. journal lock-free --------------------------------------------------
    jr = classes.get("BatchJournal")
    if jr is None:
        out.append(LockViolation(
            "missing-code", "BatchJournal",
            "engine/journal.py no longer defines BatchJournal"))
    elif jr.locks:
        out.append(LockViolation(
            "journal-lock", "BatchJournal",
            f"declares lock(s) {sorted(jr.locks)} — the journal runs "
            "under the engine lock by contract; a second lock under "
            "that hold is an ordering hazard"))

    # 4. ordering cycle -----------------------------------------------------
    cyc = _find_cycle(_lock_graph(classes))
    if cyc:
        out.append(LockViolation(
            "lock-cycle", " -> ".join(cyc),
            "lock acquired while holding another along a cycle — "
            "two threads taking the ends concurrently deadlock"))

    # 5. shared attributes --------------------------------------------------
    allow_by_key = {(a.cls, a.attr): a for a in allow}
    used_allows: set = set()
    for cname in ("BatchScheduler", "GrapevineEngine", "HostPipeline"):
        cls = classes.get(cname)
        if cls is None:
            continue
        has_thread = any(m.worker_root for m in cls.methods.values())
        roles = _roles(cls)
        # a method whose every in-class call site holds a lock runs in
        # the caller's critical section — its accesses count as locked
        # (the batcher's journal/dispatch stages). Methods never called
        # in-class (public entry points, callbacks) don't qualify.
        call_sites: dict = {}
        for m in cls.methods.values():
            for key, helds in m.calls.items():
                if isinstance(key, str) and key in cls.methods:
                    call_sites.setdefault(key, []).extend(helds)
        lock_ctx = {
            n for n, sites in call_sites.items()
            if sites and all(sites)
        }
        per_attr: dict = {}
        for n, m in cls.methods.items():
            if n == "__init__":
                continue
            for attr, accesses in m.attrs.items():
                rec = per_attr.setdefault(
                    attr, {"roles_w": set(), "roles_r": set(),
                           "unlocked_w": [], "unlocked_r": []}
                )
                for is_write, held in accesses:
                    (rec["roles_w"] if is_write else rec["roles_r"]).update(
                        roles.get(n, set())
                    )
                    if not held and n not in lock_ctx:
                        rec["unlocked_w" if is_write else "unlocked_r"].append(n)
        for attr, rec in sorted(per_attr.items()):
            if not rec["roles_w"]:
                continue  # never written post-init: immutable publish
            # with an in-class collector thread, a single-role attr is
            # genuinely private to that thread; a pure lock facade
            # (GrapevineEngine) is called from arbitrary threads, so
            # every post-init-written attr is shared by standing
            shared = (
                len(rec["roles_w"] | rec["roles_r"]) > 1
                if has_thread else True
            )
            entry = allow_by_key.get((cname, attr))
            unlocked = rec["unlocked_w"] + (
                [] if entry is not None and entry.reads_only
                else rec["unlocked_r"]
            )
            if entry is not None and not entry.reads_only:
                unlocked = []
            if entry is not None and shared and (
                rec["unlocked_w"] or rec["unlocked_r"]
            ):
                used_allows.add((cname, attr))
            if shared and unlocked:
                sites = ", ".join(sorted(set(unlocked))[:4])
                out.append(LockViolation(
                    "shared-attr", f"{cname}.{attr}",
                    f"written post-init and reachable from multiple "
                    f"threads with unlocked access in [{sites}] — hold "
                    "the lock or add a reviewed LOCK_ALLOW entry with "
                    "the benign-race argument"))

    # 6. LOCK_ALLOW reachability: an entry that suppresses nothing is a
    # rotting permission (the oblint dead-entry rule, host-side)
    for a in allow:
        if a.cls in classes and (a.cls, a.attr) not in used_allows:
            out.append(LockViolation(
                "dead-allow", f"{a.cls}.{a.attr}",
                f"LOCK_ALLOW entry ({a.reason!r}) matches no unlocked "
                "shared access — the race it documented is gone; "
                "delete the entry"))
    return out


def repo_sources(root: str | None = None) -> dict:
    """The host-path files the lint covers, from the live tree."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = {}
    for rel in ("engine/batcher.py", "server/scheduler.py",
                "engine/journal.py", "server/hostpipe.py"):
        with open(os.path.join(root, rel)) as fh:
            out[rel] = fh.read()
    return out


def lint_repo(root: str | None = None) -> list:
    return lint_sources(repo_sources(root))
