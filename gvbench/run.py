"""Run one cell of the benchmark once, on the card:

    python3 -m gvbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cell's
configuration (``gvbench/configs/<name>.json``) and traffic mix
(``gvbench/traffic/<name>.json``); each per-layer metric is a reader in
``gvbench/metrics/<name>.py``.

A run builds the engine of ``grapevine_tpu_torch`` on the card with the
configuration's knobs, makes the mix's rounds from the seed, runs the warm-up
rounds, then drives the facade (``GrapevineEngine.handle_queries_async`` and
``PendingRound.resolve``) in a closed loop for ``--seconds``, keeping the
mix's number of rounds in flight. It then reads back, through the same
entry, a sample of what the window's creates acknowledged; with
``--trace 1`` it first runs a few more rounds under the profiler. Once the
program is freed, every answer of every round is held against the plain
reference (``gvbench/reference.py``), and the program's count of stash
overflows (a block an ORAM could not keep) has to read 0. ``setup_s`` runs
from the process's start to the first timed operation, less the seconds
spent making the requests. The last line of standard output is
one JSON object; the numbers compared, each with its limit, end standard
error and the result's ``checks``.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from pathlib import Path  # noqa: E402

from . import costbytes, judge, reference, traffic  # noqa: E402
from . import trace as tr  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "grapevine_tpu")
#: rounds run before the profiler starts (so the pipeline is full) and
#: rounds traced, with ``--trace 1``
TRACE_LEAD, TRACE_ROUNDS = 2, 6
SIGNATURE = bytes(64)


def load_bench(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(items: list, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise SystemExit(f"gvbench: no {what} named {name!r} in BENCHMARK.json")


def load_reader(name: str):
    spec = importlib.util.spec_from_file_location("gvbench_metric_" + name.replace(".", "_"),
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def answers(resp):
    """One round's answers, packed (``gvbench.judge.Answers``)."""
    recs = [r.record for r in resp]
    return judge.Answers([r.status_code for r in resp], [r.msg_id for r in recs],
                   [r.sender for r in recs], [r.recipient for r in recs],
                   [r.timestamp for r in recs], [r.payload for r in recs])


def cpu_seconds() -> float:
    """CPU seconds this process has spent, user and system."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def p95_nearest_rank(rounds: list) -> tuple[float, int]:
    """95th percentile (nearest rank) over every op, from ``(latency, ops)``
    a round; and the op count."""
    total = sum(n for _l, n in rounds)
    want = math.ceil(0.95 * total)
    acc = 0
    for lat, n in sorted(rounds):
        acc += n
        if acc >= want:
            return lat, total
    raise ValueError("no rounds")


class GcClock:
    """Seconds spent in collections while installed in ``gc.callbacks``."""

    def __init__(self):
        self.seconds = 0.0
        self.count = 0
        self.longest = 0.0
        self.oldest = 0
        self._t = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            d = time.perf_counter() - self._t
            self.seconds += d
            self.count += 1
            self.longest = max(self.longest, d)
            self.oldest += info["generation"] == 2


class Loop:
    """The closed loop over the facade: dispatch a round, and once
    ``in_flight`` rounds are outstanding resolve the oldest. Every executed
    round is logged as ``(label, ops, now, answers)``, and every timed
    round's span ledger is kept in ``spans``: ``{"host": PendingRound.spans,
    "device": PendingRound.device_span_s}``. While ``host`` is a list, the
    host's intervals are noted in it for the trace (``gvbench.trace.reduce``)."""

    def __init__(self, eng, in_flight: int):
        self.eng = eng
        self.in_flight = in_flight
        self.pending: deque = deque()
        self.log: list = []
        self.dispatch_s: list = []
        self.latency: list = []
        self.spans: list = []
        self.timing = False
        self.host: list | None = None

    def dispatch(self, label: str, ops: list, reqs: list, now: int) -> None:
        t0 = time.perf_counter()
        p = self.eng.handle_queries_async(reqs, now)
        t1 = time.perf_counter()
        if self.timing:
            self.dispatch_s.append(t1 - t0)
        if self.host is not None:
            self.host.append((t0, t1, "facade.dispatch"))
        self.pending.append((label, ops, now, t0, p, self.timing))
        if len(self.pending) >= self.in_flight:
            self.resolve_one()

    def resolve_one(self) -> float:
        label, ops, now, t0, p, timed = self.pending.popleft()
        resp = p.resolve()
        t = time.perf_counter()
        if timed:
            self.latency.append((t - t0, len(ops)))
            self.spans.append({"host": p.spans, "device": p.device_span_s})
        self.log.append((label, ops, now, answers(resp)))
        if self.host is not None:
            spans = p.spans
            for name, lab in (("evict", "facade.resolve.wait"),
                              ("demux", "facade.resolve.demux")):
                if name in spans:
                    a, d = spans[name]
                    self.host.append((a, a + d, lab))
            self.host.append((t, time.perf_counter(), "bench.keep"))
        return t

    def drain(self) -> float:
        t = time.perf_counter()
        while self.pending:
            t = self.resolve_one()
        return t


class Prepared:
    """A cell's configuration, its traffic's rounds and their requests, made
    from the seed before the program is imported (only its wire types are).
    Knobs outside the byte arithmetic (``gvbench.costbytes``) are refused
    here, before the program loads."""

    def __init__(self, bench: dict, cell: dict, seed: int, engine_overrides: dict | None):
        t0 = time.perf_counter()
        config = find(bench["configs"], cell["config"], "configuration")
        cfile = json.loads((ROOT / config["file"]).read_text())
        self.record_size = int(cfile["record_size"])
        self.knobs = dict(cfile["engine"], **(engine_overrides or {}))
        self.trees_bytes = costbytes.tree_bytes(self.knobs, self.record_size)
        os.environ["GRAPEVINE_RECORD_SIZE"] = str(self.record_size)
        from grapevine_tpu_torch.wire import constants as C
        from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

        if C.RECORD_SIZE != self.record_size:
            raise RuntimeError(f"the program was loaded with {C.RECORD_SIZE} B records, "
                               f"the configuration runs {self.record_size} B")
        self.payload_size = C.PAYLOAD_SIZE
        self.mix = traffic.Traffic(traffic.load(cell["traffic"]),
                                   batch_size=self.knobs["batch_size"],
                                   max_recipients=self.knobs["max_recipients"],
                                   payload_size=C.PAYLOAD_SIZE, seed=seed)
        self._types = (QueryRequest, RequestRecord)
        self.reqs = [self.wrap(ops) for ops in self.mix.rounds]
        self.seconds = time.perf_counter() - t0

    def wrap(self, ops: list) -> list:
        request, record = self._types
        return [request(k, a, SIGNATURE, record(m, r, p)) for k, a, m, r, p in ops]


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", engine_overrides: dict | None = None, on_engine=None,
             prepared: Prepared | None = None, stages: dict | None = None) -> dict:
    """One run of ``cell``; returns the result object. ``engine_overrides``
    and ``device`` exist for the CPU tests (tiny sizes, plain kernels);
    ``on_engine(eng)`` lets a test break the program underneath;
    ``stages`` holds set-up seconds measured before the call."""
    prep = prepared or Prepared(bench, cell, seed, engine_overrides)
    stages = dict(stages or {}, traffic_s=prep.seconds)
    import torch

    t_stage = time.perf_counter()
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine

    stages["port_import_s"] = time.perf_counter() - t_stage
    if device != "cpu":
        # the kernels' library, built in the checkout's first run and
        # loaded from its build directory after that
        from grapevine_tpu_torch.oblivious import gather_kernels

        t_stage = time.perf_counter()
        before = set(gather_kernels.BUILD_DIR.glob("*.so"))
        gather_kernels.load_library()
        stages["library_s"] = time.perf_counter() - t_stage
        stages["library_built"] = set(gather_kernels.BUILD_DIR.glob("*.so")) != before
    knobs, record_size, mix, reqs, wrap = (prep.knobs, prep.record_size, prep.mix, prep.reqs,
                                           prep.wrap)
    t_stage = time.perf_counter()
    eng = GrapevineEngine(GrapevineConfig(**knobs), seed=seed % (1 << 63), device=device)
    stages["engine_s"] = time.perf_counter() - t_stage
    t_stage = time.perf_counter()
    if on_engine is not None:
        on_engine(eng)
    loop = Loop(eng, mix.in_flight)
    k = 0
    for _ in range(mix.warmup):
        loop.dispatch("warmup", mix.ops(k), reqs[k % len(reqs)], mix.now(k))
        k += 1
    loop.drain()
    if device != "cpu":
        torch.cuda.synchronize()
    gc.collect()
    stages["warmup_s"] = time.perf_counter() - t_stage

    clock = GcClock()
    gc.callbacks.append(clock)
    loop.timing = True
    cpu0 = cpu_seconds()
    t0 = time.perf_counter()
    # the requests stand for the clients: making them is not set-up
    setup_s = t0 - T_PROCESS - stages["traffic_s"]
    deadline = t0 + seconds
    first_window = len(loop.log) + len(loop.pending)
    while time.perf_counter() < deadline:
        loop.dispatch("window", mix.ops(k), reqs[k % len(reqs)], mix.now(k))
        k += 1
    t_end = loop.drain()
    cpu_s = cpu_seconds() - cpu0
    loop.timing = False
    gc.callbacks.remove(clock)
    window_s = t_end - t0
    window = loop.log[first_window:]

    summary = None
    traced_s = 0.0
    if trace and device == "cpu":
        summary = {"kernels": {}, "kernel_count": 0, "busy_s": 0.0, "window_s": 0.0,
                   "gaps": {}}
    elif trace:
        for _ in range(TRACE_LEAD):
            loop.dispatch("trace", mix.ops(k), reqs[k % len(reqs)], mix.now(k))
            k += 1
        marks: list = []
        loop.host = []
        prof = tr.capture()
        tr.mark(marks)
        t_tr = time.perf_counter()
        for _ in range(TRACE_ROUNDS):
            loop.dispatch("trace", mix.ops(k), reqs[k % len(reqs)], mix.now(k))
            k += 1
        loop.drain()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t_tr
        tr.mark(marks)
        prof.stop()
        summary = tr.reduce(prof, loop.host, marks)
        loop.host = None
        del prof

    acked = []
    for _label, ops, _now, got in window:
        for j, op in enumerate(ops):
            if op[0] == reference.CREATE and got.status_at(j) == reference.SUCCESS:
                acked.append((got.msg_id_at(j), op[1], op[3]))
    for ops in mix.readback(acked):
        loop.dispatch("readback", ops, wrap(ops), mix.now(k))
        k += 1
    loop.drain()
    health = eng.health()
    if device != "cpu":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        kind = torch.cuda.get_device_name(0)
    else:
        peak, kind = 0, "cpu"
    del eng, loop.eng
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    bus = reference.Bus(knobs["max_messages"], knobs["max_recipients"],
                        knobs["mailbox_cap"], prep.payload_size)
    j = judge.Judge(bus)
    wrong = {"warmup": 0, "window": 0, "trace": 0, "readback": 0}
    for label, ops, now, got in loop.log:
        wrong[label] += j.round(label, ops, now, got)
    ref_s = time.perf_counter() - t_ref

    checks = {
        "wrong_answers": {"value": wrong["warmup"] + wrong["window"] + wrong["trace"],
                          "limit": 0},
        "wrong_readbacks": {"value": wrong["readback"], "limit": 0},
        "stash_overflow": {"value": health["stash_overflow"], "limit": 0},
    }
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    attempted = sum(len(ops) for _l, ops, _n, _g in window)
    lat95, samples = p95_nearest_rank(loop.latency)
    run = {
        "dispatch_s": loop.dispatch_s, "gc_s": clock.seconds, "window_s": window_s,
        "window_rounds": len(window),
        "trace": summary, "trace_rounds": TRACE_ROUNDS, "engine": knobs,
        "record_size": record_size, "spans": loop.spans, "health": health,
        "peak": json.loads((HERE / "peaks.json").read_text()).get(kind),
    }
    if trace:
        metrics = {}
        for m in bench["per_layer"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            v = load_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {
            "ops_per_s": {"value": attempted / window_s, "unit": "ops/s"},
            "commit_p95_ms": {"value": 1e3 * lat95, "unit": "ms", "samples": samples},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    dev = {"platform": "gpu" if device != "cpu" else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": wrong["window"],
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        result["breakdown"] = tr.breakdown(summary)
    result["checks"] = checks
    info = {
        "cell": cell["name"], "seed": seed, "rounds_window": len(window),
        "window_s": window_s, "setup_s": setup_s, "reference_s": ref_s,
        "gc_collections": clock.count, "gc_s": clock.seconds, "gc_longest_s": clock.longest,
        "gc_oldest_generation": clock.oldest,
        "round_latency_s": sorted(lat for lat, _n in loop.latency)[::max(1, len(loop.latency) // 8)],
        "quarter_latency_s": [sum(lat for lat, _n in q) / max(1, len(q)) for q in (
            loop.latency[i * len(loop.latency) // 4:(i + 1) * len(loop.latency) // 4]
            for i in range(4))],
        "memory_peak_bytes": peak,
        "setup_stages": stages, "traced_round_s": traced_s / TRACE_ROUNDS,
        "window_round_s": window_s / max(1, len(window)),
        "trees_bytes": prep.trees_bytes, "round_graph": health.get("round_graph"),
        "judged": j.judged, "examples": j.examples,
        "cpu_s_per_round": cpu_s / max(1, len(window)),
        "dispatch_s_mean": sum(loop.dispatch_s) / max(1, len(loop.dispatch_s)),
        "torch_threads": torch.get_num_threads(),
        "trace_tied": summary.get("tied") if summary else None,
    }
    result["_info"] = info
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m gvbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_bench(ROOT)
    cell = find(bench["workloads"], args.workload, "workload")
    prep = Prepared(bench, cell, args.seed, None)
    # the requests stand for the clients' side: frozen out of the
    # collector's generations, with everything made before the program's
    # import, so a collection in the run walks the program's objects only
    gc.collect()
    gc.freeze()
    t_torch = time.perf_counter()
    import torch

    stages = {"torch_import_s": time.perf_counter() - t_torch}

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"gvbench: the cell needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                      prepared=prep, stages=stages)
    info = result.pop("_info")
    bad = forbidden_modules()
    if bad:
        print(f"gvbench: the run loaded {bad}; it may load neither JAX nor the JAX "
              "package", file=sys.stderr)
        return 4
    print(json.dumps(info, default=str), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
