"""Split a benchmark cell's dispatch by the facade's stage spans, on the card:

    python3 stage_split.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs the cell as ``python3 -m gvbench.run`` does (``gvbench.run.run_cell``:
the same configuration, traffic, window and checks). Through ``run_cell``'s
``on_engine`` hook it notes every round's span ledger
(``PendingRound.spans``), event-timed device span
(``PendingRound.device_span_s``) and whether it replayed the round graph
(``PendingRound.replayed``) as the round resolves, and reads them over the
window's rounds. With ``--trace 1`` the traced rounds' five
stages (``obs/tracer.py:STAGE_SPANS``) join the host intervals that
``gvbench.trace.reduce`` names the idle gaps after, as
``facade.dispatch.<stage>``. Standard output's last line is gvbench's result
with one more key, ``stages``: the window's mean milliseconds a round of
every span, the device span, the round period, the stages' sum against the
benchmark's ``facade.dispatch_ms``, the share of the window's rounds that
replayed the round graph beside the ``launch`` ms a round (also on standard
error), the thread CPU ms a round of ``pack`` (``pack_cpu_ms``: its wall less
this is time the thread waited for a core), and with ``--trace 1`` every idle
gap by label (seconds over the traced rounds) and the collections that ran in
the traced stretch (``traced_collections``). A collection is a host interval
``gc.gen<N>`` too, so an idle gap that opens inside one is named after it.
A program without the round graph reads as no round replayed.

The program is imported only once ``gvbench.run.Prepared`` has set the
cell's record size, so the names of the stages are read from it late.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def _stages() -> tuple:
    from grapevine_tpu_torch.obs.tracer import STAGE_SPANS

    return STAGE_SPANS


#: the facade's own spans, which ``summarize`` averages after the stages
FACADE_SPANS = ("dispatch", "evict", "demux", "device", "round")


def stage_intervals(spans: dict, stages: tuple, after: float = float("-inf")) -> list:
    """A ledger's stages as ``gvbench.trace.reduce``'s host intervals,
    ``(start_s, end_s, "facade.dispatch.<stage>")``, those starting at or
    after ``after``."""
    return [(a, a + d, f"facade.dispatch.{name}")
            for name in stages if name in spans
            for a, d in (spans[name],) if a >= after]


class GcLog:
    """Every collection while installed in ``gc.callbacks``: ``(start_s,
    end_s, generation)`` on the ``perf_counter`` clock."""

    def __init__(self):
        self.seen: list = []
        self._t = 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.seen.append((self._t, time.perf_counter(), info["generation"]))


def collection_intervals(seen: list, after: float, until: float) -> list:
    """The collections that started in ``[after, until]`` as host
    intervals, ``(start_s, end_s, "gc.gen<N>")``."""
    return [(a, b, f"gc.gen{g}") for a, b, g in seen if after <= a <= until]


def _mean_ms(seconds: list, n: int) -> float | None:
    """Mean of ``seconds`` in ms, where each of the ``n`` rounds has one."""
    return 1e3 * sum(seconds) / n if n and len(seconds) == n else None


def summarize(rounds: list, info: dict, gaps: dict | None, stages: tuple,
              pack_cpu_s: list | None = None, collections: list | None = None) -> dict:
    """The window's mean ms a round of each span, and the checks against
    the benchmark's own numbers. ``rounds`` holds ``(spans, device_span_s,
    replayed)`` a window round, ``info`` is the run's ``_info``, ``gaps``
    the traced idle seconds by label (None untraced), ``pack_cpu_s`` the
    thread CPU seconds of each window round's pack, ``collections`` the
    traced stretch's host intervals of collections."""
    n = len(rounds)
    mean = {name: _mean_ms([s[name][1] for s, _dev, _r in rounds if name in s], n)
            for name in stages + FACADE_SPANS}
    out = {
        "rounds": n,
        "mean_ms": mean,
        "replayed_share": sum(1 for _s, _d, r in rounds if r) / n if n else None,
        "launch_ms": mean.get("launch"),
        "pack_cpu_ms": _mean_ms(pack_cpu_s or [], n),
        "device_span_ms": _mean_ms([d for _s, d, _r in rounds if d is not None], n),
        "window_round_ms": 1e3 * info["window_round_s"],
        "facade_dispatch_ms": 1e3 * info["dispatch_s_mean"],
    }
    if n and all(mean[name] is not None for name in stages):
        staged = mean["pack"] + mean["dispatch"]
        out["pack_plus_dispatch_ms"] = staged
        out["pack_plus_dispatch_over_facade"] = staged / out["facade_dispatch_ms"]
        out["stages_over_dispatch_span"] = (sum(mean[name] for name in stages
                                                if name != "pack") / mean["dispatch"])
    if collections is not None:
        out["traced_collections"] = [{"generation": int(lab[len("gc.gen"):]),
                                      "ms": 1e3 * (b - a)} for a, b, lab in collections]
    if gaps is not None:
        out["idle_gaps_s"] = dict(sorted(gaps.items(), key=lambda kv: -kv[1]))
        inside = {k: v for k, v in gaps.items() if k.startswith("facade.dispatch")}
        total = sum(inside.values())
        out["dispatch_idle_s"] = total
        out["dispatch_unstaged_share"] = (inside.get("facade.dispatch", 0.0) / total
                                          if total > 0 else None)
    return out


class _Kept:
    """A round handle that notes its ledger, device span and whether it
    replayed the round graph once resolved, and holds nothing of the round
    after that."""

    def __init__(self, p, sink: list):
        self._p, self._sink = p, sink

    def resolve(self):
        out = self._p.resolve()
        self._sink.append((self._p.spans, self._p.device_span_s,
                           getattr(self._p, "replayed", False)))
        return out

    def __getattr__(self, name):
        return getattr(self._p, name)


def staged_run(bench: dict, cell: dict, seed: int, seconds: float, trace: bool,
               prepared) -> dict:
    """``gvbench.run.run_cell`` with every round's ledger kept as it
    resolves (the benchmark's loop resolves in dispatch order); its result
    with ``stages`` added."""
    from gvbench import run as gv

    resolved: list = []
    packs: list = []
    gaps: list = []
    traced: list = []
    log = GcLog()

    def keep_ledgers(eng):
        dispatch, assemble = eng.handle_queries_async, eng._assemble_round
        eng.handle_queries_async = lambda reqs, now: _Kept(dispatch(reqs, now), resolved)

        def timed_assemble(*a, **k):
            c = time.thread_time()
            try:
                return assemble(*a, **k)
            finally:
                packs.append(time.thread_time() - c)

        eng._assemble_round = timed_assemble

    reduce = gv.tr.reduce

    def reducing(prof, host, marks):
        for spans, _dev, _replayed in resolved:
            host.extend(stage_intervals(spans, _stages(), after=marks[0]))
        traced.extend(collection_intervals(log.seen, marks[0], marks[-1]))
        host.extend(traced)
        s = reduce(prof, host, marks)
        gaps.append(s["gaps"])
        return s

    gv.tr.reduce = reducing
    gc.callbacks.append(log)
    try:
        result = gv.run_cell(bench, cell, seed, seconds, trace, on_engine=keep_ledgers,
                             prepared=prepared)
    finally:
        gc.callbacks.remove(log)
        gv.tr.reduce = reduce
    info = result["_info"]
    first = prepared.mix.warmup
    window = slice(first, first + info["rounds_window"])
    result["stages"] = summarize(resolved[window], info, gaps[0] if gaps else None,
                                 _stages(), pack_cpu_s=packs[window],
                                 collections=traced if gaps else None)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 stage_split.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from gvbench import run as gv

    bench = gv.load_bench(gv.ROOT)
    cell = gv.find(bench["workloads"], args.workload, "workload")
    prep = gv.Prepared(bench, cell, args.seed, None)
    gc.collect()
    gc.freeze()
    import torch

    if not torch.cuda.is_available():
        print("stage_split: needs a CUDA card", file=sys.stderr)
        return 3
    result = staged_run(bench, cell, args.seed, args.seconds, bool(args.trace), prep)
    result["card"] = torch.cuda.get_device_name(0)
    st = result["stages"]
    print(f"stage_split: {st['replayed_share']} of {st['rounds']} window rounds replayed, "
          f"launch {st['launch_ms']} ms a round, pack {st['mean_ms']['pack']} ms "
          f"({st['pack_cpu_ms']} ms CPU)", file=sys.stderr)
    print(json.dumps(result.pop("_info"), default=str), file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
