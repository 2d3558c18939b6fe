"""The device trace of a few steady rounds and its reduction: device busy
time, the traced window, kernel time by name, and the device's idle gaps
labelled by what the host was doing.

``torch.profiler`` records, on the card alone, every kernel, copy and set
the rounds launch while it is on, and the CUDA runtime calls that launched
them; it records no host operations, which would slow the host that paces
these rounds several times over. The host's side comes from the benchmark's
own clock: the intervals of its calls into the facade and the facade's own
span ledger of each round (``PendingRound.spans``: the wait for the round's
event and the unpacking of its answers). Two marker calls
(``cudaStreamQuery``, which nothing else in a round makes) tie that clock
to the trace's. The reduction reads the profiler's own export (a Chrome
trace, written to the run's temporary directory and removed once read).
The window runs from the first device operation's start to the last one's
end, so a round that was already running when the capture began, and whose
launches went unrecorded, does not show as idle time.
"""

from __future__ import annotations

import bisect
import json
import os
import re
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "cudaStreamQuery"


def capture():
    """A started profiler over the card's activity."""
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def mark(marks: list) -> None:
    """One marker call, its host time (seconds, ``perf_counter``) appended."""
    import torch

    a = time.perf_counter()
    torch.cuda.current_stream().query()
    marks.append(0.5 * (a + time.perf_counter()))


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.remove(path)


def short_name(name: str) -> str:
    """A kernel's name without its argument list or return type."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


def _offset(ev: list, marks: list):
    """Trace microseconds minus host microseconds, from the marker calls;
    None where the trace lacks them."""
    hits = sorted(float(e["ts"]) for e in ev if e.get("name") == MARKER)
    if len(hits) != len(marks) or not marks:
        return None
    return sorted(h - 1e6 * m for h, m in zip(hits, marks))[len(marks) // 2]


def reduce(prof, host: list, marks: list) -> dict:
    """{"kernels": {name: [count, seconds]}, "kernel_count", "busy_s",
    "window_s", "gaps": {host label: idle seconds}}. ``host`` holds
    ``(start_s, end_s, label)`` on the ``perf_counter`` clock."""
    ev = _events(prof)
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e)
                 for e in ev if e.get("cat") in DEVICE_CATS)
    if not dev:
        return {"kernels": {}, "kernel_count": 0, "busy_s": 0.0, "window_s": 0.0, "gaps": {}}
    kernels: dict = {}
    for _s, _e, e in dev:
        if e.get("cat") == "kernel":
            k = kernels.setdefault(e.get("name", "?"), [0, 0.0])
            k[0] += 1
            k[1] += float(e.get("dur", 0.0)) * 1e-6
    merged = []
    for s, t, _e in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)
    off = _offset(ev, marks)
    spans = sorted((1e6 * a, 1e6 * b, lab) for a, b, lab in host)
    starts = [s[0] for s in spans]
    gaps: dict = {}
    for (_s0, t0), (s1, _t1) in zip(merged, merged[1:]):
        lab = "host clock not tied to the trace"
        if off is not None:
            p = t0 - off
            i = bisect.bisect_right(starts, p) - 1
            lab = "bench.loop"
            while i >= 0 and spans[i][1] >= p - 1e6:
                if spans[i][0] <= p <= spans[i][1]:
                    lab = spans[i][2]
                    break
                i -= 1
        gaps[lab] = gaps.get(lab, 0.0) + (s1 - t0) * 1e-6
    return {
        "kernels": kernels,
        "kernel_count": sum(c for c, _ in kernels.values()),
        "busy_s": busy * 1e-6,
        "window_s": (merged[-1][1] - merged[0][0]) * 1e-6,
        "gaps": gaps,
        "tied": off is not None,
    }


def breakdown(summary: dict, top: int = 10) -> dict:
    """The device operations that took most time and the idle time by what
    the host was doing, ``top`` of each."""
    ops: dict = {}
    for name, (_c, s) in summary["kernels"].items():
        key = short_name(name)
        ops[key] = ops.get(key, 0.0) + s
    by_time = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k[:160], v] for k, v in by_time],
            "idle_gaps": [[k[:160], v] for k, v in gaps]}


def kernel_seconds(summary: dict, patterns: list) -> tuple[int, float]:
    """(launches, seconds) of the kernels whose name matches any of
    ``patterns`` (regular expressions, searched)."""
    rx = [re.compile(p) for p in patterns]
    n, s = 0, 0.0
    for name, (c, t) in summary["kernels"].items():
        if any(r.search(name) for r in rx):
            n += c
            s += t
    return n, s
