"""The trace reduction on a made-up profiler export: busy time, the window,
kernel time by name, idle gaps labelled through the marker calls, and the
per-layer readers that read them."""

import json

import pytest

from gvbench import run, trace


class FakeProfile:
    def __init__(self, events):
        self.events = events

    def export_chrome_trace(self, path):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


def X(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


GATHER = "void (anonymous namespace)::gather_tiled_kernel(unsigned int const*, int)"
SCATTER = "void (anonymous namespace)::ring_kernel<256, 8, 0>(RingArgs, long, int, int, int)"
GLUE = "void at::native::(anonymous namespace)::index_put_kernel<int>(at::TensorIterator&)"


def summary():
    # trace clock = host clock (s) * 1e6 + 500 us
    ev = [
        X("cuda_runtime", "cudaStreamQuery", 1_000_500.0, 1.0),
        X("kernel", GATHER, 1_000_600.0, 100.0),      # busy 600-700
        X("gpu_memcpy", "Memcpy DtoH", 1_000_650.0, 100.0),  # overlaps: 650-750
        X("kernel", GLUE, 1_001_000.0, 200.0),        # gap 750-1000, busy 1000-1200
        X("kernel", SCATTER, 1_001_500.0, 50.0),      # gap 1200-1500
        X("cuda_runtime", "cudaStreamQuery", 1_002_500.0, 1.0),
        {"ph": "i", "name": "instant", "ts": 0},
    ]
    host = [(1.0002, 1.0006, "facade.dispatch"), (1.00065, 1.0009, "facade.resolve.demux")]
    return trace.reduce(FakeProfile(ev), host, [1.0, 1.002])


def test_a_gap_outside_every_interval_is_the_loop():
    ev = [X("cuda_runtime", "cudaStreamQuery", 100.0, 1.0), X("kernel", GLUE, 200.0, 10.0),
          X("kernel", GLUE, 300.0, 10.0), X("cuda_runtime", "cudaStreamQuery", 400.0, 1.0)]
    s = trace.reduce(FakeProfile(ev), [(0.00015, 0.00025, "facade.dispatch")], [0.0, 0.0003])
    assert s["gaps"] == {"bench.loop": pytest.approx(90e-6)}


def test_reduce():
    s = summary()
    assert s["tied"] is True
    assert s["busy_s"] == pytest.approx(400e-6)
    assert s["window_s"] == pytest.approx(950e-6)
    assert s["kernel_count"] == 3
    assert s["kernels"][GLUE] == [1, pytest.approx(200e-6)]
    # the gap from 1,000,750 us on the trace clock starts at 1.00025 s on the
    # host's, in the dispatch; the one from 1,001,200 at 1.0007 s, in the demux
    assert s["gaps"] == {"facade.dispatch": pytest.approx(250e-6),
                         "facade.resolve.demux": pytest.approx(300e-6)}
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["at::native::index_put_kernel<int>", pytest.approx(200e-6)]
    assert trace.kernel_seconds(s, [r"\bring_kernel<\d+, \d+, 0>"]) == (1, pytest.approx(50e-6))


def test_untied_trace_still_reduces():
    ev = [X("kernel", GATHER, 10.0, 5.0), X("kernel", GLUE, 20.0, 5.0)]
    s = trace.reduce(FakeProfile(ev), [], [])
    assert s["tied"] is False and s["busy_s"] == pytest.approx(10e-6)
    assert list(s["gaps"]) == ["host clock not tied to the trace"]


def test_readers():
    s = summary()
    engine = json.loads((run.ROOT / "gvbench/configs/bus_1kb.json").read_text())["engine"]
    r = {"trace": s, "trace_rounds": 2, "window_rounds": 100, "window_s": 1.0,
         "dispatch_s": [0.01, 0.03], "gc_s": 0.02, "engine": engine, "record_size": 1024,
         "peak": {"hbm_bytes_per_s": 3.35e12}}
    assert run.load_reader("round.kernels")(r) == 1.5
    assert run.load_reader("round.device_ms")(r) == pytest.approx(0.175)
    assert run.load_reader("facade.dispatch_ms")(r) == pytest.approx(20.0)
    assert run.load_reader("host.gc_pause_pct")(r) == pytest.approx(2.0)
    idle = 100 * (1 - s["busy_s"] / s["window_s"])
    assert 0 < idle < 100
    assert run.load_reader("device.idle_pct")(r) == pytest.approx(idle)
    assert run.load_reader("device.idle_pct")(dict(r, window_s=1e-9)) == pytest.approx(idle)
    assert run.load_reader("path_fetch_roofline")(r) > 100  # made-up times are short
    assert run.load_reader("path_writeback_roofline")(dict(r, peak=None)) is None
    assert run.load_reader("round.kernels")(dict(r, trace=None)) is None
