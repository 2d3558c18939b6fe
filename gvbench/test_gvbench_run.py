"""A whole run of a cell on the CPU at a tiny size, with the program's plain
kernels: the plain reference agrees with the program, the result line has
its schema, the program's spans and counters reach the readers, a
recursive position map runs to a correct result and delayed eviction is
refused before the program loads, a run with the program broken underneath
comes out not correct in every cell, the control does too, nothing loads
JAX or the JAX package, and without a card the command prints no result.
The card's own case skips here."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from gvbench import control, run

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(max_messages=2**10, max_recipients=2**7, batch_size=32)
CELL = "bus_1kb.zipf_closed"
CELLS = ["bus_1kb.zipf_closed", "bus_1kb.single_client"]


def tiny_run(seed, seconds=1.0, on_engine=None, trace=False, device="cpu", cell=CELL, **over):
    bench = run.load_bench(ROOT)
    cell = run.find(bench["workloads"], cell, "workload")
    return run.run_cell(bench, cell, seed, seconds, trace, device=device,
                        engine_overrides=dict(TINY, **over), on_engine=on_engine)


@pytest.fixture(scope="module")
def sound():
    return tiny_run(2**31 + 101, seconds=2.0)


def test_the_reference_agrees_with_the_program(sound):
    assert sound["correct"] is True
    assert all(c["value"] == 0 for c in sound["checks"].values())
    info = sound["_info"]
    assert info["judged"] >= sound["attempted"] > 0
    assert info["examples"] == []


def test_result_schema(sound):
    res = dict(sound)
    res.pop("_info")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"ops_per_s", "commit_p95_ms", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and isinstance(m["unit"], str)
    assert res["metrics"]["commit_p95_ms"]["samples"] == res["attempted"]
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(res))


def test_traced_run_reports_the_host_layers():
    res = tiny_run(7, seconds=0.5, trace=True)
    assert res["correct"] is True
    # the CPU has no device trace and no device span: the device's readers
    # find nothing
    assert set(res["metrics"]) == {"facade.dispatch_ms", "host.gc_pause_pct",
                                   "facade.pack_ms", "facade.unpack_ms"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _wrap_round(eng, change):
    program = eng._round_program

    def broken():
        step = program()

        def call(ecfg, state, batch, **kw):
            return change(step, ecfg, state, batch, **kw)
        return call
    eng._round_program = broken


def unchanged_state(eng):
    def change(step, ecfg, state, batch, **kw):
        _new, resp, tr = step(ecfg, state, batch, **kw)
        return state, resp, tr
    _wrap_round(eng, change)


def half_batch(eng):
    """Half of the batch left out: the half that holds its first ops."""
    def change(step, ecfg, state, batch, **kw):
        batch = dict(batch)
        rt = batch["req_type"].clone()
        rt[:rt.shape[0] // 2] = 0
        batch["req_type"] = rt
        return step(ecfg, state, batch, **kw)
    _wrap_round(eng, change)


def altered_answer(eng):
    def change(step, ecfg, state, batch, **kw):
        new, resp, tr = step(ecfg, state, batch, **kw)
        resp = dict(resp)
        pay = resp["payload"].clone()
        pay[0, 5] ^= 1
        resp["payload"] = pay
        return new, resp, tr
    _wrap_round(eng, change)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [unchanged_state, half_batch, altered_answer],
                         ids=lambda f: f.__name__)
def test_a_broken_program_is_not_correct(fault, cell):
    res = tiny_run(2**31 + 7, seconds=0.5, on_engine=fault, cell=cell)
    assert res["correct"] is False
    assert res["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("broken", sorted(control.BROKEN))
def test_the_control_is_not_correct(broken):
    bench = run.load_bench(ROOT)
    cell = run.find(bench["workloads"], CELL, "workload")
    for seed in (1, 2, 2**31 + 3):
        r = control.control_reading(cell, bench, seed, 30, broken, TINY)
        assert r["wrong_answers"] + r["wrong_readbacks"] > 0


@pytest.mark.parametrize("cell", [w["name"] for w in run.load_bench(ROOT)["workloads"]])
def test_every_cell_has_a_control_it_fails(cell):
    """A lone client's mailbox never holds two messages, so neither the cap
    nor the order can fail there; a delete that is not kept does."""
    bench = run.load_bench(ROOT)
    cell = run.find(bench["workloads"], cell, "workload")
    for seed in (1, 2, 2**31 + 3):
        wrong = [control.control_reading(cell, bench, seed, 30, broken, TINY)
                 for broken in control.BROKEN]
        assert max(r["wrong_answers"] + r["wrong_readbacks"] for r in wrong) > 0


def test_a_single_client_run_is_correct():
    res = tiny_run(2**31 + 55, seconds=1.0, cell="bus_1kb.single_client")
    assert res["correct"] is True
    info = res["_info"]
    assert info["judged"] >= res["attempted"] > 0
    # one op a round
    assert res["metrics"]["commit_p95_ms"]["samples"] == res["attempted"] == info["rounds_window"]


def test_the_readers_get_the_programs_spans_and_counters(monkeypatch):
    """``run`` holds every window round's span ledger and device span and
    the engine's ``health()``; the span readers read them (the device span
    is the card's: nothing on the CPU)."""
    seen = []
    real = run.load_reader

    def spy(name):
        read = real(name)

        def reading(r):
            seen.append(r)
            return read(r)
        return reading

    monkeypatch.setattr(run, "load_reader", spy)
    res = tiny_run(2**31 + 77, seconds=0.5, trace=True)
    r = seen[0]
    assert len(r["spans"]) == res["_info"]["rounds_window"] > 0
    for one in r["spans"]:
        assert {"pack", "demux", "dispatch"} <= set(one["host"]) and one["device"] is None
    assert r["health"]["stash_overflow"] == 0 and "round_graph" in r["health"]
    mean = sum(one["host"]["pack"][1] for one in r["spans"]) / len(r["spans"])
    assert res["metrics"]["facade.pack_ms"]["value"] == pytest.approx(1e3 * mean)
    assert "round.device_span_ms" not in res["metrics"]
    # a device span on every round, as the card's, is read as its mean
    card = dict(r, spans=[dict(one, device=0.07 + 0.001 * (i % 2))
                          for i, one in enumerate(r["spans"])])
    n = len(card["spans"])
    assert real("round.device_span_ms")(card) == pytest.approx(
        1e3 * sum(one["device"] for one in card["spans"]) / n)
    # a program without the stage spans reads as nothing
    bare = dict(r, spans=[{"host": {}, "device": None}])
    assert real("facade.pack_ms")(bare) is None and real("facade.unpack_ms")(bare) is None


def test_a_recursive_position_map_runs_to_a_correct_result():
    res = tiny_run(2**31 + 31, seconds=1.0, posmap_impl="recursive")
    assert res["correct"] is True
    assert all(c["value"] == 0 for c in res["checks"].values())
    trees = res["_info"]["trees_bytes"]
    assert {"rec", "mb", "rec_pm", "mb_pm", "rec_leaf", "mb_leaf"} == set(trees)


def test_delayed_eviction_is_refused_before_the_program_loads():
    code = ("import sys; from gvbench import run; b = run.load_bench(run.ROOT);"
            f"c = run.find(b['workloads'], {CELL!r}, 'workload')\n"
            "try:\n    run.Prepared(b, c, 1, {'evict_every': 4})\n"
            "except ValueError as e:\n"
            "    print(e, sorted(m for m in sys.modules if m.split('.')[0] in "
            "('grapevine_tpu_torch', 'torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == "the frozen arithmetic covers evict_every=1 rounds []"


def test_nothing_loads_jax_or_the_jax_package():
    code = ("import sys; sys.path.insert(0, '.'); from gvbench import test_gvbench_run as t;"
            "r = t.tiny_run(5, seconds=0.3, trace=True); from gvbench import run;"
            "print(run.forbidden_modules(), r['correct'])")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_without_a_card_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "gvbench.run", "--workload", CELL,
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's kernels run only there")


def test_a_small_traced_run_on_the_card(card):
    res = tiny_run(11, seconds=1.0, trace=True, device="cuda",
                   max_messages=2**14, max_recipients=2**10, batch_size=256)
    assert res["correct"] is True
    assert res["device"]["busy_s"] > 0
    assert {"round.kernels", "round.device_ms", "device.idle_pct", "round.device_span_ms",
            "facade.pack_ms", "facade.unpack_ms",
            "path_fetch_roofline", "path_writeback_roofline"} <= set(res["metrics"])
