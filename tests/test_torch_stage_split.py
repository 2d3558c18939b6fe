"""``stage_split.py``'s reading of round ledgers, on synthetic ledgers: the
window's means a round and their sums against the benchmark's own
``facade.dispatch_ms`` clock, a ledger without stages (a program before
them) reading as none, and a round's stages as the host intervals the
traced idle gaps are named after. The tool's run of a cell is a card job
(the card tests in ``tests/test_torch_obs.py`` cover the device span)."""

import stage_split
from grapevine_tpu_torch.obs.tracer import STAGE_PARENTS, STAGE_SPANS
from _torch_threads import one_torch_thread  # noqa: F401

#: one round's stage durations (ms): pack before the dispatch, the other
#: four back to back inside it
STAGE_MS = {"pack": 12.0, "upload": 0.9, "admit": 0.1, "launch": 60.0, "download": 0.4}


def _ledger(t0: float, stages: bool = True) -> dict:
    """A direct-path round's ledger starting at ``t0`` seconds: pack, then
    a dispatch of the four other stages and 0.1 ms of its own, the wait,
    the unpack, and the windows over them."""
    ms = 1e-3
    spans, t = {}, t0
    if stages:
        spans["pack"] = (t, STAGE_MS["pack"] * ms)
    t += STAGE_MS["pack"] * ms
    d0 = t
    for name in STAGE_SPANS[1:]:
        if stages:
            spans[name] = (t, STAGE_MS[name] * ms)
        t += STAGE_MS[name] * ms
    t += 0.1 * ms
    spans["dispatch"] = (d0, t - d0)
    spans["evict"] = (t + 5 * ms, 0.3 * ms)
    spans["demux"] = (t + 5.3 * ms, 10 * ms)
    spans["device"] = (d0, t + 5.3 * ms - d0)
    r0 = t0 if stages else d0
    spans["round"] = (r0, t + 15.3 * ms - r0)
    return spans


INFO = {"window_round_s": 0.087, "dispatch_s_mean": 0.0736}


def test_the_stages_split_the_window_dispatch():
    assert STAGE_SPANS[0] == "pack" and STAGE_PARENTS["pack"] == "round"
    rounds = [(_ledger(0.1 * i), 0.084, True) for i in range(5)]
    st = stage_split.summarize(rounds, INFO, None, STAGE_SPANS)
    assert st["rounds"] == 5
    assert st["replayed_share"] == 1.0 and abs(st["launch_ms"] - 60.0) < 1e-9
    for name, ms in STAGE_MS.items():
        assert abs(st["mean_ms"][name] - ms) < 1e-9
    assert abs(st["mean_ms"]["dispatch"] - 61.5) < 1e-9
    assert abs(st["device_span_ms"] - 84.0) < 1e-9
    assert abs(st["window_round_ms"] - 87.0) < 1e-9
    # pack + the ledger's dispatch against the benchmark's clock around the
    # call, and the four dispatch stages against the dispatch span
    assert abs(st["pack_plus_dispatch_ms"] - 73.5) < 1e-9
    assert abs(st["pack_plus_dispatch_over_facade"] - 73.5 / 73.6) < 1e-9
    assert abs(st["stages_over_dispatch_span"] - 61.4 / 61.5) < 1e-9
    assert "idle_gaps_s" not in st


def test_a_program_without_stages_reads_none():
    rounds = [(_ledger(0.1 * i, stages=False), None, False) for i in range(3)]
    st = stage_split.summarize(rounds, INFO, None, STAGE_SPANS)
    assert st["rounds"] == 3
    assert all(st["mean_ms"][name] is None for name in STAGE_SPANS)
    assert st["replayed_share"] == 0.0 and st["launch_ms"] is None
    assert st["mean_ms"]["dispatch"] > 0.0 and st["device_span_ms"] is None
    assert "pack_plus_dispatch_ms" not in st
    # a window where one round lacks its device span has no mean of it
    mixed = [(_ledger(0.0), 0.08, False), (_ledger(0.1), None, True)]
    st = stage_split.summarize(mixed, INFO, None, STAGE_SPANS)
    assert st["device_span_ms"] is None and st["replayed_share"] == 0.5


def test_traced_idle_gaps_are_named_by_stage():
    """Each stage becomes one host interval labelled
    ``facade.dispatch.<stage>`` (those of rounds before the traced stretch
    left out), each inside the dispatch call's; the summary puts the
    dispatch call's idle time down to the stages and the unstaged rest."""
    ledgers = [_ledger(0.1 * i) for i in range(3)]
    host = [iv for spans in ledgers
            for iv in stage_split.stage_intervals(spans, STAGE_SPANS, after=0.09)]
    labels = [lab for _a, _b, lab in host]
    assert labels == [f"facade.dispatch.{s}" for s in STAGE_SPANS] * 2
    for spans in ledgers[1:]:
        a, d = spans["dispatch"]
        ivs = stage_split.stage_intervals(spans, STAGE_SPANS)
        assert ivs[0][0] < a and all(a <= s and e <= a + d + 1e-12 for s, e, _ in ivs[1:])
    assert stage_split.stage_intervals(_ledger(0.0, stages=False), STAGE_SPANS) == []
    gaps = {"facade.dispatch.launch": 0.12, "facade.dispatch.pack": 0.02,
            "facade.dispatch": 0.001, "facade.resolve.demux": 0.02}
    st = stage_split.summarize([(ledgers[0], 0.08, True)], INFO, gaps, STAGE_SPANS)
    assert list(st["idle_gaps_s"]) == ["facade.dispatch.launch", "facade.dispatch.pack",
                                       "facade.resolve.demux", "facade.dispatch"]
    assert abs(st["dispatch_idle_s"] - 0.141) < 1e-12
    assert abs(st["dispatch_unstaged_share"] - 0.001 / 0.141) < 1e-12


def test_pack_cpu_and_the_traced_collections():
    """The window's thread CPU ms a round of ``pack`` (None unless every
    round has one), and the collections of the traced stretch: as host
    intervals ``gc.gen<N>`` (those outside the stretch left out), and in
    the summary by generation and ms."""
    rounds = [(_ledger(0.1 * i), 0.08, True) for i in range(4)]
    st = stage_split.summarize(rounds, INFO, None, STAGE_SPANS,
                               pack_cpu_s=[0.010, 0.011, 0.012, 0.013])
    assert abs(st["pack_cpu_ms"] - 11.5) < 1e-9
    assert "traced_collections" not in st
    assert stage_split.summarize(rounds, INFO, None, STAGE_SPANS,
                                 pack_cpu_s=[0.01])["pack_cpu_ms"] is None
    log = stage_split.GcLog()
    for t, gen in ((1.0, 0), (2.0, 2), (3.5, 1)):
        log.seen.append((t, t + 0.004 * (gen + 1), gen))
    ivs = stage_split.collection_intervals(log.seen, 1.5, 3.0)
    assert ivs == [(2.0, 2.012, "gc.gen2")]
    st = stage_split.summarize(rounds, INFO, {"gc.gen2": 0.01}, STAGE_SPANS,
                               collections=ivs)
    assert len(st["traced_collections"]) == 1
    assert st["traced_collections"][0]["generation"] == 2
    assert abs(st["traced_collections"][0]["ms"] - 12.0) < 1e-9
    # the callback logs a collection's start, end and generation
    import gc

    gc.callbacks.append(log)
    try:
        gc.collect(1)
    finally:
        gc.callbacks.remove(log)
    a, b, gen = log.seen[-1]
    assert gen == 1 and b >= a
