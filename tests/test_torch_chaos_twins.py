"""The port's crash-recovery chaos harness on the CPU, small enough for
every run (``grapevine_tpu_torch/testing/chaos_run.py``; the six
campaigns and the live flip drill are ``-m slow`` in
``test_torch_chaos_recovery.py``).

- At ``--events 8`` (the reference harness's 64-message geometry, E=1),
  one trial killed at ``journal.append.torn`` and one at
  ``round.post_dispatch``, against one shared uninterrupted oracle: each
  child is SIGKILLed at the armed site, restarted, and the run's every
  recorded response hash, its final ``state_to_bytes`` hash and the leak
  monitor's PASS must hold.
- At ``--evict-every 2``, one trial killed at ``flush.pre_dispatch``: the
  flush frame is durable but the flush never ran; the restart completes it.
- The harness's pure parts: the schedule is a pure function of its seed,
  the durable-seq to event mapping raises off an event boundary, a torn
  progress line is skipped, and the kill plans are drawn in trial order.
"""

import random

import pytest

from grapevine_tpu_torch.testing import chaos_run as chaos
from grapevine_tpu_torch.testing.faults import ALL_POINTS
from _torch_threads import one_torch_thread  # noqa: F401

E1_ARGS = ["--device", "cpu", "--events", "8", "--seed", "5"]


@pytest.fixture(scope="module")
def e1_oracle():
    return chaos.run_oracle(chaos.parse_args(E1_ARGS))


def _one_trial(argv, mode, orc=None):
    args = chaos.parse_args(argv)
    reports: list = []
    failures = chaos.run_trials(0, args, modes=[mode], reports=reports, orc=orc)
    assert not failures, "\n".join(failures)
    oracle_rep, rep = reports
    assert rep["mode"] == mode and rep["kills"] >= 1, rep
    incs = rep["incarnations"]
    # the killed incarnation reached ready, the last one ran to the end
    assert len(incs) >= 2 and "start_event" in incs[-1], incs
    assert incs[-1]["replayed"] >= 1, incs
    assert rep["matched"] == rep["recorded"] > 0
    return rep


@pytest.mark.parametrize("mode", ["journal.append.torn", "round.post_dispatch"])
def test_kill_restart_recovers_bit_identical(e1_oracle, mode):
    _one_trial(E1_ARGS, mode, orc=e1_oracle)


def test_kill_at_flush_pre_dispatch_completes_the_flush():
    rep = _one_trial(["--device", "cpu", "--events", "8", "--evict-every", "2",
                      "--seed", "7"], "flush.pre_dispatch")
    # the restart replays the durable flush frame the killed child never ran
    assert rep["incarnations"][1]["replayed"] >= 3


def test_schedule_is_a_pure_function_of_its_seed():
    a = chaos.build_schedule(11, 18)
    b = chaos.build_schedule(11, 18)
    assert [(k, t) for k, t, _ in a] == [(k, t) for k, t, _ in b]
    assert [[r.pack() for r in x] for k, _, x in a if k == "round"] == \
        [[r.pack() for r in x] for k, _, x in b if k == "round"]
    assert [i for i, (k, *_) in enumerate(a) if k == "sweep"] == [5, 12]
    assert all(1 <= len(x) <= 4 for k, _, x in a if k == "round")
    wide = chaos.build_schedule(11, 8, reqs=(256, 300), users=1024)
    assert all(256 <= len(x) <= 300 for k, _, x in wide if k == "round")
    assert len({r.auth_identity for k, _, x in wide if k == "round" for r in x}) > 255


@pytest.mark.parametrize("evict_every", [1, 2, 4])
def test_events_done_walks_flush_frames_and_refuses_torn_boundaries(evict_every):
    events = chaos.build_schedule(11, 18)
    seq, rounds, seen = 0, 0, {0: 0}
    for n, ev in enumerate(events):
        seq += 1
        if ev[0] == "round":
            rounds += 1
            if evict_every > 1 and rounds % evict_every == 0:
                # the window's round is durable, its flush frame is not
                with pytest.raises(RuntimeError, match="event boundary"):
                    chaos._events_done(events, seq, evict_every)
                seq += 1
        seen[seq] = n + 1
    for s, n in seen.items():
        assert chaos._events_done(events, s, evict_every) == n


def test_progress_parsing_skips_torn_lines(tmp_path):
    p = tmp_path / "progress.log"
    p.write_text("startup 1.5\nrecovery 0.25\nreplayed 0\nready 1\nstart 0\n"
                 "1 aa\n2 sweep\n3 b\nstartup 2.0\nrecovery 0.5\nreplayed 2\nready 1\n"
                 "start 2\n3 cc\nleakmon PASS\nfinalx ee\nfinal ff\n")
    hashes, finals, leak = chaos._parse_progress(str(p))
    assert hashes == {1: "aa", 2: "sweep", 3: "cc"}
    assert finals == ["ff"] and leak == ["PASS"]
    incs = chaos._parse_incarnations(str(p))
    assert [(i["startup_s"], i["replayed"], i["start_event"], i["recorded"]) for i in incs] \
        == [(1.5, 0, 0, 3), (2.0, 2, 2, 1)]
    assert incs[1]["finalx"] == "ee" and "finalx" not in incs[0]


def test_kill_plans_scale_the_trigger_to_each_site():
    args = chaos.parse_args(["--device", "cpu", "--events", "16", "--evict-every", "4"])
    rng = random.Random(3)
    plans = [chaos._plan_kill(m, rng, args) for m in ALL_POINTS + ("timer",)]
    ref = random.Random(3)
    for m, plan in zip(ALL_POINTS, plans):
        cap = 3 if m.startswith("checkpoint.") else 4 if m.startswith("flush.") else 8
        assert plan == ("fault", f"{m}={ref.randrange(1, cap)}")
    assert plans[-1][0] == "timer" and plans[-1][1] == ref.uniform(0.0, 1.0)
