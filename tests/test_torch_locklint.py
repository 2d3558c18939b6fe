"""The port's lock-discipline lint (``grapevine_tpu_torch/analysis/
locklint.py``, a copy of the reference's pointed at the port's host
path): on the same seeded sources as the reference's tests its findings
equal the reference lint's, and the port's own tree is clean."""

from __future__ import annotations

import pytest

from grapevine_tpu.analysis import locklint as ref
from grapevine_tpu_torch.analysis import locklint as port
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

_FAKE_OK = '''
import threading

def pack_batch(reqs): return reqs
def validate_request(r): pass

class BatchJournal:
    def append_round(self, b, n): pass

class GrapevineEngine:
    def __init__(self):
        self._lock = threading.Lock()
        self.state = 0
        self.durability = None

    def _assemble_round(self, reqs):
        for r in reqs: validate_request(r)
        return pack_batch(reqs)

    def _journal_round(self, batch):
        if self.durability: self.durability.append_round(batch, 1)

    def _dispatch_round(self, batch):
        self.state = self.state + 1
        return batch

    def handle_queries_async(self, reqs):
        batch = self._assemble_round(reqs)
        with self._lock:
            self._journal_round(batch)
            out = self._dispatch_round(batch)
        return out
'''

_SCHED = '''
class BatchScheduler:
    def __init__(self, engine):
        self.engine = engine
        self._cv = threading.Condition()
        self._depth = 0
        self._worker = threading.Thread(target=self._run)

    def _run(self):
        self._depth = self._depth - 1

    def submit(self, req):
        self._depth = self._depth + 1
        return self._depth
'''

_PIPE = '''
class HostPipeline:
    def __init__(self):
        self._lock = threading.Lock()
        self._inflight = 0

    def _start(self):
        self._reader = threading.Thread(target=self._read_loop)

    def _read_loop(self):
        self._inflight = self._inflight - 1

    def submit(self, task):
        self._inflight = self._inflight + 1
        return self._inflight
'''

_HOLD = ("        with self._lock:\n            self._journal_round(batch)\n"
         "            out = self._dispatch_round(batch)\n")


def _swap(old, new, src=_FAKE_OK):
    assert old in src
    return src.replace(old, new)


SOURCES = {
    "clean": _FAKE_OK,
    "split_holds": _swap(_HOLD, "        with self._lock:\n            self._journal_round("
                         "batch)\n        with self._lock:\n            out = "
                         "self._dispatch_round(batch)\n"),
    "stage1_under_lock": _swap(
        "        batch = self._assemble_round(reqs)\n        with self._lock:",
        "        with self._lock:\n            batch = self._assemble_round(reqs)\n"
        "        with self._lock:"),
    "journal_lock": _swap(
        "class BatchJournal:\n    def append_round(self, b, n): pass",
        "class BatchJournal:\n    def __init__(self):\n        self._jlock = "
        "threading.Lock()\n    def append_round(self, b, n):\n        with self._jlock: pass"),
    "nested_stage_lock": _swap(
        "    def _dispatch_round(self, batch):\n        self.state = self.state + 1",
        "    def _dispatch_round(self, batch):\n        with self._side:\n"
        "            self.state = self.state + 1",
        _swap("        self._lock = threading.Lock()\n",
              "        self._lock = threading.Lock()\n        self._side = threading.Lock()\n")),
    "shared_attr": _FAKE_OK + _SCHED,
    "hostpipe_handoff": _FAKE_OK + _PIPE,
    "missing_code": "x = 1\n",
}


def _findings(lint, src, allow=()):
    return sorted((v.kind, v.where) for v in lint.lint_sources({"fake.py": src}, allow=allow))


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_findings_equal_the_reference_lints(case):
    got = _findings(port, SOURCES[case])
    assert got == _findings(ref, SOURCES[case])
    assert bool(got) == (case != "clean")


def test_dead_and_reads_only_allow_entries_as_the_reference():
    for lint in (ref, port):
        dead = _findings(lint, _FAKE_OK, allow=(lint.LockAllow("GrapevineEngine", "ghost",
                                                               "gone"),))
        assert ("dead-allow", "GrapevineEngine.ghost") in dead
    poke = _FAKE_OK.replace(
        "    def handle_queries_async(self, reqs):",
        "    def poke(self):\n        self.state = self.state + 1\n\n"
        "    def handle_queries_async(self, reqs):")
    got = [_findings(lint, poke, (lint.LockAllow("GrapevineEngine", "state", "r",
                                                 reads_only=True),))
           for lint in (ref, port)]
    assert got[0] == got[1] and ("shared-attr", "GrapevineEngine.state") in got[0]


def test_the_ports_host_path_is_clean():
    assert port.lint_repo() == []
    assert set(port.repo_sources()) == {"engine/batcher.py", "server/scheduler.py",
                                        "engine/journal.py", "server/hostpipe.py"}


def test_the_admission_bound_takes_no_lock_under_the_engine_lock():
    """The dispatch stage runs inside the engine lock's hold, so it may
    take no lock of its own; a resolving thread hands its exact bound over
    through a deque instead (the port's one locklint finding, repaired)."""
    src = port.repo_sources()["engine/batcher.py"]
    assert "self._bound_lock" not in src
    bad = src.replace("        self._dispatched += 1\n",
                      "        with self._lock:\n            self._dispatched += 1\n", 1)
    assert bad != src
    vs = port.lint_sources({**port.repo_sources(), "engine/batcher.py": bad})
    assert any(v.kind == "same-hold" and v.where == "GrapevineEngine._dispatch_round"
               for v in vs), vs
