"""The port's chaos harness held against the JAX package's
``tools/chaos_run.py`` (the reference's compiles at the harness's
64-message geometry: the engine round and sweep at E=1, and at E=4 the
round and the flush).

- ``build_schedule`` gives the same event list in both harnesses (kinds,
  clocks and every request's wire bytes), and ``_events_done`` the same
  durable-seq to event mapping.
- The port's uninterrupted schedule (its ``oracle``, on the CPU) runs from
  the reference oracle's initial state, carried across, and is fed the
  reference's random draws round by round (as
  ``test_torch_pipeline_jax.py`` does), at ``evict_every`` 1 and 4. Every
  per-event response hash equals ``tools/chaos_run.py:oracle(11, 18)``'s,
  at tolerance 0. The
  final state equals the reference oracle's final state on every leaf that
  ``state_to_bytes`` writes, in the same order (no fused scatter runs, so
  nothing is masked); the whole payload's hash cannot be equal, because
  its manifest carries each package's own config fingerprint and its last
  leaf is each package's generator state.
"""

import hashlib
import importlib.util
import os
from collections import deque

import numpy as np
import pytest

from grapevine_tpu_torch.engine import batcher as tbatcher
from grapevine_tpu_torch.engine import checkpoint as tcp
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.round_step import RoundDraws
from grapevine_tpu_torch.testing import chaos_run as port
from grapevine_tpu_torch.u32 import from_numpy
from test_torch_checkpoint import _split
from test_torch_engine import jax_draws, jax_leaves
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference():
    """``tools/chaos_run.py`` loaded by path under a name of its own."""
    spec = importlib.util.spec_from_file_location(
        "reference_chaos_run", os.path.join(REPO, "tools", "chaos_run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref():
    return _reference()


@pytest.mark.parametrize("seed,n_events", [(11, 18), (11, 24), (52, 16), (99, 18)])
def test_schedule_equals_the_reference(ref, seed, n_events):
    want = ref.build_schedule(seed, n_events)
    got = port.build_schedule(seed, n_events)
    assert [e[:2] for e in got] == [e[:2] for e in want]
    for g, w in zip(got, want):
        if g[0] == "round":
            assert [r.pack() for r in g[2]] == [r.pack() for r in w[2]]
        else:
            assert g[2] == w[2]


@pytest.mark.parametrize("evict_every", [1, 2, 4])
def test_events_done_equals_the_reference(ref, evict_every):
    events = port.build_schedule(11, 24)
    for seq in range(0, 40):
        try:
            want = ref._events_done(events, seq, evict_every)
        except RuntimeError:
            with pytest.raises(RuntimeError):
                port._events_done(events, seq, evict_every)
            continue
        assert port._events_done(events, seq, evict_every) == want


@pytest.mark.parametrize("evict_every", [1, 4])
def test_oracle_equals_the_reference_oracle(ref, monkeypatch, evict_every):
    import grapevine_tpu.engine.batcher as jbatcher
    from grapevine_tpu.engine import checkpoint as jcp

    seen: dict = {}
    rngs: deque = deque()

    class RecordingEngine(jbatcher.GrapevineEngine):
        """The reference engine, recording each round's draws' key."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen["jax"] = self
            seen["init"] = jax_leaves(self.state)
            step = self._step

            def recording_step(ecfg, state, batch):
                rngs.append(np.asarray(state.rng))
                return step(ecfg, state, batch)

            self._step = recording_step

    monkeypatch.setattr(jbatcher, "GrapevineEngine", RecordingEngine)
    want_hashes, want_final = ref.oracle(11, 18, evict_every=evict_every)
    jeng = seen["jax"]
    assert hashlib.sha256(jcp.state_to_bytes(jeng.ecfg, jeng.state)).hexdigest() == want_final
    n_rounds = len(rngs)
    assert n_rounds == sum(1 for h in want_hashes.values() if h != "sweep") == 16

    real_step = tbatcher.engine_round_step
    b = jeng.ecfg.batch_size

    def fed_step(ecfg, state, dev_batch, fast_ok=None):
        draws = RoundDraws(*(from_numpy(x, "cpu")
                             for x in jax_draws(jeng.ecfg, rngs.popleft(), b)))
        return real_step(ecfg, state, dev_batch, draws=draws, fast_ok=fast_ok)

    class CarriedEngine(tbatcher.GrapevineEngine):
        """The port's engine, started from the reference's initial state."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.state = from_jax_state(self.ecfg, seen["init"], seed=port.ENGINE_SEED,
                                        device=self.device)
            seen["port"] = self

    monkeypatch.setattr(tbatcher, "engine_round_step", fed_step)
    monkeypatch.setattr(tbatcher, "GrapevineEngine", CarriedEngine)
    stats: dict = {}
    got_hashes, got_final = port.oracle(11, 18, evict_every=evict_every, device="cpu",
                                        stats=stats, masked=True)
    assert not rngs, "every reference round's draws fed to exactly one port round"
    assert got_hashes == want_hashes
    teng = seen["port"]
    assert got_final == hashlib.sha256(tcp.state_to_bytes(teng.ecfg, teng.state)).hexdigest()
    diff = first_difference(to_numpy(teng.state), jax_leaves(jeng.state), mask_junk=False)
    assert diff is None, f"final state differs at {diff}"
    tman, tl = _split(tcp.state_to_bytes(teng.ecfg, teng.state))
    jman, jl = _split(jcp.state_to_bytes(jeng.ecfg, jeng.state))
    assert tman["leaves"][:-1] == jman["leaves"][:-1]
    assert tl[:-1] == jl[:-1]
    assert stats["wall_s"] > 0 and len(stats["finalx"]) == 64
    assert teng.flushes == (16 // evict_every if evict_every > 1 else 0)
