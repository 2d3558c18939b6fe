"""The port's depth-2 facade with every round observer attached, held
against the JAX package's (one JAX compile: ``engine_round_step`` and the
flush at one small geometry).

Both ``GrapevineEngine``s run ``pipeline_depth=2`` and ``evict_every=2``
with a leak monitor (``EngineLeakMonitor.for_engine``) and the serving
layers' ``attach_round_observability`` (round tracer, enforced SLO,
workload and cost telemetry); the port is fed the reference's random
draws round by round (as ``test_torch_pipeline_jax.py`` does). Over the
same multi-round calls:

- the streams the two leak monitors receive are equal round for round:
  the batch's key columns, the public transcript (tolerance 0), the real
  op count and the batch size;
- after both monitors drain, their verdicts (every detector's statistic,
  threshold and sample count, the flush-cadence detector included), their
  windowed stats and their flight recorder dumps (but for the monotonic
  stamp and the phase seconds, which are wall-clock times) are equal;
- both tracers hold the same rounds with the same span names, the port's
  five facade stages a round besides (``obs/tracer.py:STAGE_SPANS``), and both
  registries export the same metric families, the leak monitor's, the
  cost, load, SLO and trace families included; ``chip_smoke.py``'s
  ``OBS_FAMILIES`` (what phase 13 requires on ``/metrics``) is exactly
  the families the reference's ``attach_round_observability`` registers.
"""

import importlib.util
from collections import deque
from pathlib import Path

import numpy as np

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.batcher import GrapevineEngine as JEngine
from grapevine_tpu.obs import attach_round_observability as jax_attach
from grapevine_tpu.obs.exporter import render_prometheus as jax_render
from grapevine_tpu.obs.leakmon import EngineLeakMonitor as JLeakMon
from grapevine_tpu.obs.leakmon import LeakMonitorConfig as JLeakCfg
from grapevine_tpu.obs.slo import SloConfig as JSlo
from grapevine_tpu.wire.records import QueryRequest as JReq, RequestRecord as JRec
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine import batcher
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.engine.convert import from_jax_state
from grapevine_tpu_torch.engine.round_step import RoundDraws
from grapevine_tpu_torch.obs import SloConfig, attach_round_observability, parse_exposition
from grapevine_tpu_torch.obs.exporter import render_prometheus
from grapevine_tpu_torch.obs.leakmon import EngineLeakMonitor, LeakMonitorConfig
from grapevine_tpu_torch.obs.tracer import STAGE_SPANS
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from test_torch_engine import jax_draws, jax_leaves
from test_torch_pipeline_jax import NOW, _plan, _reqs
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

PAIR = dict(max_messages=64, max_recipients=16, mailbox_cap=8, batch_size=4,
            stash_size=64, vphases_impl="dense", pipeline_depth=2, evict_every=2)


def _record(mon, into: list) -> None:
    """Keep a copy of every round the monitor is handed."""
    submit = mon.submit_round

    def recording(batch, transcript, n_real, batch_size, phases=None, queue_depth=None):
        into.append(({k: np.array(v) for k, v in batch.items()},
                     np.asarray(transcript).astype(np.uint32), n_real, batch_size,
                     set(phases or ())))
        return submit(batch, transcript, n_real, batch_size, phases,
                      queue_depth=queue_depth)

    mon.submit_round = recording


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dump(mon) -> list:
    return [{k: v for k, v in r.items() if k not in ("t_mono_s", "phase_s")}
            for r in mon.recorder.dump()["rounds"]]


def test_observed_depth2_facade_matches_reference(monkeypatch):
    import random

    jeng = JEngine(JConfig(**PAIR), seed=41)
    teng = GrapevineEngine(GrapevineConfig(**PAIR), seed=41, device="cpu")
    teng.state = from_jax_state(teng.ecfg, jax_leaves(jeng.state), seed=41,
                                device=teng.device)
    b = teng.ecfg.batch_size

    jlm = JLeakMon.for_engine(jeng, JLeakCfg(window_rounds=64, min_pooled_leaves=64))
    tlm = EngineLeakMonitor.for_engine(teng, LeakMonitorConfig(window_rounds=64,
                                                               min_pooled_leaves=64))
    jeng.attach_leakmon(jlm)
    teng.attach_leakmon(tlm)
    jtr, jslo, _ = jax_attach(jeng, jeng.metrics.registry, trace_ring_size=64,
                              slo=JSlo(commit_p99_ms=60_000.0))
    ttr, tslo, _ = attach_round_observability(teng, teng.metrics.registry,
                                              trace_ring_size=64,
                                              slo=SloConfig(commit_p99_ms=60_000.0))
    jstream, tstream = [], []
    _record(jlm, jstream)
    _record(tlm, tstream)

    rngs: deque = deque()
    jstep = jeng._step

    def recording_step(ecfg, state, batch):
        rngs.append(np.asarray(state.rng))
        return jstep(ecfg, state, batch)

    jeng._step = recording_step
    tstep = batcher.engine_round_step

    def fed_step(ecfg, state, dev_batch, fast_ok=None):
        draws = RoundDraws(*(from_numpy(x, "cpu")
                             for x in jax_draws(jeng.ecfg, rngs.popleft(), b)))
        return tstep(ecfg, state, dev_batch, draws=draws, fast_ok=fast_ok)

    monkeypatch.setattr(batcher, "engine_round_step", fed_step)
    rng = random.Random(8)
    created: list = []
    try:
        for call in range(8):
            ops = _plan(rng, call, created)
            jr = jeng.handle_queries(_reqs(JReq, JRec, ops), NOW + call)
            tr = teng.handle_queries(_reqs(QueryRequest, RequestRecord, ops), NOW + call)
            assert [r.pack() for r in tr] == [r.pack() for r in jr], f"call {call}"
            for (t, a, r, _m, _p), resp in zip(ops, jr):
                if t == C.REQUEST_TYPE_CREATE and resp.status_code == C.STATUS_CODE_SUCCESS:
                    created.append((resp.record.msg_id, a, r))
        assert jlm.flush() and tlm.flush()
        assert not rngs and len(tstream) == len(jstream) == 24
        for k, (t, j) in enumerate(zip(tstream, jstream)):
            assert t[0].keys() == j[0].keys(), k
            for col in t[0]:
                assert np.array_equal(t[0][col], j[0][col]), (k, col)
            assert t[1].shape == j[1].shape == (b, 2 * teng.ecfg.mb_choices + 1)
            assert np.array_equal(t[1], j[1]), f"round {k}: transcripts differ"
            assert t[2:] == j[2:], k
        tv, jv = tlm.verdict(), jlm.verdict()
        assert tv == jv
        assert tv["verdict"] == "PASS" and tv["rounds_observed"] == 24
        assert {d["name"] for d in tv["detectors"]} >= {"flush_cadence", "uniformity"}
        assert next(d for d in tv["detectors"] if d["name"] == "flush_cadence")["samples"] == 12
        for s in tlm.monitor.streams:
            assert tlm.monitor.stats(s) == jlm.monitor.stats(s)
        assert _dump(tlm) == _dump(jlm)
        tt, jt = ttr.chrome_trace(), jtr.chrome_trace()
        assert tt["otherData"]["rounds_recorded_total"] == \
            jt["otherData"]["rounds_recorded_total"] == 24
        # the reference's span names, and the port's five stages a round
        assert sorted(e["name"] for e in tt["traceEvents"]) == \
            sorted([e["name"] for e in jt["traceEvents"]]
                   + [f"grapevine/{s}" for s in STAGE_SPANS] * 24)
        assert tslo.verdict()["ok"] and jslo.verdict()["ok"]
        tfam = set(parse_exposition(render_prometheus(teng.metrics.registry)))
        jfam = set(parse_exposition(jax_render(jeng.metrics.registry)))
        assert tfam == jfam
        assert {"grapevine_leakmon_rounds_total", "grapevine_cost_roofline_residual",
                "grapevine_load_batch_fill", "grapevine_slo_commit_latency_seconds",
                "grapevine_trace_rounds_total", "grapevine_round_bubble_ratio"} <= tfam
        # chip_smoke.py phase 13 requires exactly these families on /metrics
        attached = {f for f in jfam if f.startswith(("grapevine_cost_", "grapevine_load_",
                                                     "grapevine_slo_", "grapevine_trace_"))}
        assert set(_chip_smoke().OBS_FAMILIES) == attached | {"grapevine_round_bubble_ratio"}
    finally:
        tlm.close()
        jlm.close()
