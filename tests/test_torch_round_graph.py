"""The fast-branch round graph (``grapevine_tpu_torch/engine/round_graph.py``)
and the facade's rule for when a round replays it (``engine/batcher.py``).

On the CPU, where no round replays:

- the engines that never replay (off the card, on a mesh, op-major) run
  every round op by op, and ``health()["round_graph"]`` counts them under
  their reason;
- the static round the graph captures (``round_graph.static_round``),
  stood in for the graph on a CPU engine that is let to replay, equals the
  eager engine of the same seed in every response, transcript and state
  leaf, through a warm-up round, replays, a slow-branch round, sweeps, an
  install from outside and E=2 flushes, with the state's tensors at the
  same addresses throughout;
- every write of ``state`` from outside a round goes through one setter:
  after a flush, a sweep or an install the admission branch equals
  ``admission_fast_ok`` on the exact values, and a write that replaces
  ``free_top`` makes the next round read them;
- ``copy_state_`` keeps addresses, clones a source that overlaps the
  state, copies generator states and refuses another geometry.

On the card (skipped without one): a graphed engine equals an engine that
runs every round op by op, from the same seed, bit for bit after every
round, at two geometries with two seeds each, an E=4 configuration with its
eager flushes, and a recursive position map; consecutive replays draw fresh
leaves; the fast round, eager, captured and replayed, makes no host sync;
and a freed graphed engine leaves nothing in a graph's private pool. No JAX: ``python -m pytest --noconftest tests/test_torch_round_graph.py
-k cuda`` runs the card half on the card."""

import gc
import random

import numpy as np
import pytest
import torch

from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine import batcher
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.engine.checkpoint import bytes_to_state, state_to_bytes
from grapevine_tpu_torch.engine.convert import first_difference, to_numpy
from grapevine_tpu_torch.engine.round_graph import EAGER_REASONS, copy_state_, static_round
from grapevine_tpu_torch.engine.round_step import admission_fast_ok
from grapevine_tpu_torch.oblivious import gather_kernels
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord
from _torch_threads import one_torch_thread  # noqa: F401

NOW0 = 1_700_000_000
#: a geometry whose campaign comes within B of the recipient quota (the
#: slow branch) and leaves it again after a sweep
GEO = dict(max_messages=2**10, max_recipients=48, batch_size=16, mailbox_cap=8,
           vphases_impl="dense", bucket_cipher_impl="pallas_fused_tiled", pipeline_depth=1)


def _key(n: int) -> bytes:
    return bytes([n & 0xFF, (n >> 8) & 0xFF, n ^ 0x5A]) + b"\x01" * 29


def _req(rt, auth, recipient=C.ZERO_PUBKEY, pay=0) -> QueryRequest:
    return QueryRequest(request_type=rt, auth_identity=auth, record=RequestRecord(
        msg_id=C.ZERO_MSG_ID, recipient=recipient, payload=bytes([pay]) * C.PAYLOAD_SIZE))


def _reqs(rng: random.Random, n: int, users: int = 40) -> list[QueryRequest]:
    """CREATE / zero-id READ / zero-id DELETE, a pure function of the rng."""
    out = []
    for _ in range(n):
        c = rng.random()
        auth = _key(rng.randrange(1, users + 1))
        if c < 0.6:
            out.append(_req(C.REQUEST_TYPE_CREATE, auth, _key(rng.randrange(1, users + 1)),
                            rng.randrange(256)))
        elif c < 0.84:
            out.append(_req(C.REQUEST_TYPE_READ, auth, auth))
        else:
            out.append(_req(C.REQUEST_TYPE_DELETE, auth, auth))
    return out


class StandInGraph:
    """A CPU stand-in for ``RoundGraph``: "capture" keeps the static state
    and a static batch of its own; every replay copies the round's batch
    columns (``fed``, as the dispatch received them) into that batch, as
    the card's uploads copy into the engine's one batch buffer, and runs
    the captured body, ``static_round``."""

    def __init__(self, ecfg, state, batch):
        self._batch = {k: v.clone() for k, v in batch.items()}
        self._args = (ecfg, state, self._batch)
        self.fed = None

    def replay(self):
        if self.fed is not None:
            for k, v in batcher.upload_batch(self.fed, "cpu")[0].items():
                self._batch[k].copy_(v)
        return static_round(*self._args)


def _replaying_cpu_engine(monkeypatch, cfg, seed):
    """A CPU engine let to replay: its graph is the stand-in, fed each
    round's batch columns as the dispatch receives them."""
    monkeypatch.setattr(batcher, "RoundGraph", StandInGraph)
    eng = GrapevineEngine(cfg, seed=seed, device="cpu")
    eng._graph_block = None
    dispatch = eng._dispatch_round

    def fed_dispatch(batch, *a, **k):
        if eng._graph is not None:
            eng._graph.fed = batch
        return dispatch(batch, *a, **k)

    monkeypatch.setattr(eng, "_dispatch_round", fed_dispatch)
    return eng


def _addresses(state) -> dict:
    return {k: t.data_ptr() for k, t in
            ((k, getattr(state, k)) for k in ("freelist", "free_top", "recipients", "seq"))} | {
        f"{n}.{f}": getattr(getattr(state, n), f).data_ptr()
        for n in ("rec", "mb") for f in ("stash_idx", "stash_val", "posmap", "epoch",
                                         "overflow", "ebuf_idx", "ebuf_rounds")}


def _assert_same_state(a, b, where):
    diff = first_difference(to_numpy(a.state), to_numpy(b.state), mask_junk=False)
    assert diff is None, f"{where}: state differs at {diff}"
    for ga, gb in ((a.state.rng, b.state.rng), (a.state.pm_rng, b.state.pm_rng)):
        assert (ga is None) == (gb is None), where
        if ga is not None:
            assert torch.equal(ga.get_state(), gb.get_state()), f"{where}: generator"


def _install(eng) -> None:
    """A state set from outside: the engine's own state through its
    checkpoint bytes, a new object of every leaf (a standby's install)."""
    eng.state = bytes_to_state(eng.ecfg, state_to_bytes(eng.ecfg, eng.state), eng.device)


def _step(engines, rng, i, sweeps=(), installs=()):
    """One step on every engine (the same requests): a sweep, an install,
    or a round; returns the rounds' (responses packed, transcript) a
    engine, or None."""
    if i in sweeps:
        for e in engines:
            e.expire(NOW0 + i, period=3)
        return None
    if i in installs:
        for e in engines:
            _install(e)
        return None
    reqs = _reqs(rng, engines[0].ecfg.batch_size)
    out = []
    for e in engines:
        resp, tr = e.handle_queries_with_transcript(reqs, NOW0 + i)
        out.append(([r.pack() for r in resp], np.asarray(tr)))
    return out


def _assert_branch_exact(eng) -> None:
    """The admission branch the engine decides now equals the reference's
    predicate on the state's exact values (no round in flight)."""
    b = eng.ecfg.batch_size
    want = admission_fast_ok(eng.ecfg, int(eng.state.free_top), int(eng.state.recipients), b)
    with eng._lock:
        eng._fold_resolved()
        assert eng._admission(0) is want


# -- the engagement rule ------------------------------------------------------


@pytest.mark.parametrize("kw,reason", [({}, "not_cuda"), ({"shards": 2}, "mesh"),
                                       ({"commit": "op"}, "op_major")])
def test_engines_that_never_replay_count_their_reason(kw, reason):
    eng = GrapevineEngine(GrapevineConfig(**dict(GEO, **kw)), seed=2, device="cpu")
    rng = random.Random(1)
    pending = [eng.handle_queries_async(_reqs(rng, 16), NOW0 + i) for i in range(3)]
    for p in pending:
        p.resolve()
    assert not any(p.replayed for p in pending)
    got = eng.health()["round_graph"]
    assert got == {"replayed": 0, "eager": {r: 3 if r == reason else 0 for r in EAGER_REASONS}}
    assert eng._graph is None and eng._batch_buf is None


def test_round_graph_health_key_shape():
    eng = GrapevineEngine(GrapevineConfig(**GEO), seed=2, device="cpu")
    h = eng.health()["round_graph"]
    assert set(h) == {"replayed", "eager"} and h["replayed"] == 0
    assert tuple(h["eager"]) == EAGER_REASONS
    assert all(type(v) is int and v == 0 for v in h["eager"].values())
    assert EAGER_REASONS == ("warmup", "slow_branch", "not_cuda", "mesh", "op_major")


@pytest.mark.parametrize("evict_every", [1, 2])
def test_static_round_equals_the_eager_engine(monkeypatch, evict_every):
    """The captured body replayed by a stand-in graph on the CPU: the first
    fast round runs eagerly (warm-up), the second captures and every later
    fast round replays; a slow-branch round, two sweeps and an install sit
    between replays (and at E=2 the eager flushes). After every step the
    responses, the transcript and every state leaf equal the eager
    engine's, and the replaying engine's state keeps its addresses."""
    cfg = GrapevineConfig(**dict(GEO, evict_every=evict_every))
    eng = _replaying_cpu_engine(monkeypatch, cfg, seed=3)
    twin = GrapevineEngine(cfg, seed=3, device="cpu")
    rng = random.Random(5)
    ptrs = None
    for i in range(18):
        out = _step((eng, twin), rng, i, sweeps=(9, 14), installs=(11,))
        if out is not None:
            (ra, ta), (rb, tb) = out
            assert ra == rb, f"step {i}: responses"
            assert np.array_equal(ta, tb), f"step {i}: transcript"
        _assert_same_state(eng, twin, f"step {i}")
        if eng._graph is not None:
            ptrs = ptrs or _addresses(eng.state)
            assert _addresses(eng.state) == ptrs, f"step {i}: the state moved"
    counts = eng.health()["round_graph"]
    assert counts["eager"]["warmup"] == 1 and counts["eager"]["slow_branch"] >= 1
    assert counts["replayed"] + counts["eager"]["warmup"] + counts["eager"]["slow_branch"] == 15
    assert counts["replayed"] >= 8
    assert twin.health()["round_graph"]["eager"]["not_cuda"] == 15


def test_state_writes_go_through_one_setter(monkeypatch):
    """Once the graph holds the state, a flush (same free_top and
    recipients tensors: the bound holds), a sweep (reads the exact values
    itself) and an install from outside (the next round reads them) are
    copied into the static state, and after each the admission branch
    equals ``admission_fast_ok`` on the exact values. The campaign stands
    within B of the recipient quota at the flush, so the branch there is
    the slow one; a sweep that evicts everything turns it fast."""
    cfg = GrapevineConfig(**dict(GEO, evict_every=2))
    eng = _replaying_cpu_engine(monkeypatch, cfg, seed=3)
    rng = random.Random(5)

    def exact_fast():
        return admission_fast_ok(eng.ecfg, int(eng.state.free_top),
                                 int(eng.state.recipients), 16)

    for i in range(30):  # up to the quota, a round in the window
        eng.handle_queries(_reqs(rng, 16), NOW0 + i)
        if not exact_fast() and eng._rounds_since_flush:
            break
    assert eng._graph is not None and not exact_fast()
    ptrs = _addresses(eng.state)
    reads = []
    read = eng._read_bound_locked
    monkeypatch.setattr(eng, "_read_bound_locked", lambda: reads.append(1) or read())

    version = eng._state_version
    assert eng.flush_now() and not exact_fast()
    assert eng._state_version == version and _addresses(eng.state) == ptrs
    _assert_branch_exact(eng)
    assert reads == []

    eng.expire(NOW0 + 100, period=10**6)  # a sweep that evicts no record
    assert eng._state_version == version + 1 == eng._bound_version and reads == [1]
    assert _addresses(eng.state) == ptrs
    _assert_branch_exact(eng)
    assert reads == [1]

    _install(eng)
    assert eng._state_version == version + 2 != eng._bound_version
    assert _addresses(eng.state) == ptrs
    _assert_branch_exact(eng)
    assert reads == [1, 1]

    # the sweep that frees the quota: the branch turns fast, and replays
    eng.expire(NOW0 + 100, period=1)
    assert exact_fast()
    _assert_branch_exact(eng)
    before = eng.health()["round_graph"]["replayed"]
    eng.handle_queries(_reqs(rng, 16), NOW0 + 101)
    assert eng.health()["round_graph"]["replayed"] == before + 1
    assert _addresses(eng.state) == ptrs


@pytest.mark.parametrize("replaying", [False, True])
def test_pending_round_hands_over_its_transcript(monkeypatch, replaying):
    """``PendingRound.transcript``: the transcript a dispatch asked for,
    equal to ``handle_queries_with_transcript``'s for the same round on a
    twin, a replayed round's included; None where none was asked for."""
    cfg = GrapevineConfig(**GEO)
    eng = (_replaying_cpu_engine(monkeypatch, cfg, seed=3) if replaying
           else GrapevineEngine(cfg, seed=3, device="cpu"))
    twin = GrapevineEngine(cfg, seed=3, device="cpu")
    rng = random.Random(4)
    for i in range(4):
        reqs = _reqs(rng, 16)
        _, want = twin.handle_queries_with_transcript(reqs, NOW0 + i)
        with eng._lock:
            pending = eng._dispatch_round(batcher.pack_batch(reqs, 16, NOW0 + i), 16, {},
                                          transcript=True)
        pending.resolve()
        assert np.array_equal(pending.transcript, want), f"round {i}"
    assert eng.health()["round_graph"]["replayed"] == (3 if replaying else 0)
    plain = eng.handle_queries_async(_reqs(rng, 16), NOW0 + 9)
    plain.resolve()
    assert plain.transcript is None


def test_copy_state_keeps_addresses_and_refuses_other_geometry():
    cfg = GrapevineConfig(**GEO)
    eng = GrapevineEngine(cfg, seed=4, device="cpu")
    other = GrapevineEngine(cfg, seed=9, device="cpu")
    eng.handle_queries(_reqs(random.Random(2), 16), NOW0)
    static = eng.state
    ptrs = _addresses(static)
    copy_state_(static, other.state)
    assert _addresses(static) == ptrs
    diff = first_difference(to_numpy(static), to_numpy(other.state), mask_junk=False)
    assert diff is None
    assert static.rng is not other.state.rng
    assert torch.equal(static.rng.get_state(), other.state.rng.get_state())
    # a source in the static state's own memory is cloned before anything
    # is copied: seq takes the first words freelist held before its copy
    want_fl, want_seq = static.freelist.flip(0), static.freelist[:2].clone()
    copy_state_(static, static._replace(freelist=static.freelist.flip(0),
                                        seq=static.freelist[:2]))
    assert torch.equal(static.freelist, want_fl) and torch.equal(static.seq, want_seq)
    assert _addresses(static) == ptrs
    with pytest.raises(ValueError, match="freelist"):
        copy_state_(static, static._replace(freelist=static.freelist[:-1]))
    with pytest.raises(ValueError, match="seq"):
        copy_state_(static, static._replace(seq=static.seq.to(torch.int64)))


# -- on the card ----------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the round graph and the fused round's Hopper "
                    "kernels run only on the card (run on the card: python -m pytest "
                    "--noconftest tests/test_torch_round_graph.py -k cuda)")
    return torch.device("cuda")


def _eager_twin(cfg, seed, dev):
    """An engine of the same seed whose every round runs op by op."""
    twin = GrapevineEngine(cfg, seed=seed, device=dev)
    twin._eager_reason = lambda fast_ok: "slow_branch" if not fast_ok else "warmup"
    return twin


CARD_CASES = [
    pytest.param(dict(GEO), 3, id="g1-seed3"),
    pytest.param(dict(GEO), 2**31 + 17, id="g1-seed-large"),
    pytest.param(dict(GEO, max_messages=2**13, max_recipients=68, batch_size=32), 5,
                 id="g2-seed5"),
    pytest.param(dict(GEO, max_messages=2**13, max_recipients=68, batch_size=32), 2**32 + 1,
                 id="g2-seed-large"),
    pytest.param(dict(GEO, evict_every=4, bucket_cipher_impl="pallas_fused"), 6, id="e4"),
    pytest.param(dict(GEO, posmap_impl="recursive"), 7, id="recursive"),
]


@pytest.mark.parametrize("geo,seed", CARD_CASES)
def test_cuda_graphed_engine_equals_eager(cuda_device, geo, seed):
    """A graphed engine and an engine that runs every round op by op, from
    the same seed, over the same steps: rounds (at least 8 replayed), the
    slow branch near the recipient quota, two sweeps and an install from
    outside between replays (at E=4 the eager flushes too), then a
    depth-2 call of three rounds. After every step every response, every
    transcript column and every state leaf is bit-identical, and each
    replay's transcript differs from the one before (fresh draws)."""
    cfg = GrapevineConfig(**dict(geo, pipeline_depth=2))
    eng = GrapevineEngine(cfg, seed=seed % (1 << 63), device=cuda_device)
    twin = _eager_twin(cfg, seed % (1 << 63), cuda_device)
    rng = random.Random(seed)
    last = None
    for i in range(18):
        before = eng.health()["round_graph"]["replayed"]
        out = _step((eng, twin), rng, i, sweeps=(9, 14), installs=(11,))
        if out is not None:
            (ra, ta), (rb, tb) = out
            assert ra == rb, f"step {i}: responses"
            assert np.array_equal(ta, tb), f"step {i}: transcript"
            if eng.health()["round_graph"]["replayed"] > before:
                assert last is None or not np.array_equal(ta, last), f"step {i}: stale draws"
                last = ta
        _assert_same_state(eng, twin, f"step {i}")
    reqs = _reqs(rng, 3 * eng.ecfg.batch_size)
    assert ([r.pack() for r in eng.handle_queries(reqs, NOW0 + 20)]
            == [r.pack() for r in twin.handle_queries(reqs, NOW0 + 20)])
    _assert_same_state(eng, twin, "depth 2")
    counts = eng.health()["round_graph"]
    assert counts["replayed"] >= 8 and counts["eager"]["warmup"] == 1
    assert counts["eager"]["slow_branch"] >= 1, "the campaign never took the slow branch"
    assert twin.health()["round_graph"]["replayed"] == 0


def test_cuda_fast_round_makes_no_host_sync(cuda_device):
    """Under ``torch.cuda.set_sync_debug_mode("error")``: eager fast
    rounds, and the capture, its replay and four more replays, each
    dispatched while the one before is still in flight. The kernel
    wrappers' launch counters count the wrappers' calls: every eager
    round's, the capture's once, and no replay's."""
    # far from the recipient quota: the admission bound decides every round
    cfg = GrapevineConfig(**dict(GEO, max_recipients=2**8, pipeline_depth=2))
    eng = GrapevineEngine(cfg, seed=8, device=cuda_device)
    twin = _eager_twin(cfg, 8, cuda_device)
    rng = random.Random(3)
    calls = [_reqs(rng, 16) for _ in range(6)]
    for e in (eng, twin):
        # the first round reads the admission bound (one host read)
        e.handle_queries(calls[0], NOW0)
    for e in (eng, twin):
        gather_kernels.reset_launches()
        pending = None
        for i, reqs in enumerate(calls[1:], 1):
            torch.cuda.set_sync_debug_mode("error")
            try:
                nxt = e.handle_queries_async(reqs, NOW0 + i)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if pending is not None:
                pending.resolve()
            pending = nxt
        pending.resolve()
        # three B4 and three B6 a round run op by op or captured
        rounds = 1 if e is eng else 5
        assert gather_kernels.LAUNCHES["gather_decrypt_rows_tiled"] == 3 * rounds
        assert gather_kernels.LAUNCHES["scatter_encrypt_rows_tiled"] == 3 * rounds
    assert eng.health()["round_graph"]["replayed"] == 5
    assert twin.health()["round_graph"]["eager"]["warmup"] == 6
    _assert_same_state(eng, twin, "end")


def _graph_pool_bytes() -> int:
    """Bytes the caching allocator holds in graphs' private pools."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", (0, 0))) != (0, 0))


def test_cuda_freed_engine_returns_its_graph_pool(cuda_device):
    """A graphed engine, once freed, leaves nothing in a graph's private
    pool: what the capture would allocate for good (cuBLAS's workspace for
    the capture's stream, which the round's float64 matmuls use) is made
    before the capture. Two engines in turn, each captured and replayed."""
    gc.collect()
    torch.cuda.empty_cache()
    before = _graph_pool_bytes()
    for seed in (1, 2):
        eng = GrapevineEngine(GrapevineConfig(**dict(GEO, pipeline_depth=2)), seed=seed,
                              device=cuda_device)
        rng = random.Random(seed)
        for i in range(3):
            eng.handle_queries(_reqs(rng, 16), NOW0 + i)
        assert eng.health()["round_graph"]["replayed"] == 2
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        assert _graph_pool_bytes() == before, f"engine {seed}: a graph's pool outlived it"
