"""Flat ↔ recursive and xla ↔ radix on the port's engine (port only; the
reference's ``tests/test_posmap_ab.py`` is the model):

- one seed, four engines (flat/recursive x xla/radix) through the facade:
  the same responses, and the same payload-facing state (trees, stashes,
  nonces, keys, epochs, freelist, counters, generator) after every round,
  flush and sweep, with each recursive map's logical table equal to the
  flat table (``read_table``), at E=1 and E=2;
- a flat checkpoint never restores into a recursive engine, nor the
  reverse (the fingerprint covers the ``PosMapSpec``), and a standby
  refuses a primary of the other map;
- a durable recursive engine recovers (checkpoint + journal) equal to the
  live one, generators included, and a standby follows it and promotes
  equal;
- the leak monitor stays PASS with the internal ``*_pm`` streams;
- ``engine_cost_ledger`` equals the reference's on recursive engines;
- the CLI's ``--posmap-impl`` / ``--sort-impl`` reach every
  device-owning role;
- on the card (``-k cuda``, ``--noconftest``): a recursive, radix depth-2
  dispatch makes no host sync and equals a depth-1 engine.
"""

import dataclasses
import os
import random
import shutil
import time

import numpy as np
import pytest
import torch

from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.engine.checkpoint import (
    CheckpointError,
    bytes_to_state,
    engine_fingerprint,
    state_to_bytes,
)
from grapevine_tpu_torch.engine.convert import to_numpy
from grapevine_tpu_torch.engine.state import EngineConfig, init_engine
from grapevine_tpu_torch.oram.posmap import read_table
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

NOW = 1_700_000_000
ROOT = bytes(range(32))
BASE = dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=8,
            stash_size=64, vphases_impl="dense")

#: payload-facing leaves (the reference's ``_TREE_FIELDS``): the map and
#: the leaf planes are compared as logical tables instead
_TREE_FIELDS = ("tree_idx", "tree_val", "stash_idx", "stash_val", "overflow",
                "nonces", "cipher_key", "epoch", "ebuf_idx", "ebuf_val", "ebuf_paths",
                "ebuf_rounds", "ebuf_gen", "fetch_tag", "cache_idx", "cache_val")
_SCALARS = ("freelist", "free_top", "recipients", "seq", "hash_key", "id_key")


def _key(n: int) -> bytes:
    return bytes([n, n ^ 0x5A]) + b"\x02" * 30


def _reqs(rng: random.Random, b: int, live: list, users: int = 6):
    out = []
    for _ in range(rng.randint(1, b)):
        a, r = _key(rng.randrange(users) + 1), _key(rng.randrange(users) + 1)
        k = rng.random()
        if k < 0.4 or not live:
            out.append(QueryRequest(request_type=C.REQUEST_TYPE_CREATE, auth_identity=a,
                                    record=RequestRecord(recipient=r, payload=bytes(
                                        [rng.randrange(256)]) * C.PAYLOAD_SIZE)))
        elif k < 0.8:
            mid, a, r = live[rng.randrange(len(live))]
            t = (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_UPDATE,
                 C.REQUEST_TYPE_DELETE)[rng.randrange(3)]
            out.append(QueryRequest(request_type=t, auth_identity=a, record=RequestRecord(
                msg_id=mid, recipient=r, payload=bytes([7]) * C.PAYLOAD_SIZE)))
        else:  # zero-id read/delete of my own mailbox
            t = (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_DELETE)[rng.randrange(2)]
            out.append(QueryRequest(request_type=t, auth_identity=r,
                                    record=RequestRecord(recipient=r)))
    return out


def _note(reqs, resps, live):
    for q, p in zip(reqs, resps):
        if q.request_type == C.REQUEST_TYPE_CREATE and p.status_code == C.STATUS_CODE_SUCCESS:
            live.append((p.record.msg_id, q.auth_identity, q.record.recipient))


def _payload_equal(flat, other, where):
    a, b = to_numpy(flat.state), to_numpy(other.state)
    for tree in ("rec", "mb"):
        for f in _TREE_FIELDS:
            np.testing.assert_array_equal(a[f"{tree}.{f}"], b[f"{tree}.{f}"],
                                          f"{where}: {tree}.{f}")
        cfg, ocfg = getattr(flat.ecfg, tree), getattr(other.ecfg, tree)
        st, ost = getattr(flat.state, tree), getattr(other.state, tree)
        np.testing.assert_array_equal(read_table(cfg, st.posmap),
                                      read_table(ocfg, ost.posmap), f"{where}: {tree} table")
    for k in _SCALARS:
        np.testing.assert_array_equal(a[k], b[k], f"{where}: {k}")
    assert torch.equal(flat.state.rng.get_state(), other.state.rng.get_state()), where


@pytest.mark.parametrize("evict_every,impl", [(1, "pallas_fused_tiled"), (2, "pallas_fused")])
def test_flat_recursive_xla_radix_same_responses_and_payload_state(evict_every, impl):
    kw = dict(BASE, evict_every=evict_every, bucket_cipher_impl=impl)
    engines = {(pm, so): GrapevineEngine(GrapevineConfig(**kw, posmap_impl=pm, sort_impl=so),
                                         seed=41, device="cpu")
               for pm in ("flat", "recursive") for so in ("xla", "radix")}
    ref = engines[("flat", "xla")]
    assert ref.state.pm_rng is None and engines[("recursive", "xla")].state.pm_rng is not None
    rng, live = random.Random(5), []
    for rnd in range(7):
        reqs = _reqs(rng, 8, live)
        resps = {k: e.handle_queries(reqs, NOW + rnd) for k, e in engines.items()}
        want = [r.pack() for r in resps[("flat", "xla")]]
        for k, rs in resps.items():
            assert [r.pack() for r in rs] == want, f"round {rnd}: {k}"
        _note(reqs, resps[("flat", "xla")], live)
        for k, e in engines.items():
            _payload_equal(ref, e, f"round {rnd} {k}")
    for e in engines.values():
        e.flush_now()
        e.expire(NOW + 100, 95)
    for k, e in engines.items():
        _payload_equal(ref, e, f"after flush and sweep {k}")
        if k[0] == "recursive":
            assert int(e.state.rec.posmap.inner.overflow) == 0


def test_checkpoint_and_standby_refuse_the_other_map(tmp_path):
    from grapevine_tpu_torch.engine.replication import (
        JournalShipper,
        StandbyReplica,
        replication_fingerprint,
    )

    cf = GrapevineConfig(**BASE, posmap_impl="flat")
    cr = GrapevineConfig(**BASE, posmap_impl="recursive")
    ecf, ecr = EngineConfig.from_config(cf), EngineConfig.from_config(cr)
    assert engine_fingerprint(ecf) != engine_fingerprint(ecr)
    assert replication_fingerprint(cf) != replication_fingerprint(cr)
    blob_f = state_to_bytes(ecf, init_engine(ecf, 1, device="cpu"))
    blob_r = state_to_bytes(ecr, init_engine(ecr, 1, device="cpu"))
    assert bytes_to_state(ecr, blob_r, device="cpu").pm_rng is not None
    assert bytes_to_state(ecf, blob_f, device="cpu").pm_rng is None
    with pytest.raises(CheckpointError, match="fingerprint"):
        bytes_to_state(ecr, blob_f, device="cpu")
    with pytest.raises(CheckpointError, match="fingerprint"):
        bytes_to_state(ecf, blob_r, device="cpu")
    # the recursion geometry is covered too, not just the impl name
    from grapevine_tpu_torch.oram.posmap import derive_posmap_spec

    ecr2 = dataclasses.replace(ecr, rec=dataclasses.replace(
        ecr.rec, posmap=derive_posmap_spec(64, entries_per_block=2)))
    assert engine_fingerprint(ecr2) != engine_fingerprint(ecr)
    with pytest.raises(CheckpointError, match="fingerprint"):
        bytes_to_state(ecr2, blob_r, device="cpu")
    # a flat primary's journal never ships into a recursive standby
    pdir, sdir = str(tmp_path / "p"), str(tmp_path / "s")
    for d in (pdir, sdir):
        _plant(d)
    primary = GrapevineEngine(cf, seed=0, device="cpu", durability=_dcfg(pdir))
    replica = StandbyReplica(cr, seed=0, device="cpu", durability=_dcfg(sdir))
    shipper = JournalShipper(primary, ("127.0.0.1", replica.listen()))
    shipper.start()
    try:
        _wait(lambda: shipper.fatal is not None, "fingerprint refusal")
        assert "fingerprint" in shipper.fatal and replica.dm.seq == 0
    finally:
        shipper.close()
        primary.close()
        replica.close()


def _plant(d: str) -> None:
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "root.key"), "wb") as fh:
        fh.write(ROOT)
    os.chmod(os.path.join(d, "root.key"), 0o600)


def _dcfg(d: str, **kw) -> DurabilityConfig:
    kw.setdefault("checkpoint_every_rounds", 1 << 20)
    return DurabilityConfig(state_dir=d, **kw)


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    pytest.fail(f"timed out waiting for {what}")


def _state_equal(a, b) -> bool:
    return (state_to_bytes(a.ecfg, a.state) == state_to_bytes(b.ecfg, b.state)
            and torch.equal(a.state.rng.get_state(), b.state.rng.get_state())
            and torch.equal(a.state.pm_rng.get_state(), b.state.pm_rng.get_state()))


def test_recursive_engine_recovers_and_a_standby_follows_it(tmp_path):
    from grapevine_tpu_torch.engine.replication import JournalShipper, StandbyReplica

    cfg = GrapevineConfig(**BASE, posmap_impl="recursive", sort_impl="radix", evict_every=2)
    pdir, sdir = str(tmp_path / "p"), str(tmp_path / "s")
    for d in (pdir, sdir):
        _plant(d)
    primary = GrapevineEngine(cfg, seed=9, device="cpu", durability=_dcfg(pdir))
    replica = StandbyReplica(cfg, seed=9, device="cpu", durability=_dcfg(sdir))
    shipper = JournalShipper(primary, ("127.0.0.1", replica.listen()))
    shipper.start()
    rng, live = random.Random(3), []
    try:
        for rnd in range(5):
            reqs = _reqs(rng, 8, live)
            _note(reqs, primary.handle_queries(reqs, NOW + rnd), live)
            if rnd == 2:
                primary.checkpoint_now()
        primary.expire(NOW + 50, 45)

        def caught_up():
            with replica.engine._lock:
                return replica.dm.applied_seq == primary.durability.seq
        _wait(caught_up, "standby catch-up")
        with replica.engine._lock:
            assert _state_equal(replica.engine, primary)
        shipper.close()
        reqs = _reqs(rng, 8, live)
        last = [r.pack() for r in primary.handle_queries(reqs, NOW + 60)]
        dead_seq = primary.durability.seq
        primary.close()
        # recovery (on a copy: the promote below fences the primary's dir):
        # the checkpoint at round 3 + the journal tail
        rdir = str(tmp_path / "r")
        shutil.copytree(pdir, rdir)
        rec = GrapevineEngine(cfg, seed=9, device="cpu", durability=_dcfg(rdir))
        assert rec.durability.recovered_from_checkpoint and rec.durability.replayed > 0
        assert _state_equal(rec, primary)
        # the standby drains the tail on promote and equals the dead primary
        info = replica.promote(primary_state_dir=pdir)
        assert info["applied_seq"] == dead_seq and info["rpo_durable_frames"] == 0
        assert _state_equal(replica.engine, primary)
        nxt = _reqs(rng, 8, live)
        assert ([r.pack() for r in rec.handle_queries(nxt, NOW + 61)]
                == [r.pack() for r in replica.engine.handle_queries(nxt, NOW + 61)])
        assert last  # the live primary answered its last round
        rec.close()
    finally:
        shipper.close()
        primary.close()
        replica.close()


def test_leak_monitor_passes_with_internal_posmap_streams():
    from grapevine_tpu_torch.obs.leakmon import EngineLeakMonitor, LeakMonitorConfig

    eng = GrapevineEngine(GrapevineConfig(**BASE, posmap_impl="recursive", sort_impl="radix"),
                          seed=4, device="cpu")
    mon = EngineLeakMonitor.for_engine(eng, LeakMonitorConfig(window_rounds=64))
    assert set(mon.monitor.streams) == {"rec", "mb", "rec_pm", "mb_pm"}
    eng.attach_leakmon(mon)
    rng, live = random.Random(77), []
    try:
        for rnd in range(12):
            reqs = _reqs(rng, 8, live, users=4)
            _note(reqs, eng.handle_queries(reqs, NOW + rnd), live)
        assert mon.flush(), "leak monitor did not drain"
        v = mon.verdict()
        assert v["verdict"] == "PASS", v
        for t in ("rec_pm", "mb_pm"):
            assert mon.monitor.stats(t)["pooled_leaves"] > 0, t
    finally:
        mon.close()


@pytest.mark.parametrize("kw", [
    dict(BASE, posmap_impl="recursive", sort_impl="radix"),
    dict(BASE, posmap_impl="recursive", evict_every=4, tree_top_cache_levels=2),
    dict(BASE, posmap_impl="recursive", bucket_cipher_rounds=0, evict_every=2),
    dict(max_messages=2**20, max_recipients=2**12, batch_size=2048, vphases_impl="dense",
         posmap_impl="recursive", sort_impl="radix", evict_every=4),
])
def test_cost_ledger_equals_reference_on_recursive_engines(kw):
    from grapevine_tpu.analysis import costmodel as rcm
    from grapevine_tpu.config import GrapevineConfig as JConfig
    from grapevine_tpu.engine.state import EngineConfig as JEcfg

    from grapevine_tpu_torch.analysis import costmodel

    ecfg = EngineConfig.from_config(GrapevineConfig(**kw))
    jecfg = JEcfg.from_config(JConfig(**kw))
    for shards in (1, 2):
        ours = costmodel.engine_cost_ledger(ecfg, shards=shards)
        theirs = rcm.engine_cost_ledger(jecfg, shards=shards)
        for ph in costmodel.COST_PHASES:
            assert vars(ours.phases[ph]) == vars(theirs.phases[ph]), ph
        for attr in ("steady_round_bytes", "steady_round_cipher_rows",
                     "steady_round_sort_keys", "per_shard_steady_round_bytes"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert {k: (v.gather_rows, v.scatter_rows) for k, v in
            costmodel.engine_round_rows(ecfg).items()} == \
        {k: (v.gather_rows, v.scatter_rows) for k, v in rcm.engine_round_rows(jecfg).items()}
    assert any(k.startswith("rec_pm_") for k in costmodel.engine_round_rows(ecfg))
    b = ecfg.batch_size
    for t, jt in ((ecfg.rec, jecfg.rec), (ecfg.mb, jecfg.mb)):
        assert costmodel.oram_steady_bytes(t, b) == rcm.oram_steady_bytes(jt, b)


class _Captured(Exception):
    pass


@pytest.mark.parametrize("role", ["mono", "engine", "standby"])
def test_cli_posmap_and_sort_flags_reach_every_device_role(role, monkeypatch, tmp_path):
    from grapevine_tpu_torch.engine import replication
    from grapevine_tpu_torch.server import cli, service, tier

    seen = []

    def capture(config, *a, **kw):
        seen.append(config)
        raise _Captured

    for mod, name in ((service, "GrapevineServer"), (tier, "EngineServer"),
                      (replication, "StandbyReplica")):
        monkeypatch.setattr(mod, name, capture)
    argv = ["--device", "cpu", "--msg-capacity", "64", "--recipient-capacity", "8",
            "--batch-size", "4", "--posmap-impl", "recursive", "--sort-impl", "radix"]
    if role != "mono":
        argv += ["--role", role]
    if role == "standby":
        argv += ["--state-dir", str(tmp_path)]
    with pytest.raises(_Captured):
        cli.main(argv)
    (config,) = seen
    assert (config.posmap_impl, config.sort_impl) == ("recursive", "radix")
    ecfg = GrapevineEngine(config, device="cpu").ecfg
    assert ecfg.posmap_impl == "recursive" and ecfg.sort_impl == "radix"
    assert ecfg.rec.posmap is not None and ecfg.mb.posmap is not None
    # a frontend owns no engine: it refuses both flags
    with pytest.raises(SystemExit):
        cli.main(["--role", "frontend", "--engine", "127.0.0.1:1", "--sort-impl", "radix"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the recursive round's fused kernels have no "
                    "CPU mode (python -m pytest --noconftest tests/test_torch_posmap_ab.py "
                    "-k cuda)")
    return torch.device("cuda")


@pytest.mark.parametrize("impl,evict_every", [("pallas_fused", 2), ("pallas_fused_tiled", 1)])
def test_cuda_recursive_depth2_dispatch_makes_no_host_sync(cuda_device, impl, evict_every):
    """On the card a recursive, radix engine dispatches 8 depth-2 rounds
    under ``torch.cuda.set_sync_debug_mode("error")`` (the internal ORAM
    round, the leaf plane and the radix passes included), and equals a
    depth-1 engine."""
    geo = dict(max_messages=2**12, max_recipients=2**8, batch_size=32, mailbox_cap=8,
               vphases_impl="dense", bucket_cipher_impl=impl, evict_every=evict_every,
               posmap_impl="recursive", sort_impl="radix")
    e1 = GrapevineEngine(GrapevineConfig(pipeline_depth=1, **geo), seed=8, device=cuda_device)
    e2 = GrapevineEngine(GrapevineConfig(pipeline_depth=2, **geo), seed=8, device=cuda_device)
    rng = random.Random(11)
    live: list = []
    calls = []
    for i in range(10):
        reqs = _reqs(rng, 32, live, users=40)
        _note(reqs, e1.handle_queries(reqs, NOW + i), live)
        calls.append(reqs)
    want = []
    e1b = GrapevineEngine(GrapevineConfig(pipeline_depth=1, **geo), seed=8,
                          device=cuda_device)
    for i, reqs in enumerate(calls):
        want += [r.pack() for r in e1b.handle_queries(reqs, NOW + i)]
    got, pending = [], None
    for i, reqs in enumerate(calls):
        if i >= 2:
            torch.cuda.set_sync_debug_mode("error")
        try:
            nxt = e2.handle_queries_async(reqs, NOW + i)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if pending is not None:
            got += [r.pack() for r in pending.resolve()]
        pending = nxt
    got += [r.pack() for r in pending.resolve()]
    assert got == want
    assert state_to_bytes(e2.ecfg, e2.state) == state_to_bytes(e1b.ecfg, e1b.state)
