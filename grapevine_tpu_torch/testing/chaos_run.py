"""Crash-recovery chaos harness (port of ``tools/chaos_run.py``).

Runs a deterministic engine workload in a child process with durability
on, SIGKILLs the child at a randomized point — either an armed
fault-injection site inside the journal/checkpoint/round protocol
(``testing/faults.py``) or a wall-clock timer — restarts it until the
workload completes, and asserts the run is **bit-identical** to an
uninterrupted oracle:

- every per-event response hash the (possibly many) child incarnations
  recorded matches the oracle's hash for that event;
- the final recovered engine state equals the oracle's final state,
  byte for byte (``engine/checkpoint.py:state_to_bytes``); a sharded
  child against a ``"pallas_fused*"`` oracle on the card compares with
  the junk bucket masked, because under a mesh the fused kernels are
  bypassed and the plain scatter writes that bucket;
- the leak monitor verdict stays PASS on the recovered engine;
- no run ever half-loads a torn checkpoint or journal file (a child
  incarnation exiting with anything but SIGKILL or 0 fails the trial).

Usage (the card unless ``--device cpu``)::

    python -m grapevine_tpu_torch.testing.chaos_run --device cpu --trials 50
    python -m grapevine_tpu_torch.testing.chaos_run --device cpu --points
    python -m grapevine_tpu_torch.testing.chaos_run --device cpu --standby --points
    python -m grapevine_tpu_torch.testing.chaos_run --geometry prod \\
        --bucket-cipher-impl pallas_fused --evict-every 4 --reqs 256 2048 \\
        --users 1024 --events 12 --checkpoint-every 1048576 --points

The child re-enters this module with ``--child``. On the card the
uninterrupted oracle runs in a child of its own too (``--oracle-child``),
so no CUDA state of the parent rides into the comparison; children load
the kernel library the parent built (``gather_kernels.build_library``)
and never build it themselves. A timer kill waits for the child's
``ready`` line (engine built and recovered) and then kills within the
oracle's measured schedule wall, so it lands in the schedule and not in
start-up; each trial prints where its kill landed. ``--jobs N`` runs N
restart trials at once (the kill plans are drawn in trial order first,
so a run is the same whatever N is); standby trials run one at a time,
their replica in the parent.

A failure line names the trial, its kill site and what diverged: the
event whose responses differ, the final state, the leak verdict, a child
that exited with another code (its stderr tail), or a revived stale
primary that the epoch fence did not refuse.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import random
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

#: the repo root: children run ``python -m`` from here
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

NOW0 = 1_700_000_000
ENGINE_SEED = 3
SWEEP_PERIOD = 10_000
MAX_RESTARTS = 60
#: seconds any one child may run before the trial fails
CHILD_TIMEOUT_S = 900.0

#: engine geometries: the reference harness's own, the 2^14 point and the
#: production point
GEOMETRIES = {
    "chaos": dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=4,
                  stash_size=64, bucket_cipher_rounds=0),
    "small": dict(max_messages=2**14, max_recipients=2**10, batch_size=64),
    "prod": dict(max_messages=2**20, max_recipients=2**12, batch_size=2048),
}


def _config(posmap_impl: str | None = None,
            tree_top_cache_levels: int | None = None,
            pipeline_depth: int | None = None,
            evict_every: int | None = None,
            shards: int | None = None,
            geometry: str = "chaos",
            bucket_cipher_impl: str | None = None):
    from ..config import GrapevineConfig

    kw = dict(GEOMETRIES[geometry])
    if bucket_cipher_impl is not None:
        kw["bucket_cipher_impl"] = bucket_cipher_impl
    return GrapevineConfig(
        **kw,
        posmap_impl=posmap_impl,
        tree_top_cache_levels=tree_top_cache_levels,
        pipeline_depth=pipeline_depth,
        evict_every=evict_every,
        shards=shards or 1,
    )


def _key(n: int) -> bytes:
    return bytes([n & 0xFF, (n >> 8) & 0xFF, (n ^ 0x5A) & 0xFF]) + b"\x01" * 29


def build_schedule(seed: int, n_events: int, reqs: tuple[int, int] = (1, 4),
                   users: int = 5):
    """Deterministic event list; event i carries journal seq i+1 (at
    ``evict_every`` 1).

    Requests avoid response-derived inputs (zero-id READ/DELETE pops
    instead of id lookups) so the schedule is a pure function of the
    seed — any incarnation of the child reconstructs it identically.
    Every 7th event (i % 7 == 5) is a sweep; a round carries between
    ``reqs[0]`` and ``reqs[1]`` requests from ``users`` identities. The
    defaults draw exactly what the reference's schedule draws."""
    from ..wire import constants as C
    from ..wire.records import QueryRequest, RequestRecord

    rng = random.Random(seed)
    events = []
    for i in range(n_events):
        if i % 7 == 5:
            events.append(("sweep", NOW0 + i, SWEEP_PERIOD))
            continue
        batch = []
        for _ in range(rng.randrange(reqs[0], reqs[1] + 1)):
            c = rng.random()
            if c < 0.6:
                rt, rcp = C.REQUEST_TYPE_CREATE, _key(rng.randrange(1, users + 1))
            elif c < 0.9:
                rt, rcp = C.REQUEST_TYPE_READ, C.ZERO_PUBKEY
            else:
                rt, rcp = C.REQUEST_TYPE_DELETE, C.ZERO_PUBKEY
            batch.append(QueryRequest(
                request_type=rt,
                auth_identity=_key(rng.randrange(1, users + 1)),
                auth_signature=b"\x01" * C.SIGNATURE_SIZE,
                record=RequestRecord(
                    msg_id=C.ZERO_MSG_ID,
                    recipient=rcp,
                    payload=bytes([rng.randrange(256)]) * C.PAYLOAD_SIZE,
                ),
            ))
        events.append(("round", NOW0 + i, batch))
    return events


def _resp_hash(resps) -> str:
    return hashlib.sha256(b"".join(r.pack() for r in resps)).hexdigest()


def _events_done(events, durable_seq: int, evict_every: int) -> int:
    """Events covered by the durable journal prefix.

    At evict_every=1 journal seq IS the event count. At E>1 every E-th
    round appends a KIND_FLUSH frame of its own, so the mapping is
    seq(n) = n + floor(rounds(n)/E) — walked forward here. Recovery
    completes a pending flush before the child reads
    ``durability.seq`` (``engine/batcher.py``), so the durable seq always
    lands on an event boundary; anything else is journal corruption and
    must raise, never silently re-run or skip events."""
    if evict_every <= 1:
        return durable_seq
    seq = rounds = 0
    if seq == durable_seq:
        return 0
    for n, ev in enumerate(events):
        seq += 1  # the event's own frame
        if ev[0] == "round":
            rounds += 1
            if rounds % evict_every == 0:
                seq += 1  # its flush frame
        if seq == durable_seq:
            return n + 1
    raise RuntimeError(
        f"durable journal seq {durable_seq} does not land on an event "
        f"boundary of the {len(events)}-event schedule at "
        f"evict_every={evict_every}"
    )


def _run_events(engine, events, start: int, progress=None):
    """Drive ``events[start:]``; append ``seq hash`` progress lines.

    Pipelined per the engine's resolved ``pipeline_depth``: up to depth
    rounds stay dispatched-but-unresolved ACROSS events, so the journal
    and dispatch crash sites fire while earlier rounds are still running
    on the device. Rounds resolve oldest-first (= dispatch = journal
    order); a crash loses only the progress lines of rounds that never
    resolved, whose recovery the final-state hash still covers. Depth 1
    keeps the ledger empty at every event boundary."""
    depth = max(1, getattr(engine, "pipeline_depth", 1))
    ledger: list = []  # (event seq, PendingRound) in dispatch order

    def settle_one():
        seq, pending = ledger.pop(0)
        h = _resp_hash(pending.resolve())
        if progress is not None:
            progress.write(f"{seq} {h}\n")
            progress.flush()

    for i in range(start, len(events)):
        ev = events[i]
        # the pipeline bound: at depth d, dispatch (or sweep — it runs
        # under the same engine lock) with at most d-1 rounds in flight
        while len(ledger) > depth - 1:
            settle_one()
        if ev[0] == "round":
            ledger.append((i + 1, engine.handle_queries_async(ev[2], ev[1])))
        else:
            engine.expire(ev[1], period=ev[2])
            if progress is not None:
                progress.write(f"{i + 1} sweep\n")
                progress.flush()
    while ledger:
        settle_one()


def _masked_hash(ecfg, state) -> str:
    """SHA-256 of the state's leaves with each tree's junk bucket left out
    (``convert.first_difference``'s mask) and its generator state."""
    import numpy as np

    from ..engine.convert import to_numpy

    h = hashlib.sha256()
    flat = to_numpy(state)
    for key in sorted(flat):
        x = np.ascontiguousarray(flat[key])
        if key.endswith(("tree_val", "nonces")):
            x = x[:-1]
        elif key.endswith(("tree_idx", "tree_leaf")):
            z = x.size // flat[key.rsplit("_", 1)[0] + "_val"].shape[0]
            x = x.reshape(-1)[:x.size - z]
        h.update(key.encode())
        h.update(x.tobytes())
    gens = [state.rng] + ([state.pm_rng] if ecfg.posmap_impl == "recursive" else [])
    for g in gens:
        h.update(g.get_state().numpy().tobytes())
    return h.hexdigest()


def _final_hashes(engine, masked: bool) -> tuple[str, str | None]:
    """(whole ``state_to_bytes`` hash, junk-masked hash or None) of the
    engine; the masked one costs a second pass over the state, so only a
    comparison that needs it asks for it."""
    from ..engine.checkpoint import state_to_bytes

    full = hashlib.sha256(state_to_bytes(engine.ecfg, engine.state)).hexdigest()
    return full, _masked_hash(engine.ecfg, engine.state) if masked else None


def _launch_counts() -> dict:
    """Kernel launches this process made (every wrapper's count)."""
    from ..oblivious import cipher_kernels as ck
    from ..oblivious import gather_kernels as gk

    return {k: v for d in (gk.LAUNCHES, ck.LAUNCHES) for k, v in d.items()}


def _observe(engine, shipper=None):
    """Attach the leak monitor, the round tracer and the SLO tracker, as
    serving does; returns the monitor."""
    from ..obs.leakmon import EngineLeakMonitor, LeakMonitorConfig
    from ..obs.slo import SloTracker
    from ..obs.tracer import RoundTracer

    monitor = EngineLeakMonitor.for_engine(engine, LeakMonitorConfig(window_rounds=64))
    engine.attach_leakmon(monitor)
    if shipper is not None:
        monitor.attach_shipper(shipper)
    engine.attach_tracer(RoundTracer(capacity=64, registry=engine.metrics.registry))
    engine.attach_slo(SloTracker(registry=engine.metrics.registry))
    return monitor


def _finish(engine, monitor, events, pf, masked: bool = False) -> None:
    """Drive the schedule's rest on ``engine`` and write the verdict and
    the final hashes to the progress file."""
    start = _events_done(events, engine.durability.seq, engine.evict_every)
    pf.write(f"start {start}\n")
    pf.flush()
    _run_events(engine, events, start, pf)
    monitor.close()  # drain the detector queue before the verdict
    verdict = monitor.verdict()["verdict"]
    full, finalx = _final_hashes(engine, masked)
    pf.write(f"leakmon {verdict}\n")
    if finalx is not None:
        pf.write(f"finalx {finalx}\n")
    pf.write(f"final {full}\n")
    pf.flush()


def _mesh_devices(device, shards: int | None):
    """A virtual mesh of ``shards`` copies of the card (``None`` on the
    CPU, where the facade builds its own): the facade refuses N shards
    on fewer cards unless it is handed the devices."""
    import torch

    dev = torch.device(device)
    if (shards or 1) <= 1 or dev.type != "cuda":
        return None
    return [torch.device("cuda", 0 if dev.index is None else dev.index)] * shards


def _schedule(args):
    return build_schedule(args.schedule_seed, args.events, tuple(args.reqs), args.users)


def run_child(args) -> int:
    import torch

    from ..config import DurabilityConfig
    from ..engine.batcher import GrapevineEngine

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=dev)  # the context, before the clock reads
    startup = time.time() - args.launched_at if args.launched_at else 0.0
    dcfg = DurabilityConfig(
        state_dir=args.state_dir,
        checkpoint_every_rounds=args.checkpoint_every,
        journal_fsync_every=1,
    )
    t0 = time.perf_counter()
    engine = GrapevineEngine(
        _config(args.posmap_impl, args.tree_top_cache_levels, args.pipeline_depth,
                args.evict_every, args.shards, args.geometry, args.bucket_cipher_impl),
        seed=ENGINE_SEED, device=args.device, durability=dcfg,
        mesh_devices=_mesh_devices(args.device, args.shards),
    )
    if dev.type == "cuda":
        torch.cuda.synchronize()
    recovery = time.perf_counter() - t0
    events = _schedule(args)
    shipper = None
    if args.replicate_to:
        # hot-standby chaos (--standby): this child is the PRIMARY,
        # streaming every sealed frame to the parent's replica until the
        # armed fault SIGKILLs it mid-protocol
        from ..engine.replication import JournalShipper

        shipper = JournalShipper(engine, args.replicate_to)
        shipper.start()
    monitor = _observe(engine, shipper)
    with open(args.progress, "a") as pf:
        pf.write(f"startup {startup:.6f}\n")
        pf.write(f"recovery {recovery:.6f}\n")
        pf.write(f"replayed {engine.durability.replayed}\n")
        pf.write("ready 1\n")
        pf.flush()
        _finish(engine, monitor, events, pf, args.final_masked)
        if dev.type == "cuda":
            pf.write(f"launches {json.dumps(_launch_counts(), separators=(',', ':'))}\n")
            pf.flush()
    if shipper is not None:
        shipper.close()
    engine.close()
    return 0


def oracle(schedule_seed: int, n_events: int, posmap_impl: str | None = None,
           tree_top_cache_levels: int | None = None,
           evict_every: int | None = None, *, geometry: str = "chaos",
           bucket_cipher_impl: str | None = None, reqs=(1, 4), users: int = 5,
           device=None, stats: dict | None = None, masked: bool = False):
    """Uninterrupted in-process run: per-seq hashes + final state hash.

    Always serial (pipeline_depth=1) and one device (shards=1), so a
    ``--pipeline-depth 2`` or ``--shards N`` chaos run proves the child
    recovers bit-identical to the serial one-device program. ``stats``,
    when given, receives the engine's build seconds, the schedule's wall
    seconds and, with ``masked``, the junk-masked final hash
    (``finalx``)."""
    import torch

    from ..engine.batcher import GrapevineEngine

    t0 = time.perf_counter()
    engine = GrapevineEngine(
        _config(posmap_impl, tree_top_cache_levels, pipeline_depth=1,
                evict_every=evict_every, geometry=geometry,
                bucket_cipher_impl=bucket_cipher_impl),
        seed=ENGINE_SEED, device=device,
    )
    cuda = engine.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    events = build_schedule(schedule_seed, n_events, tuple(reqs), users)
    hashes: dict[int, str] = {}
    for i, ev in enumerate(events):
        if ev[0] == "round":
            hashes[i + 1] = _resp_hash(engine.handle_queries(ev[2], ev[1]))
        else:
            engine.expire(ev[1], period=ev[2])
            hashes[i + 1] = "sweep"
    if cuda:
        torch.cuda.synchronize()
    t2 = time.perf_counter()
    final, finalx = _final_hashes(engine, masked)
    if stats is not None:
        stats.update(finalx=finalx, build_s=t1 - t0, wall_s=t2 - t1,
                     launches=_launch_counts() if cuda else {})
    return hashes, final


def _oracle_kwargs(args) -> dict:
    return dict(geometry=args.geometry, bucket_cipher_impl=args.bucket_cipher_impl,
                reqs=tuple(args.reqs), users=args.users, device=args.device,
                masked=args.final_masked)


def run_oracle_child(args) -> int:
    """``--oracle-child``: the oracle in this process; its result as JSON
    to ``--out``."""
    import torch

    if torch.device(args.device).type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=args.device)
    startup = time.time() - args.launched_at if args.launched_at else 0.0
    stats: dict = {}
    hashes, final = oracle(args.schedule_seed, args.events, args.posmap_impl,
                           args.tree_top_cache_levels, args.evict_every,
                           stats=stats, **_oracle_kwargs(args))
    with open(args.out, "w") as fh:
        json.dump(dict(stats, hashes={str(k): v for k, v in hashes.items()},
                       final=final, startup_s=startup), fh)
    return 0


def _child_flags(args) -> list[str]:
    """The flags a child needs to rebuild the parent's engine and schedule
    (and, where the comparison masks the junk bucket, to hash it so)."""
    cmd = ["--final-masked"] if args.final_masked or _masked_compare(args) else []
    cmd += ["--events", str(args.events), "--schedule-seed", str(args.schedule_seed),
           "--checkpoint-every", str(args.checkpoint_every), "--device", args.device,
           "--geometry", args.geometry, "--reqs", *map(str, args.reqs),
           "--users", str(args.users)]
    for flag, val in (("--posmap-impl", args.posmap_impl),
                      ("--tree-top-cache-levels", args.tree_top_cache_levels),
                      ("--pipeline-depth", args.pipeline_depth),
                      ("--evict-every", args.evict_every),
                      ("--shards", args.shards),
                      ("--bucket-cipher-impl", args.bucket_cipher_impl)):
        if val is not None:
            cmd += [flag, str(val)]
    return cmd


def _child_env() -> dict:
    env = dict(os.environ)
    env.pop("GRAPEVINE_FAULTS", None)
    return env


def _popen(cmd: list[str], env: dict, err_path: str) -> subprocess.Popen:
    with open(err_path, "wb") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "grapevine_tpu_torch.testing.chaos_run", *cmd,
             "--launched-at", repr(time.time())],
            env=env, cwd=REPO, stdout=subprocess.DEVNULL, stderr=err,
        )


def _tail(path: str, n: int = 2000) -> str:
    try:
        with open(path, "rb") as fh:
            return fh.read().decode(errors="replace")[-n:]
    except OSError:
        return ""


def run_oracle(args) -> dict:
    """The oracle: in this process on the CPU, in a child of its own on
    the card. Returns hashes, final, finalx (with ``--final-masked`` or a
    masked comparison) and the timings."""
    import torch

    if _masked_compare(args):
        args = argparse.Namespace(**dict(vars(args), final_masked=True))
    if torch.device(args.device).type != "cuda":
        stats: dict = {}
        t0 = time.perf_counter()
        hashes, final = oracle(args.schedule_seed, args.events, args.posmap_impl,
                               args.tree_top_cache_levels, args.evict_every,
                               stats=stats, **_oracle_kwargs(args))
        return dict(stats, hashes=hashes, final=final, startup_s=0.0,
                    total_s=time.perf_counter() - t0)
    with tempfile.TemporaryDirectory(prefix="chaos-oracle-") as d:
        out, err = os.path.join(d, "oracle.json"), os.path.join(d, "err.log")
        t0 = time.perf_counter()
        proc = _popen(["--oracle-child", "--out", out] + _child_flags(args), _child_env(),
                      err)
        try:
            rc = proc.wait(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise RuntimeError(f"oracle child ran past {CHILD_TIMEOUT_S}s: {_tail(err)}")
        if rc != 0:
            raise RuntimeError(f"oracle child exited rc={rc}: {_tail(err)}")
        with open(out) as fh:
            res = json.load(fh)
    res["hashes"] = {int(k): v for k, v in res["hashes"].items()}
    res["total_s"] = time.perf_counter() - t0
    return res


def _parse_progress(path: str):
    seq_hashes: dict[int, str] = {}
    finals, leakmons = [], []
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except FileNotFoundError:
        return seq_hashes, finals, leakmons
    for line in lines:
        parts = line.split()
        if len(parts) != 2:
            continue  # torn progress line from a mid-write kill
        tag, val = parts
        if tag == "final":
            finals.append(val)
        elif tag == "leakmon":
            leakmons.append(val)
        elif tag.isdigit():
            seq_hashes[int(tag)] = val
    return seq_hashes, finals, leakmons


def _parse_incarnations(path: str) -> list[dict]:
    """One dict per incarnation that reached ``ready``: start-up and
    recovery seconds, frames replayed, the event it started from, the
    events it recorded, and its junk-masked final hash and launches if
    it completed."""
    out: list[dict] = []
    try:
        with open(path) as fh:
            lines = fh.read().splitlines()
    except FileNotFoundError:
        return out
    cur: dict = {}
    for line in lines:
        parts = line.split()
        if len(parts) != 2:
            continue
        tag, val = parts
        if tag == "startup":
            cur = {"startup_s": float(val), "recorded": 0}
            out.append(cur)
        elif tag == "recovery":
            cur["recovery_s"] = float(val)
        elif tag == "replayed":
            cur["replayed"] = int(val)
        elif tag == "start":
            cur["start_event"] = int(val)
        elif tag.isdigit():
            cur["recorded"] = cur.get("recorded", 0) + 1
        elif tag == "promoted":
            cur["promoted"] = True
        elif tag == "finalx":
            cur["finalx"] = val
        elif tag == "launches":
            cur["launches"] = json.loads(val)
    return out


def _count_lines(path: str, tag: str) -> int:
    try:
        with open(path) as fh:
            return sum(1 for line in fh if line.split()[:1] == [tag])
    except FileNotFoundError:
        return 0


def _plan_kill(mode: str, rng: random.Random, args):
    """The kill of a trial's first launch, drawn as the reference draws
    it: ``("timer", u)`` (the fraction of the schedule's wall after the
    child is ready) or ``("fault", "point=n")``."""
    if mode == "timer":
        return ("timer", rng.uniform(0.0, 1.0))
    if mode.startswith("checkpoint."):
        cap = max(2, args.events // args.checkpoint_every)
    elif mode.startswith("flush."):
        cap = max(2, args.events // max(1, args.evict_every or 1))
    else:
        cap = max(2, args.events // 2)
    return ("fault", f"{mode}={rng.randrange(1, cap)}")


def _skip_flush(trial: int, mode: str, args) -> bool:
    if mode.startswith("flush.") and (args.evict_every or 1) <= 1:
        # the flush crash sites only exist under delayed eviction: at E=1
        # the engine never reaches them and the "trial" would be a clean
        # run masquerading as kill coverage — say so instead
        print(
            f"trial {trial:3d} [{mode:>26s}]: SKIP "
            "(evict_every=1 — no flush sites; rerun with "
            "--evict-every > 1 for kill-at-flush coverage)",
            flush=True,
        )
        return True
    return False


def _launch(cmd, env, plan, progress, err_path, args, orc) -> tuple[int, dict | None]:
    """Run one incarnation to its end; a timer plan kills it ``u`` of the
    oracle's schedule wall after its ``ready`` line. Returns the exit code
    (reaped) and where a timer kill landed."""
    ready0 = _count_lines(progress, "ready")
    proc = _popen(cmd, env, err_path)
    landed = None
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    try:
        if plan is not None and plan[0] == "timer":
            while proc.poll() is None and _count_lines(progress, "ready") == ready0:
                if time.monotonic() > deadline:
                    raise subprocess.TimeoutExpired(cmd, CHILD_TIMEOUT_S)
                time.sleep(0.01)
            if proc.poll() is None:
                delay = plan[1] * orc["wall_s"]
                try:
                    proc.wait(timeout=delay)
                except subprocess.TimeoutExpired:
                    proc.send_signal(signal.SIGKILL)
                    seqs, _, _ = _parse_progress(progress)
                    landed = dict(after_ready_s=delay, events_recorded=len(seqs),
                                  of=args.events)
        rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        if proc.poll() is None:  # timed out, or this thread was interrupted
            proc.kill()
            proc.wait()
    return rc, landed


def _verdict(trial: int, tag: str, progress: str, orc: dict, masked: bool,
             errors: list[str], what: str) -> tuple[int, int]:
    """Hold the progress file to the oracle; returns (events matched,
    events recorded)."""
    seq_hashes, finals, leakmons = _parse_progress(progress)
    matched = 0
    for seq, h in sorted(seq_hashes.items()):
        if orc["hashes"].get(seq) != h:
            errors.append(f"trial {trial} [{tag}]: responses for round {seq} "
                          "diverge from the uninterrupted run")
        else:
            matched += 1
    if masked:
        incs = _parse_incarnations(progress)
        got = incs[-1].get("finalx") if incs else None
        if got != orc["finalx"]:
            errors.append(f"trial {trial} [{tag}]: {what} state (junk bucket masked) is "
                          "not bit-identical to the uninterrupted run")
    elif not finals or finals[-1] != orc["final"]:
        errors.append(f"trial {trial} [{tag}]: {what} state is not bit-identical to the "
                      "uninterrupted run")
    if not leakmons or leakmons[-1] != "PASS":
        errors.append(f"trial {trial} [{tag}]: leak monitor verdict "
                      f"{leakmons[-1] if leakmons else 'missing'} (want PASS)")
    return matched, len(seq_hashes)


def _masked_compare(args) -> bool:
    """A sharded child against a fused oracle on the card: the fused
    kernels skip the junk bucket, the sharded path's plain scatter writes
    it."""
    import torch

    return ((args.shards or 1) > 1 and torch.device(args.device).type == "cuda"
            and (args.bucket_cipher_impl or "").startswith("pallas_fused"))


def run_trial(trial: int, mode: str, plan, args, orc: dict) -> dict:
    """One kill-recover-verify trial in restart mode, killed as ``plan``
    (:func:`_plan_kill`) says and held to ``orc`` (:func:`run_oracle`);
    returns its report (``errors`` empty on a pass)."""
    errors: list[str] = []
    rep = dict(trial=trial, mode=mode, errors=errors, kills=0, timer=None)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix=f"chaos{trial}-") as state_dir:
        progress = os.path.join(state_dir, "progress.log")
        cmd = ["--child", "--state-dir", state_dir, "--progress", progress,
               *_child_flags(args)]
        launch = 0
        while True:
            env = _child_env()
            kill = plan if launch == 0 else None
            if kill is not None and kill[0] == "fault":
                env["GRAPEVINE_FAULTS"] = kill[1]
            err_path = os.path.join(state_dir, f"err{launch}.log")
            rc, landed = _launch(cmd, env, kill, progress, err_path, args, orc)
            if landed is not None:
                rep["timer"] = landed
            if rc == 0:
                break
            if rc != -signal.SIGKILL:
                why = "timed out" if rc is None else f"exited rc={rc}"
                errors.append(f"trial {trial} [{mode}]: child {why} (want clean or "
                              f"SIGKILL): {_tail(err_path)}")
                break
            rep["kills"] += 1
            launch += 1
            if launch > MAX_RESTARTS:
                errors.append(f"trial {trial} [{mode}]: no clean run after "
                              f"{MAX_RESTARTS} restarts")
                break
        if mode == "timer" and rep["timer"] is None and not errors:
            rep["timer"] = dict(after_ready_s=None, events_recorded=args.events,
                                of=args.events, clean=True)
        rep["incarnations"] = _parse_incarnations(progress)
        if not errors:
            rep["matched"], rep["recorded"] = _verdict(
                trial, mode, progress, orc, _masked_compare(args), errors, "final recovered")
    rep["s"] = time.perf_counter() - t0
    if not errors:
        print(f"trial {trial:3d} [{mode:>26s}]: PASS ({rep['kills']} kill"
              f"{'s' if rep['kills'] != 1 else ''}, {rep['recorded']}/"
              f"{len(orc['hashes'])} rounds recorded)", flush=True)
    return rep


def run_standby_trial(trial: int, mode: str, key: bytes, plan, args,
                      orc: dict) -> dict:
    """One kill-the-primary takeover trial (``--standby``): the parent
    hosts a :class:`StandbyReplica` (serial, one device); the child
    PRIMARY ships to it and is SIGKILLed ONCE at the armed site with no
    restart; the parent promotes (fencing the dead primary's dir and
    draining its durable tail), drives the rest of the schedule on the
    promoted engine, and holds the whole run to the oracle. A revived
    incarnation of the primary on the fenced dir must be refused."""
    from ..config import DurabilityConfig
    from ..engine.journal import BatchJournal, JournalError
    from ..engine.replication import StandbyReplica

    errors: list[str] = []
    tag = f"standby:{mode}"
    rep = dict(trial=trial, mode=mode, errors=errors, kills=0, timer=None, standby=True)
    t0 = time.perf_counter()
    events = _schedule(args)
    with tempfile.TemporaryDirectory(prefix=f"chaos{trial}-") as root:
        primary_dir = os.path.join(root, "primary")
        standby_dir = os.path.join(root, "standby")
        os.makedirs(primary_dir)
        os.makedirs(standby_dir)
        progress = os.path.join(root, "progress.log")
        # primary and standby share the root seal key (a standby with its
        # own key cannot unseal a single shipped frame)
        for d in (primary_dir, standby_dir):
            kp = os.path.join(d, "root.key")
            with open(kp, "wb") as fh:
                fh.write(key)
            os.chmod(kp, 0o600)
        replica = StandbyReplica(
            _config(args.posmap_impl, args.tree_top_cache_levels, pipeline_depth=1,
                    evict_every=args.evict_every, shards=1, geometry=args.geometry,
                    bucket_cipher_impl=args.bucket_cipher_impl),
            seed=ENGINE_SEED,
            durability=DurabilityConfig(
                state_dir=standby_dir,
                checkpoint_every_rounds=args.checkpoint_every,
                journal_fsync_every=1,
            ),
            device=args.device,
        )
        try:
            port = replica.listen()
            cmd = ["--child", "--state-dir", primary_dir, "--progress", progress,
                   "--replicate-to", f"127.0.0.1:{port}", *_child_flags(args)]
            env = _child_env()
            if plan[0] == "fault":
                env["GRAPEVINE_FAULTS"] = plan[1]
            err_path = os.path.join(root, "err.log")
            rc, landed = _launch(cmd, env, plan, progress, err_path, args, orc)
            rep["timer"] = landed
            if rc not in (0, -signal.SIGKILL):
                why = "timed out" if rc is None else f"exited rc={rc}"
                errors.append(f"trial {trial} [{tag}]: primary {why} (want clean or "
                              f"SIGKILL): {_tail(err_path)}")
                rep["s"] = time.perf_counter() - t0
                return rep
            killed = rc == -signal.SIGKILL
            rep["kills"] = int(killed)
            # fenced takeover: plant the epoch fence in the dead primary's
            # dir, drain its durable tail, complete any pending flush
            info = replica.promote(primary_state_dir=primary_dir)
            rep["promote"] = dict(epoch=info["epoch"], drained=info["drained_frames"],
                                  rto_s=info["rto_seconds"])
            eng = replica.engine
            monitor = _observe(eng)
            with open(progress, "a") as pf:
                pf.write(f"startup 0\nrecovery {info['rto_seconds']:.6f}\n"
                         f"replayed {info['drained_frames']}\npromoted 1\n")
                _finish(eng, monitor, events, pf)
            # split-brain guard, live: a revived incarnation of the killed
            # primary must be refused at journal-open time
            try:
                stale = BatchJournal(primary_dir, replica.dm.root_key, replica.dm.ecfg)
                for _rec in stale.replay():
                    pass
                stale.open_for_append()
            except JournalError:
                pass
            else:
                errors.append(f"trial {trial} [{tag}]: revived stale primary was NOT "
                              "refused by the epoch fence")
        finally:
            replica.close()
        rep["incarnations"] = _parse_incarnations(progress)
        rep["matched"], rep["recorded"] = _verdict(trial, tag, progress, orc, False,
                                                   errors, "promoted final")
    rep["s"] = time.perf_counter() - t0
    if not errors:
        print(f"trial {trial:3d} [{mode:>26s}]: PASS "
              f"({'killed' if killed else 'clean'}, promoted epoch {info['epoch']}, "
              f"drained {info['drained_frames']} durable frames, rto "
              f"{info['rto_seconds'] * 1e3:.0f}ms, {rep['recorded']}/"
              f"{len(orc['hashes'])} rounds recorded)", flush=True)
    return rep


def run_trials(n_trials: int, args=None, modes=None, reports: list | None = None,
               orc: dict | None = None) -> list[str]:
    """Run ``n_trials`` randomized trials (or one per entry of ``modes``);
    returns accumulated failures. ``reports``, when given, receives one
    report per trial (kills, where a timer kill landed, incarnations with
    their start-up and recovery seconds and frames replayed, events
    matched) and, first, the oracle's (``{"oracle": ...}``); ``orc`` reuses
    an oracle already run for the same schedule and geometry."""
    from .faults import ALL_POINTS

    args = args or parse_args([])
    rng = random.Random(args.seed)
    t0 = time.monotonic()
    if orc is None:
        orc = run_oracle(args)
    print(f"oracle: {len(orc['hashes'])} events in {time.monotonic() - t0:.1f}s", flush=True)
    if reports is not None:
        reports.append({"oracle": {k: v for k, v in orc.items() if k != "hashes"}})
    if modes is None:
        modes = [rng.choice(list(ALL_POINTS) + ["timer"]) for _ in range(n_trials)]
    # every draw in trial order first, as a serial run makes them
    plans = []
    for trial, mode in enumerate(modes):
        if _skip_flush(trial, mode, args):
            continue
        key = bytes(rng.randrange(256) for _ in range(32)) if args.standby else None
        plans.append((trial, mode, key, _plan_kill(mode, rng, args)))
    if args.standby:
        reps = [run_standby_trial(t, m, k, p, args, orc) for t, m, k, p in plans]
    else:
        with ThreadPoolExecutor(max_workers=max(1, args.jobs)) as pool:
            reps = list(pool.map(lambda tp: run_trial(tp[0], tp[1], tp[3], args, orc),
                                 plans))
    failures: list[str] = []
    for r in reps:
        failures.extend(r["errors"])
    if reports is not None:
        reports.extend(reps)
    return failures


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--child", action="store_true")
    p.add_argument("--oracle-child", action="store_true",
                   help="(internal) run the oracle alone and write it to --out")
    p.add_argument("--out", default=None)
    p.add_argument("--launched-at", type=float, default=None,
                   help="(internal) the parent's clock when it started this child")
    p.add_argument("--state-dir")
    p.add_argument("--progress")
    p.add_argument("--trials", type=int, default=50)
    p.add_argument("--points", action="store_true",
                   help="one trial per fault-injection site instead of "
                   "randomized trials")
    p.add_argument("--events", type=int, default=24)
    p.add_argument("--schedule-seed", type=int, default=11)
    p.add_argument("--checkpoint-every", type=int, default=5)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--standby", action="store_true",
                   help="hot-standby takeover trials instead of restart-in-place: "
                   "the child primary ships its journal to an in-parent "
                   "StandbyReplica and is SIGKILLed once at the armed site with "
                   "no restart; the parent promotes (fenced), drives the rest of "
                   "the schedule on the promoted engine and holds the whole run "
                   "to the oracle. Prints the measured RTO per trial")
    p.add_argument("--replicate-to", default=None,
                   help="(child) ship the journal to this host:port while running")
    p.add_argument("--posmap-impl", default=None, choices=["flat", "recursive"])
    p.add_argument("--tree-top-cache-levels", type=int, default=None)
    p.add_argument("--evict-every", type=int, default=None,
                   help="delayed-eviction cadence E: the flush.pre/post_dispatch "
                   "crash sites are the kill-at-flush windows; the oracle runs "
                   "the same E (serial). Default = engine auto (1)")
    p.add_argument("--shards", type=int, default=None,
                   help="bucket-axis shard count of the child (a virtual mesh of "
                   "the card, or of CPU shards); the oracle stays on one device")
    p.add_argument("--pipeline-depth", type=int, default=None, choices=[1, 2],
                   help="round-pipeline depth of the child; the oracle always "
                   "runs serial (depth 1). Default = the engine auto (2 on the "
                   "card, 1 on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device of every engine (default the card; "
                   "'cpu' for the plain path)")
    p.add_argument("--geometry", default="chaos", choices=sorted(GEOMETRIES),
                   help="chaos: 64 messages, B=4 (the reference harness's); "
                   "small: 2^14 messages, B=64; prod: 2^20 messages, B=2048")
    p.add_argument("--bucket-cipher-impl", default=None,
                   choices=["jnp", "pallas", "pallas_fused", "pallas_fused_tiled"])
    p.add_argument("--reqs", type=int, nargs=2, default=[1, 4], metavar=("MIN", "MAX"),
                   help="requests a round, drawn from [MIN, MAX] (at most B)")
    p.add_argument("--users", type=int, default=5,
                   help="identities the schedule draws senders and recipients from")
    p.add_argument("--jobs", type=int, default=1,
                   help="restart trials run at once")
    # (internal) also hash the final state with each tree's junk bucket
    # masked: a sharded child is held to a fused oracle so
    p.add_argument("--final-masked", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    if args.child:
        return run_child(args)
    if args.oracle_child:
        return run_oracle_child(args)
    from .faults import ALL_POINTS

    modes = list(ALL_POINTS) + ["timer"] if args.points else None
    failures = run_trials(args.trials, args, modes=modes)
    for f in failures:
        print(f"CHAOS FAILURE: {f}", file=sys.stderr)
    n = len(modes) if modes else args.trials
    print(f"chaos: {n} trials, {len(failures)} failure(s)")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
