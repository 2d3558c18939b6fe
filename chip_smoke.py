"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit, from ``nvidia-smi``;
2. build the Hopper kernels from ``grapevine_tpu_torch/csrc`` (nvcc, one
   process per source, all started together);
3. every kernel against its plain PyTorch version on the card, at the
   records-tree and mailbox-tree row shapes of the production point and
   at the records and mailbox flush shapes of ``evict_every=4``
   (tolerance 0: integer outputs, the scatters' junk bucket masked; the
   kernels skip non-owner rows, so the junk bucket and its nonce must
   come out of them bit-identical), with its time, the plain version's
   time and the card's bound for the same work; the ``ptxas`` registers,
   shared memory and spills of the four row-ring launches (none may
   spill) and their launch (persistent grid, rows per step) at each
   shape. Contracts: gather+decrypt (B3 the ring one row a step, B4 one
   CTA a row), encrypt+scatter (B5 the ring one row a step, B6 up to 8),
   row cipher (B2 the ring up to 8 rows a step; also at the sweep's chunk
   shapes, into a given output);
4. the per-round slice: ``GrapevineEngine`` at 2^20 messages, 2^12
   recipients, B=2048, ``bucket_cipher_impl="pallas_fused_tiled"``
   serves a few rounds of CRUD through ``handle_queries``, every
   response checked against a dict model; B4 and B6 must launch; the
   last round runs under ``torch.profiler``;
5. the delayed-eviction slice: the same geometry at ``evict_every=4``,
   ``"pallas_fused"``, four whole windows (16 rounds, 4 flushes) of
   mixed CRUD, each response checked; B3 and B5 must launch (3 B3 per
   round, 2 B5 per flush); fetch-round and flush times apart, the
   buffer's high water, and one profiled round with its flush;
6. the ``"pallas"`` path: the same geometry at ``evict_every=1`` for a
   few rounds, each response checked; B2 must launch;
7. cross-checks at 2^14 messages, B=64: each kernel engine against the
   ``"jnp"`` (plain PyTorch) engine, same seed and requests — equal
   responses, transcripts and state (junk bucket masked) after every
   round: ``"pallas_fused_tiled"`` at ``evict_every=1``, and
   ``"pallas"``, ``"pallas_fused"``, ``"pallas_fused_tiled"`` at
   ``evict_every=4`` over three windows;
8. the expiry sweep at the production geometry, on the engines of
   phases 4 (E=1, ``"pallas_fused_tiled"``) and 5 (E=4,
   ``"pallas_fused"``, mid-window with the buffer not empty): two more
   rounds (mailboxes written at an old clock, records stamped ahead of
   the sweep's clock, updates that refresh old records), the sweep,
   checked against the model with expiry (evicted count, messages,
   recipients, every nonce the old epoch, the epoch advanced, B2 launched
   2 x 258 times and nothing else, the peak memory it added at most a few
   chunks), a profiled second sweep, a read-back of every written id
   (expired and deleted ones NOT_FOUND) and one more CRUD round;
9. durability: (a) at the production geometry (E=4, ``"pallas_fused"``)
   16 rounds, 4 flushes and a sweep journaled with an fsync per record,
   no checkpoint; a second facade on a copy of the state dir replays the
   journal on the card, with the live run's launches, and must equal the
   live engine on every leaf (junk masked) and in the generator state,
   and the next round on both must agree in responses and transcripts;
   (b) at 2^14 messages, B=64, E=4, for each ``pallas*`` impl: a
   checkpoint mid-window, more rounds, a sweep and a flush, then the
   same recovery from checkpoint plus journal, with the same checks.
   Journal append + fsync ms per record, replay ms per record and
   checkpoint write/load ms and bytes are printed;
10. the pipelined facade at the production geometry, depth 1 against
   depth 2 (``pipeline_depth``), one after the other from the same seed:
   (a) E=4 ``"pallas_fused"`` with a state dir (an fsync per record) and
   (b) E=1 ``"pallas_fused_tiled"``, each 7 ``handle_queries`` calls of
   4 full rounds (creates, updates, deletes and reads by id, every
   status checked; depth 2's last call profiled). Responses, state and (a)
   journal bytes must be equal, and a depth-1 engine recovered from
   (a)'s depth-2 state dir must equal the live one. From the third
   round on, every depth-2 dispatch runs under
   ``torch.cuda.set_sync_debug_mode("error")`` (any host sync raises;
   the admission bound's exact read, the one allowed, is counted), and
   each round records whether the round before it was still running when
   its dispatch returned. Round wall (call / 4), ops/s, span medians and
   the registry's phase p50s, and the profiled call's busy share;
11. the serving tier at the production point, E=4 ``"pallas_fused"``,
   durable (a state dir, an fsync per record), the auto pipeline depth (2
   on the card) and a fixed server clock, over loopback gRPC (the line
   names the transport, the channel's crypto backend and the r255
   backend, which must be the native library): (a) one
   ``GrapevineServer`` whose expiry loop sweeps about once a second on
   its own thread (B2; nothing expires under the fixed clock), 16 client
   sessions at once, each authenticated and running a scripted CRUD
   sequence through the encrypted channel, every response checked
   against a dict model; a forged challenge signature gets
   UNAUTHENTICATED and reaches no round (one more auth failure, no more
   rounds); a malformed envelope gets INVALID_ARGUMENT; one scrape of
   ``/metrics`` (assembly, verify, dispatch, evict, demux, journal and
   sweep samples) and ``/healthz`` (200, healthy); (b) 12 full rounds of
   B signed ops (1/8 creates, 1/32 updates, 1/32 deletes, the rest reads
   by id) from a pool of 256 identities through ``submit_nowait`` of a
   ``BatchScheduler`` at depth 2, four rounds ahead, every response
   checked; per round the host batch verify, the collector's dispatch and
   settle ms, the wall between dispatches and whether the previous round
   was still running when a dispatch returned; ops/s; and one more round
   alone under the profiler (every thread): its busy share; 3 B3 a round
   and 2 B5 a flush; (c) an ``EngineServer`` (``"pallas_fused_tiled"``,
   E=1) behind a ``FrontendServer``, 4 clients x 4 ops, each response
   checked, 3 B4 and 3 B6 a round;
12. the hot standby (``engine/replication.py``), with every launch also
   counted by the thread that made it (the standby applies frames on its
   listener thread): (a) at the production point, E=4 ``"pallas_fused"``,
   an fsync per record, depth 2, a primary ``GrapevineEngine`` ships
   through ``JournalShipper`` to a ``StandbyReplica`` on the same card
   over loopback while it runs 12 full rounds of phase 10's stream (3
   windows, 3 flushes) and a sweep; the standby catches up and equals the
   primary on every leaf and in the generator, its applies launching 3 B3
   a round, 2 B5 a flush and 516 B2 a sweep, as the primary's rounds do;
   the shipper's books (frames, bytes, every frame a legal size); the
   link is cut, 3 more rounds reach the primary's disk only, the primary
   closes, and ``promote(primary_state_dir=...)`` fences it, drains the 3
   frames (9 B3) and equals the dead primary; three doors hold (a shipped
   frame to the promoted replica, a revived primary on the fenced dir, a
   second replica's promote); then the promoted engine serves behind
   ``EngineServer(engine=...)`` and a ``FrontendServer``: 4 clients read
   back by id every message the dead primary acknowledged into their
   mailboxes and run a create, reads, an update and a delete, every
   response checked against the model. Per-frame apply ms against the
   primary's round wall, the frames trailing when the 12th round
   returned, the catch-up wait, the RTO and the memory both engines hold;
   (b) the runbook over real processes at 2^14 messages, B=64, E=1,
   ``"pallas_fused_tiled"``: ``python -m grapevine_tpu_torch.server.cli
   --role engine --device cuda --replicate-to ...`` and ``--role
   standby``; 16 signed writes acknowledged over gRPC, the primary
   SIGKILLed and the standby SIGUSR1ed, every acknowledged write read
   back from the promoted port (each wait has a wall limit); (c) at 2^14,
   B=64, E=4 ``"pallas_fused"``: the primary checkpoints before the
   standby first connects, the standby installs the shipped checkpoint on
   the card, follows 4 rounds and a sweep and equals the primary.

13. every round observer the reference attaches to a production engine
   (``obs.attach_round_observability``, the leak monitor, the adaptive
   window, the profiler gate): (a) a ``GrapevineServer`` at the
   production point, E=4 ``"pallas_fused"``, durable, depth 2, its expiry
   thread sweeping (B2), with ``leakmon``, an enforced SLO whose target is
   10 x phase 11b's median wall, ``adaptive_batch`` and
   ``profile_enable``; a 2 GiB device-to-device copy (best of 5, CUDA
   events) sets ``GRAPEVINE_COST_GBPS`` first (the cost monitor's
   bandwidth); ``start_metrics`` runs the sort and posmap calibrations
   (seconds, wall, memory added over the engine's); phase 11b's stream
   through the server's own scheduler, every response checked, the 3rd to
   10th dispatches under ``set_sync_debug_mode("error")`` with the leak
   monitor on (the transcript rides the round's copies and event), the
   expiry thread stopped before a ``/profile?ms=300`` capture around the
   12th dispatch (which flushes) holding B3 and B5, a concurrent second
   request 409; then ``/leakaudit``
   200 PASS over every round, ``/flightrec``, ``/trace`` (one round per
   seq), ``/healthz`` (SLO and leak folds), ``/metrics`` with every
   reference cost, load, SLO and trace family; a second monitor fed the
   same rounds with a fixed records leaf turns SUSPECT and its
   ``/leakaudit`` 503; the cost residual of each round, the leak
   monitor's thread CPU, and round wall, ops/s and verify beside phase
   11b's; 3 B3 a round, 2 B5 a flush, 516 B2 a sweep; (b) an
   ``EngineServer`` at 2^14, B=64, E=1 ``"pallas_fused_tiled"`` with the
   leak monitor and tracer behind a ``FrontendServer`` (phase 11c's
   clients; 3 B4 and 3 B6 a round, the same endpoint checks), and a
   ``FleetAggregator`` over (a)'s and (b)'s metrics ports: its merged
   family count, ``/healthz``, ``/leakaudit`` and lag gauges.
14. the recursive position map and the radix sort at the production
   point (``posmap_impl="recursive"``, ``sort_impl="radix"``), each slice
   run first by a flat, ``"xla"`` twin from the same seed and requests:
   (a) E=1 ``"pallas_fused_tiled"``, 7 rounds of phase 6's CRUD (3 B4
   and 3 B6 a round), the 3rd to 6th depth-2 dispatches under
   ``set_sync_debug_mode("error")``; (b) E=4 ``"pallas_fused"``, 4
   windows (3 B3 a round, 2 B5 a flush; the internal trees flush inside
   each flush); (c) phase 8 on (b)'s engines (B2 for the rows, the plain
   keystream re-keys the leaf plane). Every response is checked against
   the model and equals the twin's; the payload state (junk masked), the
   generator and each position table (``read_table``) equal the twin's
   after each part. Round, fetch-round and flush ms, the device ms of the
   ``posmap``, ``leaf_plane`` and ``oram_evict_sort`` spans beside the
   twin's, and the memory the map adds over the twin.

15. the scan vphases (``vphases_impl="scan"``: one multi-word sort a
   group question, segmented scans, no [B,B] tensor), each part run
   after a dense twin from the same seed and requests: (a) the production
   point, E=1 ``"pallas_fused_tiled"``, 7 rounds of phase 6's CRUD (3 B4
   and 3 B6 a round), the 3rd to 6th scan dispatches at depth 2 under
   ``set_sync_debug_mode("error")``; (b) E=4 ``"pallas_fused"``, 2
   windows (3 B3 a round, 2 B5 a flush); (c) B=4096 at 2^20 messages
   and 2^13 recipients (room for B new recipients, so the vectorized
   admission holds), E=1 tiled, 5 rounds. Every response is checked
   against the model and equals the twin's; the state (junk masked) and
   the generator equal the twin's. Round median and max, fetch round and
   flush at E=4, the profiled round's device ms and that of the
   ``group_sort`` and ``segmented_scan`` spans beside the twin's, and the
   peak device bytes a run allocates above what is resident, beside the
   twin's;
16. the load harness (``grapevine_tpu_torch/load``) on 15a's dense twin
   behind a ``BatchScheduler``: ``calibrate_unloaded_round``, then
   ``ramp_to_saturation`` from 0.25x the calibrated ops/s, factor 2, 4
   steps of 2 s, replayed open-loop through ``ScenarioRunner`` and graded
   by ``analyze_ramp``: each step's offered and settled ops/s, p50/p99
   latency and dispatch skew, and the knee; every settled status in
   ``OK_STATUSES``, no op of a step at or below the knee unsettled, 3 B4
   and 3 B6 a round.
17. the op-major engine (``commit="op"``: each op's three ORAM accesses
   committed before the next op; no tree-top cache, one mailbox choice,
   8192 mailbox buckets at the production point): (a) at the production
   point, ``"pallas"``, 12 rounds of mixed CRUD at B=8, then 3 at B=64
   (an engine each), every response equal byte for byte to the port's
   plain-dict ``ReferenceEngine`` replayed op by op with the engine's ids
   forced, message and recipient counts too, no stash overflow; B2
   launches 6·B a round and nothing else launches; the B=8 engine's
   dispatches 3 to 10 run under ``set_sync_debug_mode("error")``; round
   median and max, the last B=8 round profiled (device ms, kernels), the
   device memory the engine adds; (b) at 2^14, B=64, two rounds:
   op-major ``"pallas"``, ``"pallas_fused"`` and ``"pallas_fused_tiled"``
   against op-major ``"jnp"`` after every round (responses, ``[B, 3]``
   transcripts, state with the junk bucket masked). Phase 3 also holds B2
   at one access's path rows (20 x 1028 records, 13 x 6084 mailbox words),
   decrypt and encrypt, and the kernels line gives B2's op-major per-op
   time beside its bound.
18. the bucket-tree mesh (``shards``, ``parallel/mesh.py``) at the
   production point: (a) E=1 ``"pallas"``, a one-device twin runs 7
   rounds of phase 6's CRUD, then an engine sharded over a virtual mesh
   of 2 shards on ``cuda:0`` (the device repeated, ``mesh_devices``), then
   one of 4, the same seed, requests and so draws: every response equal to
   the model and to the twin's, every transcript equal, and the full
   state (shard by shard against the twin's rows, the junk bucket and the
   scratch rows masked) and generator equal after the run; B2 launches 6
   a round and nothing else (the fused kernels give way to gather →
   reduce → B2 on a mesh); the 3rd to 6th sharded dispatches under
   ``set_sync_debug_mode("error")``; round median and max, the profiled
   round's device ms and kernels, the device memory each engine adds and
   the peak a run allocates above it, beside the twin's, each shard's
   resident bytes and round traffic beside the cost model's per-shard
   bytes; (b) E=4 ``"pallas_fused"`` on 2 shards through the facade,
   durable (an fsync per record), beside a one-device twin in lockstep: 2
   windows of phase 10's stream, every status checked and every response
   equal to the twin's, the state equal after each flush and after a
   sweep, and a depth-1 one-device engine recovered from a copy of the
   state dir equal to the sharded one; (c) with two or more cards, (a) on a
   mesh across them; with one, a line saying it did not run and why.

Before each slice every launch count is set to 0, and read just after.
Each earlier line of output is one JSON object; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero before printing any result.

    python3 chip_smoke.py --standby-runbook N

runs phase 12b alone N times instead (a flake rate for the process
runbook): one line per run with its catch-up wait and the replication
link events its processes logged, a count of failures, and a non-zero
exit if any run failed.

    python3 chip_smoke.py --scan-phases

runs phases 15-16 alone after the kernel build (their lines, then the
seconds they took).

    python3 chip_smoke.py --op-phase

runs phase 17 alone after the kernel build, with B2 at the op-major
shapes first.

    python3 chip_smoke.py --mesh-phase

runs phase 18 alone after the kernel build.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import time

import torch

#: H100 SXM published peaks (NVIDIA data sheet, dense, at the 700 W
#: limit): HBM3 bandwidth, and int32 ALU throughput derived from the
#: 67 TFLOP/s float32 figure (132 SMs x 128 FP32 lanes x 2 per FMA x
#: 1.98 GHz): the SM issues int32 on 64 of its 128 lanes, one op each,
#: so 132 x 64 x 1.98e9 = 16.7e12 int32 op/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12
SEED = 7
NOW = 1_700_000_000
#: the delayed-eviction slice's window
EVICT_EVERY = 4

#: kernel name → (source, the TPU kernel it replaces)
KERNELS = {
    "cipher_rows_pallas": ("grapevine_tpu_torch/csrc/cipher_kernels.cu",
                           "grapevine_tpu/oblivious/pallas_cipher.py:89"),
    "gather_decrypt_rows": ("grapevine_tpu_torch/csrc/gather_kernels.cu",
                            "grapevine_tpu/oblivious/pallas_gather.py:89"),
    "gather_decrypt_rows_tiled": ("grapevine_tpu_torch/csrc/gather_kernels.cu",
                                  "grapevine_tpu/oblivious/pallas_gather.py:203"),
    "scatter_encrypt_rows": ("grapevine_tpu_torch/csrc/scatter_kernels.cu",
                             "grapevine_tpu/oblivious/pallas_gather.py:444"),
    "scatter_encrypt_rows_tiled": ("grapevine_tpu_torch/csrc/scatter_kernels.cu",
                                   "grapevine_tpu/oblivious/pallas_gather.py:360"),
}
#: the two scatters
SCATTERS = ("scatter_encrypt_rows", "scatter_encrypt_rows_tiled")
#: the four launches of the row ring (csrc/row_ring.cuh), by their
#: instance ring_kernel<threads, rows a step, direction>
RING = {(128, 1, 0): "scatter_encrypt_rows", (256, 8, 0): "scatter_encrypt_rows_tiled",
        (128, 1, 1): "gather_decrypt_rows", (256, 8, 2): "cipher_rows_pallas"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events),
    after one warm-up call. The stream is held busy first (a ~10 ms spin
    kernel) so every launch is queued before the first one starts: a
    kernel shorter than its wrapper's host time is timed back to back,
    not at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def keystream_ops(rows: int, row_words: int, rounds: int) -> int:
    """int32 operations of ``rows`` row keystreams: per ChaCha block,
    rounds/2 double rounds x 8 quarter-rounds x 12 ops (4 add, 4 xor,
    4 rotate) + 16 feed-forward adds."""
    nb = (row_words + 15) // 16
    return rows * nb * ((rounds // 2) * 8 * 12 + 16)


def max_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def ptxas_report(log: str) -> dict:
    """Registers, static shared memory and spills that ``ptxas -v``
    reported for each launch of the row ring (``RING``); fails if one is
    missing or spills."""
    found, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '[^']*ring_kernelILi(\d+)ELi(\d+)ELi(\d+)E",
                      line)
        if m:
            cur = found.setdefault((int(m[1]), int(m[2]), int(m[3])), {})
            continue
        if "Compiling entry function" in line:
            cur = None
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack_frame_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                       spill_load_bytes=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m[1]), static_smem_bytes=int(sm[1]) if sm else 0)
    out = {RING[inst]: dict(rep, instance="ring_kernel<{}, {}, {}>".format(*inst))
           for inst, rep in found.items() if inst in RING}
    if set(out) != set(RING.values()) or any("registers" not in r for r in out.values()):
        raise AssertionError(f"no ptxas report for every row-ring launch: {sorted(found)}")
    spills = {k: r for k, r in out.items()
              if r.get("spill_store_bytes", 0) or r.get("spill_load_bytes", 0)}
    if spills:
        raise AssertionError(f"row-ring launches spill: {spills}")
    return out


def kernel_checks(ecfg, gk, ck, path_oram, round_mod, expiry):
    """Phase 3: each kernel against its plain version, per shape. Round
    shapes: the records round B and the mailbox rounds A/C of one engine
    round; flush shapes: one records and one mailbox flush of a whole
    ``EVICT_EVERY`` window, targets deduplicated as ``oram_flush`` does;
    sweep shapes (B2): one chunk of the expiry sweep per tree."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    b = ecfg.batch_size
    rounds = ecfg.rec.cipher_rounds
    shapes = []
    for tree, cfg, nops, window in (("records", ecfg.rec, b, EVICT_EVERY),
                                    ("mailbox", ecfg.mb, b * ecfg.mb_choices,
                                     2 * EVICT_EVERY)):
        z, zv = cfg.bucket_slots, cfg.bucket_slots * cfg.value_words
        w = z + zv
        n, kc, pad = cfg.n_buckets_padded, cfg.top_cache_levels, cfg.n_buckets_padded

        def rnd(*shape):
            return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                                 device=dev, dtype=torch.int32)

        key = rnd(8)
        tree_idx, tree_val = rnd(n * z), rnd(n, zv)
        # about one bucket in eight never written (nonce (0, 0)): each
        # kernel's epoch-0 identity branch is held against the plain
        # version at these shapes too
        nonces = rnd(n, 2)
        nonces[torch.randint(0, 8, (n,), generator=gen, device=dev) == 0] = 0
        epoch = torch.tensor([5, 1], dtype=torch.int32, device=dev)

        # the round shape: one round's paths, owner columns as oram_round's
        leaves = torch.randint(0, cfg.leaves, (nops,), generator=gen,
                               device=dev).to(torch.int32)
        path_b = path_oram.path_bucket_indices(cfg, leaves)
        bmap = round_mod._bucket_owner_map(cfg, path_b.reshape(-1))
        cols = torch.arange(nops, device=dev, dtype=torch.int32)[:, None]
        owner = (bmap[path_b.long()] == cols)[:, kc:].reshape(-1).contiguous()
        flat_b = path_b[:, kc:].reshape(-1).contiguous()

        # the flush shape: a whole window's paths, deduplicated into t
        # targets (pad = unused slot); cached top buckets are not written
        t = min(window * nops * cfg.path_len, pad)
        wl = torch.randint(0, cfg.leaves, (window * nops,), generator=gen,
                           device=dev).to(torch.int32)
        uniq = torch.unique(path_oram.path_bucket_indices(cfg, wl).reshape(-1))
        tgt_b = torch.full((t,), pad, dtype=torch.int32, device=dev)
        tgt_b[:uniq.numel()] = uniq.to(torch.int32)
        f_owner = (tgt_b < pad) & (tgt_b >= cfg.cache_buckets)

        common = dict(tree=tree, row_words=w)
        # -- gather + decrypt (B3, B4) and row cipher (B2) at the round shape
        r = flat_b.shape[0]
        g_args = (key, tree_idx, tree_val, nonces, flat_b)
        ub = torch.unique(flat_b)
        uniq_rows = int(ub.numel())
        uniq_written = int((nonces[ub.long()] != 0).any(dim=1).sum())
        unwritten = int((nonces[flat_b.long()] == 0).all(dim=1).sum())
        if unwritten == 0:
            raise AssertionError(f"no never-written bucket on the {tree} paths")
        g_bytes = 4 * (uniq_rows * (w + 2) + r + r * w + 8)
        g_ops = keystream_ops(uniq_written, w, rounds) + r * w
        pi, pv = gk.gather_decrypt_rows_plain(*g_args, z=z, rounds=rounds)
        g_plain = cuda_ms(lambda: gk.gather_decrypt_rows_plain(*g_args, z=z, rounds=rounds), 3)
        for name in ("gather_decrypt_rows", "gather_decrypt_rows_tiled"):
            fn = getattr(gk, name)
            ki, kv = fn(*g_args, z=z, rounds=rounds)
            torch.cuda.synchronize()
            launch = ({"launch": gk.ring_launch_config(name, r, z, zv)}
                      if name in RING.values() else {})
            shapes.append(dict(common, kernel=name, shape="round", rows=r,
                               unique_rows=uniq_rows, unique_written_rows=uniq_written,
                               never_written_rows=unwritten,
                               max_abs_err=max(max_err(ki, pi), max_err(kv, pv)),
                               ms=cuda_ms(lambda: fn(*g_args, z=z, rounds=rounds), 20),
                               plain_ms=g_plain, bytes=g_bytes, ops=g_ops, **launch))
            del ki, kv
        # B2 decrypts the same rows, gathered first, under their nonces;
        # and, as the expiry sweep does, one chunk of contiguous tree rows
        # under their nonces into a scratch chunk (``out=``)
        rpc = expiry._chunk_rows(cfg)
        c_rows = [("round", pi, pv, flat_b, nonces[flat_b.long()].contiguous()),
                  ("sweep", tree_idx[:rpc * z].view(rpc, z), tree_val[:rpc],
                   torch.arange(rpc, dtype=torch.int32, device=dev), nonces[:rpc])]
        del pi, pv

        # -- encrypt + scatter (B5, B6) at the round and flush shapes
        for shape, fb, own in (("round", flat_b, owner), ("flush", tgt_b, f_owner)):
            rr = fb.shape[0]
            new_pidx, new_pval = rnd(rr, z), rnd(rr, zv)
            n_owned = int(own.sum())
            s_bytes = 4 * (n_owned * w + rr + n_owned * (w + 2) + 10) + rr
            s_ops = keystream_ops(n_owned, w, rounds) + n_owned * w
            want = [tree_idx.clone(), tree_val.clone(), nonces.clone()]
            s_args_p = (key, *want, fb, own, epoch, new_pidx, new_pval)
            gk.scatter_encrypt_rows_plain(*s_args_p, z=z, rounds=rounds)
            s_plain = cuda_ms(lambda: gk.scatter_encrypt_rows_plain(
                *s_args_p, z=z, rounds=rounds), 3)
            for name in SCATTERS:
                fn = getattr(gk, name)
                got = [tree_idx.clone(), tree_val.clone(), nonces.clone()]
                s_args = (key, *got, fb, own, epoch, new_pidx, new_pval)
                fn(*s_args, z=z, rounds=rounds)
                torch.cuda.synchronize()
                err = max(max_err(got[0][:-z], want[0][:-z]),
                          max_err(got[1][:-1], want[1][:-1]),
                          max_err(got[2][:-1], want[2][:-1]))
                # non-owner rows are skipped: the junk bucket keeps its bytes
                if not (torch.equal(got[0][-z:], tree_idx[-z:])
                        and torch.equal(got[1][-1], tree_val[-1])
                        and torch.equal(got[2][-1], nonces[-1])):
                    raise AssertionError(f"{name} wrote the junk bucket at the "
                                         f"{tree} {shape} shape")
                shapes.append(dict(common, kernel=name, shape=shape, rows=rr,
                                   owned_rows=n_owned, max_abs_err=err,
                                   launch=gk.ring_launch_config(name, rr, z, zv),
                                   ms=cuda_ms(lambda: fn(*s_args, z=z, rounds=rounds), 20),
                                   plain_ms=s_plain, bytes=s_bytes, ops=s_ops))
                del got, s_args
            del want, s_args_p
            if shape == "flush":
                # B2 encrypts the flush's rows under the write epoch
                c_rows.append(("flush", new_pidx, new_pval, fb,
                               epoch[None, :].expand(rr, 2).contiguous()))
            del new_pidx, new_pval
            torch.cuda.empty_cache()

        # -- row cipher (B2): the round's decrypt and the flush's encrypt
        for shape, pidx, pval, bucket, ep in c_rows:
            rr = pidx.shape[0]
            written = int((ep != 0).any(dim=1).sum())
            c_args = (key, bucket, ep, pidx, pval)
            out = ((torch.empty_like(pidx), torch.empty_like(pval)) if shape == "sweep"
                   else None)
            ki, kv = ck.cipher_rows_pallas(*c_args, rounds=rounds, out=out)
            qi, qv = ck.cipher_rows_pallas_plain(*c_args, rounds=rounds)
            torch.cuda.synchronize()
            shapes.append(dict(
                common, kernel="cipher_rows_pallas", shape=shape, rows=rr,
                never_written_rows=rr - written,
                max_abs_err=max(max_err(ki, qi), max_err(kv, qv)),
                launch=gk.ring_launch_config("cipher_rows_pallas", rr, z, zv),
                ms=cuda_ms(lambda: ck.cipher_rows_pallas(*c_args, rounds=rounds, out=out), 20),
                plain_ms=cuda_ms(lambda: ck.cipher_rows_pallas_plain(
                    *c_args, rounds=rounds), 3),
                bytes=4 * (2 * rr * w + 3 * rr + 8),
                ops=keystream_ops(written, w, rounds) + written * w))
            del ki, kv, qi, qv, out
        del c_rows, key, tree_idx, tree_val, nonces
        torch.cuda.empty_cache()
    for s in shapes:
        s["bytes_ms"] = s["bytes"] / HBM_BYTES_PER_S * 1e3
        s["ops_ms"] = s["ops"] / INT32_OPS_PER_S * 1e3
        s["bound_ms"] = max(s["bytes_ms"], s["ops_ms"])
        if s["max_abs_err"] != 0:
            raise AssertionError(f"{s['kernel']} differs from its plain version "
                                 f"at the {s['tree']} {s['shape']} shape")
    return shapes


#: what each kernel's headline numbers sum: (path, [(tree, shape, calls)])
PER = {
    "cipher_rows_pallas": ("engine round, 'pallas' (decrypt + encrypt)",
                           [("records", "round", 2), ("mailbox", "round", 4)]),
    "gather_decrypt_rows": ("engine round, 'pallas_fused'",
                            [("records", "round", 1), ("mailbox", "round", 2)]),
    "gather_decrypt_rows_tiled": ("engine round, 'pallas_fused_tiled'",
                                  [("records", "round", 1), ("mailbox", "round", 2)]),
    "scatter_encrypt_rows": (f"flush of an evict_every={EVICT_EVERY} window, "
                             "'pallas_fused'",
                             [("records", "flush", 1), ("mailbox", "flush", 1)]),
    "scatter_encrypt_rows_tiled": ("engine round, 'pallas_fused_tiled'",
                                   [("records", "round", 1), ("mailbox", "round", 2)]),
}


def kernel_entries(shapes, launches, sweep_chunks: dict, op_launches: int):
    """One entry per kernel: its headline time, plain time and bound sum
    the calls ``PER`` names; ``shapes`` keeps every per-call measurement.
    B2's entry adds the expiry sweep's path (``sweep_chunks``: chunks
    per tree) and the op-major engine's (``op_launches`` in phase 17)."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        per, calls = PER[name]
        mine = [s for s in shapes if s["kernel"] == name]
        pick = {(s["tree"], s["shape"]): s for s in mine}
        ms = sum(c * pick[(t, sh)]["ms"] for t, sh, c in calls)
        plain = sum(c * pick[(t, sh)]["plain_ms"] for t, sh, c in calls)
        bytes_ms = sum(c * pick[(t, sh)]["bytes_ms"] for t, sh, c in calls)
        ops_ms = sum(c * pick[(t, sh)]["ops_ms"] for t, sh, c in calls)
        entry = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(s["max_abs_err"] for s in mine),
            ms=ms, plain_ms=plain, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None, per=per,
            shapes=[{k: v for k, v in s.items() if k not in ("kernel", "bytes", "ops")}
                    for s in mine],
        )
        if name == "cipher_rows_pallas":
            # the expiry sweep: each chunk decrypted and re-encrypted
            calls = [(t, 2 * n) for t, n in sweep_chunks.items()]
            sb = sum(c * pick[(t, "sweep")]["bytes_ms"] for t, c in calls)
            so = sum(c * pick[(t, "sweep")]["ops_ms"] for t, c in calls)
            entry["sweep"] = dict(
                per="expiry sweep, both trees (decrypt + re-encrypt each chunk)",
                launches=sum(c for _, c in calls),
                ms=sum(c * pick[(t, "sweep")]["ms"] for t, c in calls),
                plain_ms=sum(c * pick[(t, "sweep")]["plain_ms"] for t, c in calls),
                bound_ms=max(sb, so), bound_by="bytes" if sb >= so else "operations")
            # the op-major engine: per op, the records access decrypts and
            # re-encrypts its path once, the two mailbox accesses twice
            calls = [(t, sh, 1 if t == "records" else 2) for t in ("records", "mailbox")
                     for sh in ("op_decrypt", "op_encrypt")]
            ob = sum(c * pick[(t, sh)]["bytes_ms"] for t, sh, c in calls)
            oo = sum(c * pick[(t, sh)]["ops_ms"] for t, sh, c in calls)
            entry["op_major"] = dict(
                per="op-major engine, one op (3 accesses, decrypt + re-encrypt each)",
                launches=op_launches, launches_per_op=sum(c for *_, c in calls),
                ms=sum(c * pick[(t, sh)]["ms"] for t, sh, c in calls),
                plain_ms=sum(c * pick[(t, sh)]["plain_ms"] for t, sh, c in calls),
                bound_ms=max(ob, oo), bound_by="bytes" if ob >= oo else "operations")
        out.append(entry)
    return out


def _key(tag: str, i: int) -> bytes:
    return (tag.encode() + i.to_bytes(4, "little")).ljust(32, b"\x5a")


def _payload(tag: int, i: int) -> bytes:
    import grapevine_tpu_torch.wire.constants as C

    return (tag.to_bytes(2, "little") + i.to_bytes(4, "little")).ljust(
        C.PAYLOAD_SIZE, bytes([tag & 0xFF]))


def run_slice(eng, n_rounds: int, writes: bool, profile_last: bool):
    """CRUD rounds through ``handle_queries``, each response checked
    against a dict model of what was written. Rounds 1-4 are scripted
    (creates, reads, updates, deletes, zero-id reads and deletes,
    refusals); later rounds read by id over every live message, and with
    ``writes`` also create, update and delete (write targets distinct
    within a round, so the model's order is the slot order). Returns
    per-round stats, the health after the run, the profile of the last
    round if ``profile_last``, the model (msg_id → sender, recipient,
    payload and the timestamp of its last write) and the deleted ids."""
    import numpy as np

    from grapevine_tpu_torch.wire import constants as C

    b = eng.ecfg.batch_size
    # recipients 0..nrec-1, b/nrec messages each; message A of recipient r
    # is created in slot r, message B in slot r + nrec (A is older). A
    # light mailbox-table load keeps every in-round claim admitted.
    nrec = b // 8
    sender = [_key("snd", i) for i in range(b)]
    recip = [_key("rcp", i % nrec) for i in range(b)]
    stranger = _key("zzz", 0)
    zero = bytes(16)
    model: dict[bytes, dict] = {}  # msg_id → {"sender", "recipient", "payload", "ts"}
    gone: set[bytes] = set()  # deleted msg_ids
    ids: list[bytes] = []
    rounds: list[dict] = []
    # collect the earlier phases' garbage (a profiler trace holds many
    # cyclic objects) before the timed rounds, or an oldest-generation
    # pass inside one of them pays for it
    gc.collect()
    tracked = len(gc.get_objects())
    OK, NF = C.STATUS_CODE_SUCCESS, C.STATUS_CODE_NOT_FOUND

    def rec(mid):
        """The record a response must carry for ``mid``, as modelled now."""
        m = model[mid]
        return (mid, m["sender"], m["recipient"], m["payload"])

    def run(reqs, expect, now):
        # host-side suspects for a slow round, counted around it: the
        # interpreter's oldest-generation collections and the CUDA
        # allocator's new segments (each a cudaMalloc)
        gc0, gs0, seg0 = host_counters()
        t0 = time.perf_counter()
        resp = eng.handle_queries(reqs, now)
        dt = time.perf_counter() - t0
        gc1, gs1, seg1 = host_counters()
        rounds.append(dict(ops=len(reqs), s=dt, health=eng.health(),
                           gc_gen2=gc1 - gc0, gc_gen2_ms=(gs1 - gs0) * 1e3,
                           cuda_segments=seg1 - seg0))
        check_responses(resp, expect, f"round {len(rounds)}")
        return resp

    q = nrec // 4  # a quarter of the recipients
    A = list(range(nrec))  # slot of message A of recipient r
    Bm = list(range(nrec, 2 * nrec))  # slot of message B of recipient r

    # round 1: B creates, b/nrec messages for each recipient
    pays = [_payload(1, i) for i in range(b)]
    resp = run([_req(C.REQUEST_TYPE_CREATE, sender[i], recip[i], payload=pays[i])
                for i in range(b)], [(OK, None)] * b, NOW)
    for i, r in enumerate(resp):
        ids.append(r.record.msg_id)
        model[r.record.msg_id] = dict(sender=sender[i], recipient=recip[i], payload=pays[i],
                                      ts=NOW)
    if len(set(ids)) != b or zero in ids:
        raise AssertionError("created msg_ids are not distinct and nonzero")

    # round 2: per quarter of recipients — read A, update A, delete A,
    # zero-id read (→ A, the oldest); plus zero-id reads by strangers
    g = [list(range(k * q, (k + 1) * q)) for k in range(4)]
    reqs, exp = [], []
    for r in g[0]:
        reqs.append(_req(C.REQUEST_TYPE_READ, sender[A[r]], mid=ids[A[r]]))
        exp.append((OK, rec(ids[A[r]])))
    upd = {}
    for r in g[1]:
        upd[r] = _payload(2, r)
        reqs.append(_req(C.REQUEST_TYPE_UPDATE, sender[A[r]], recip[A[r]],
                        ids[A[r]], upd[r]))
        exp.append((OK, None))
    for r in g[2]:
        reqs.append(_req(C.REQUEST_TYPE_DELETE, recip[A[r]], recip[A[r]], ids[A[r]]))
        exp.append((OK, rec(ids[A[r]])))
    for r in g[3]:
        reqs.append(_req(C.REQUEST_TYPE_READ, recip[A[r]], recip[A[r]]))
        exp.append((OK, rec(ids[A[r]])))
    while len(reqs) < b:
        reqs.append(_req(C.REQUEST_TYPE_READ, _key("nob", len(reqs))))
        exp.append((NF, None))
    run(reqs, exp, NOW + 1)
    for r in g[1]:
        model[ids[A[r]]].update(payload=upd[r], ts=NOW + 1)
    for r in g[2]:
        del model[ids[A[r]]]
        gone.add(ids[A[r]])

    # round 3: read A back (original / updated / deleted → NOT_FOUND),
    # zero-id delete (pops A), read every B by its sender
    reqs, exp = [], []
    for r in g[0] + g[1]:
        reqs.append(_req(C.REQUEST_TYPE_READ, recip[A[r]], mid=ids[A[r]]))
        exp.append((OK, rec(ids[A[r]])))
    for r in g[2]:
        reqs.append(_req(C.REQUEST_TYPE_READ, recip[A[r]], mid=ids[A[r]]))
        exp.append((NF, None))
    for r in g[3]:
        reqs.append(_req(C.REQUEST_TYPE_DELETE, recip[A[r]], recip[A[r]]))
        exp.append((OK, rec(ids[A[r]])))
    for r in range(nrec):
        reqs.append(_req(C.REQUEST_TYPE_READ, sender[Bm[r]], mid=ids[Bm[r]]))
        exp.append((OK, rec(ids[Bm[r]])))
    run(reqs, exp, NOW + 2)
    for r in g[3]:
        del model[ids[A[r]]]
        gone.add(ids[A[r]])

    # round 4 (half full: padded): zero-id reads now select B where A is
    # gone; strangers are refused; a wrong recipient on update is refused
    reqs, exp = [], []
    for r in g[2] + g[3]:
        reqs.append(_req(C.REQUEST_TYPE_READ, recip[Bm[r]], recip[Bm[r]]))
        exp.append((OK, rec(ids[Bm[r]])))
    for r in g[0]:
        reqs.append(_req(C.REQUEST_TYPE_READ, stranger, mid=ids[A[r]]))
        exp.append((NF, None))
    for r in g[1]:
        reqs.append(_req(C.REQUEST_TYPE_UPDATE, sender[Bm[r]], stranger, ids[Bm[r]],
                        _payload(3, r)))
        exp.append((C.STATUS_CODE_INVALID_RECIPIENT, None))
    run(reqs, exp, NOW + 3)

    # rounds 5..n: full rounds over every live message
    rng = np.random.default_rng(SEED)
    prof = None
    for k in range(4, n_rounds):
        live = list(model)
        perm = [live[i] for i in rng.permutation(len(live))]
        nw = b // 8 if writes else 0
        upd_ids, del_ids, read_ids = perm[:nw], perm[nw:2 * nw], perm[2 * nw:]
        reqs, exp, post = [], [], []
        for j in range(b):
            kind = j % 8 if writes else 7
            if kind == 0:  # create for an existing recipient
                r = (j // 8 + k) % nrec
                pay = _payload(16 + k, j)
                reqs.append(_req(C.REQUEST_TYPE_CREATE, sender[j], recip[r], payload=pay))
                exp.append((OK, None))
                post.append((j, sender[j], recip[r], pay))
            elif kind == 1:  # update by its sender
                mid = upd_ids[j // 8]
                pay = _payload(48 + k, j)
                m = model[mid]
                reqs.append(_req(C.REQUEST_TYPE_UPDATE, m["sender"], m["recipient"],
                                mid, pay))
                exp.append((OK, None))
                m.update(payload=pay, ts=NOW + k)
            elif kind == 2:  # delete by its recipient
                mid = del_ids[j // 8]
                m = model[mid]
                reqs.append(_req(C.REQUEST_TYPE_DELETE, m["recipient"], m["recipient"], mid))
                exp.append((OK, rec(mid)))
                del model[mid]
                gone.add(mid)
            else:  # read by id by its recipient
                mid = read_ids[(j * 7 + k) % len(read_ids)]
                reqs.append(_req(C.REQUEST_TYPE_READ, model[mid]["recipient"], mid=mid))
                exp.append((OK, rec(mid)))
        if profile_last and k == n_rounds - 1:
            prof = profile_round(lambda: run(reqs, exp, NOW + k))
            resp = prof.pop("result")
            rounds[-1]["profiled"] = True
            gc.collect()
        else:
            resp = run(reqs, exp, NOW + k)
        for j, snd, rcp, pay in post:
            model[resp[j].record.msg_id] = dict(sender=snd, recipient=rcp, payload=pay,
                                                ts=NOW + k)

    if eng.message_count() != len(model):
        raise AssertionError(f"engine holds {eng.message_count()} messages, "
                             f"model {len(model)}")
    h = eng.health()
    if h["stash_overflow"] != 0:
        raise AssertionError(f"stash overflow {h['stash_overflow']}")
    rounds[0]["gc_tracked_objects_at_start"] = tracked
    return rounds, h, prof, model, gone


class Gen2Clock:
    """Host seconds spent in the interpreter's oldest-generation
    collections, timed by a ``gc`` callback while installed."""

    def __init__(self):
        self.seconds = 0.0
        self._t0 = 0.0

    def __call__(self, phase, info):
        if info["generation"] == 2:
            if phase == "start":
                self._t0 = time.perf_counter()
            else:
                self.seconds += time.perf_counter() - self._t0


GEN2 = Gen2Clock()


def host_counters() -> tuple[int, float, int]:
    """(oldest-generation collections so far, seconds in them while
    ``GEN2`` is installed, CUDA segments allocated so far)."""
    return (gc.get_stats()[2]["collections"], GEN2.seconds,
            torch.cuda.memory_stats().get("segment.all.allocated", 0))


#: the round's and the flush's record_function spans (the reference's
#: device_phase names)
#: the recursive position map's spans: the internal ORAM round, the leaf
#: plane's keystream, and the eviction sort (radix or the comparison sort)
POSMAP_SPANS = ("posmap", "leaf_plane", "oram_evict_sort")
#: the grouping sorts and the segmented scans (``oblivious/segmented.py``)
#: — every one a scan round runs, and the admission walk's under dense
SCAN_SPANS = ("group_sort", "segmented_scan")
SPANS = ("engine_step", "round_a_mailbox", "round_b_records", "round_c_mailbox", "oram_fetch",
         "oram_apply", "oram_evict", "oram_writeback", "respond", "engine_flush",
         "oram_flush", "sweep_records", "sweep_mailbox") + POSMAP_SPANS + SCAN_SPANS


def profile_round(fn, all_threads: bool = False) -> dict:
    """Run ``fn`` (one engine round, and its flush if the window closes)
    under torch.profiler: device time per span (the record_function
    ranges) and per kernel, and the device's busy share of the wall time
    (kernel time summed; one stream, so kernels do not overlap). The
    result of ``fn`` is returned under ``"result"``. With ``all_threads``
    the profiler records every thread's ops (the scheduler's collector
    thread dispatches the round), not only the caller's. The session is
    the process's one live capture (``obs.profiler.exclusive_profile``), so
    it can never overlap phase 13's profiler gate."""
    from torch.autograd import DeviceType

    from grapevine_tpu_torch.obs.profiler import exclusive_profile

    torch.cuda.synchronize()
    with exclusive_profile("cuda", all_threads=all_threads, acc_events=True) as prof:
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    spans = {e.key: e.device_time_total / 1e3 for e in ev if e.key in SPANS}
    # the facade's phase timers are record_function ranges too
    # ("grapevine/<phase>"): ranges, not kernels
    kernels = sorted((e for e in ev if e.key not in SPANS
                      and not e.key.startswith("grapevine/")),
                     key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return dict(
        wall_ms=wall_ms, device_ms=device_ms,
        device_busy_share=device_ms / wall_ms,
        device_kernels=sum(e.count for e in kernels),
        span_device_ms=spans,
        top_kernels=[dict(name=e.key[:90], ms=e.self_device_time_total / 1e3,
                          count=e.count) for e in kernels[:12]],
        result=result,
    )


def slice_stats(cfg, rounds, health, init_s, launches, card) -> dict:
    """The slice line's common part: round times (the first round, which
    pays one-time set-up, and profiled rounds excluded from the steady
    statistics), throughput and memory."""
    timed = [r for r in rounds if not r.get("profiled")]
    round_ms = [r["s"] * 1e3 for r in timed]
    steady = timed[1:]
    steady_ms = sorted(round_ms[1:])
    return dict(
        slice=dict(max_messages=cfg.max_messages, max_recipients=cfg.max_recipients,
                   batch_size=cfg.batch_size, bucket_cipher_impl=cfg.bucket_cipher_impl,
                   evict_every=cfg.evict_every or 1),
        init_s=init_s, rounds=len(rounds), ops=sum(r["ops"] for r in rounds),
        ops_per_s=sum(r["ops"] for r in steady) / sum(r["s"] for r in steady),
        first_round_ms=round_ms[0], round_ms=round_ms,
        median_round_ms=statistics.median(steady_ms),
        p99_round_ms=steady_ms[min(len(steady_ms) - 1, int(0.99 * len(steady_ms)))],
        mem_allocated_bytes=torch.cuda.memory_allocated(),
        max_mem_allocated_bytes=torch.cuda.max_memory_allocated(),
        launches=launches,
        launches_per_round={k: v / len(rounds) for k, v in launches.items()},
        messages=health["messages"], recipients=health["recipients"],
        stash_occupancy=health["stash_occupancy"],
        stash_overflow=health["stash_overflow"], card=card,
        slowest_steady_round={k: v for k, v in max(steady, key=lambda r: r["s"]).items()
                              if k != "health"},
        gc_tracked_objects_at_start=rounds[0]["gc_tracked_objects_at_start"],
        rounds_with_gc_gen2=[i for i, r in enumerate(rounds) if r["gc_gen2"]],
        rounds_with_new_cuda_segments=[i for i, r in enumerate(rounds)
                                       if r["cuda_segments"]],
    )


def _reset_launches(gk, ck) -> None:
    gk.reset_launches()
    ck.reset_launches()


def _launches(gk, ck) -> dict:
    return {**gk.LAUNCHES, **ck.LAUNCHES}


def require_launches(launches: dict, want: dict, path: str) -> None:
    """Each kernel of ``want`` launched exactly that many times on the
    path, and no kernel outside it launched."""
    for name, n in launches.items():
        if n != want.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {n} times, "
                                 f"expected {want.get(name, 0)}")


def run_evict_slice(GrapevineEngine, cfg, gk, ck, card, windows: int = 4):
    """Phase 5: ``windows`` windows of mixed CRUD at ``evict_every=EVICT_EVERY``;
    fetch rounds and flushes timed apart (each flush between two
    synchronizations, taken out of its round's wall time). Returns the
    slice line, the profile, the launches, and the engine with its model
    and deleted ids (phase 8 sweeps it)."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = GrapevineEngine(cfg, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    flush_s: list[float] = []
    flush = eng._flush_step

    def timed_flush(ecfg, state):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = flush(ecfg, state)
        torch.cuda.synchronize()
        flush_s.append(time.perf_counter() - t)
        return out

    eng._flush_step = timed_flush
    n_rounds = windows * EVICT_EVERY
    _reset_launches(gk, ck)
    rounds, health, prof, model, gone = run_slice(eng, n_rounds, writes=True,
                                                  profile_last=True)
    launches = _launches(gk, ck)
    require_launches(launches, {"gather_decrypt_rows": 3 * n_rounds,
                                "scatter_encrypt_rows": 2 * (n_rounds // EVICT_EVERY)},
                     "evict slice")
    if eng.flushes != n_rounds // EVICT_EVERY or len(flush_s) != eng.flushes:
        raise AssertionError(f"{eng.flushes} flushes in {n_rounds} rounds")
    # a closing round's wall time holds its flush: take it out
    fi = iter(flush_s)
    fetch_ms = []
    for i, r in enumerate(rounds):
        f = next(fi) if (i + 1) % EVICT_EVERY == 0 else 0.0
        r["fetch_s"] = r["s"] - f
        if i > 0 and not r.get("profiled"):
            fetch_ms.append(r["fetch_s"] * 1e3)
    timed_flush_ms = [s * 1e3 for s in flush_s[:-1]]  # the last one is profiled
    occ = [r["health"]["evict_buffer_occupancy"] for r in rounds]
    line = slice_stats(cfg, rounds, health, init_s, launches, card)
    line.update(
        rounds_total=n_rounds, flushes=eng.flushes,
        median_fetch_round_ms=statistics.median(fetch_ms),
        fetch_round_ms=fetch_ms,
        flush_ms=timed_flush_ms,
        median_flush_ms=statistics.median(timed_flush_ms),
        amortised_flush_ms_per_round=statistics.median(timed_flush_ms) / EVICT_EVERY,
        launches_per_round={"gather_decrypt_rows": launches["gather_decrypt_rows"] / n_rounds},
        launches_per_flush={"scatter_encrypt_rows":
                            launches["scatter_encrypt_rows"] / eng.flushes},
        evict_buffer_high_water={t: max(o[t] for o in occ) for t in ("rec", "mb")},
        evict_buffer_slots=health["evict_buffer_slots"],
    )
    eng._flush_step = flush
    return line, prof, launches, eng, model, gone


def mixed_requests(rng, users, created, rnd: int, n: int | None = None) -> list:
    """One round of ``n`` ops (default 64 or 50) over ``users``: creates,
    reads, updates and deletes of ``created`` ids, zero-id reads and
    deletes of the caller's own mailbox."""
    from grapevine_tpu_torch.wire import constants as C

    reqs = []
    for i in range(n if n is not None else 64 if rnd % 2 == 0 else 50):
        a, r = users[rng.integers(len(users))], users[rng.integers(len(users))]
        x = rng.random()
        if rnd == 0 or x < 0.35 or not created:
            t, mid = C.REQUEST_TYPE_CREATE, bytes(16)
        elif x < 0.8:
            t = (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_UPDATE,
                 C.REQUEST_TYPE_DELETE)[rng.integers(3)]
            mid, a, r = created[rng.integers(len(created))]
        else:
            t, mid, a = (C.REQUEST_TYPE_READ, C.REQUEST_TYPE_DELETE)[
                rng.integers(2)], bytes(16), r
        reqs.append(_req(t, a, r, mid, _payload(rnd, i)))
    return reqs


def note_created(reqs, resp, created: list) -> None:
    from grapevine_tpu_torch.wire import constants as C

    for q, r in zip(reqs, resp):
        if q.request_type == C.REQUEST_TYPE_CREATE and r.status_code == C.STATUS_CODE_SUCCESS:
            created.append((r.record.msg_id, q.auth_identity, q.record.recipient))


def cross_check(GrapevineConfig, GrapevineEngine, convert, impls, evict_every: int,
                n_rounds: int, device="cuda", commit: str = "phase"):
    """Phase 7 (and 17b with ``commit="op"``): each kernel engine ≡ the
    plain ("jnp") engine on the card, after every round: responses,
    transcripts, state (junk masked)."""
    import numpy as np

    engines = {
        impl: GrapevineEngine(GrapevineConfig(
            max_messages=2**14, max_recipients=2**10, batch_size=64,
            bucket_cipher_impl=impl, vphases_impl="dense", evict_every=evict_every,
            commit=commit),
            seed=SEED, device=device)
        for impl in ("jnp", *impls)
    }
    rng = np.random.default_rng(SEED)
    users = [_key("usr", i) for i in range(24)]
    created: list = []
    for rnd in range(n_rounds):
        reqs = mixed_requests(rng, users, created, rnd)
        outs = {impl: e.handle_queries_with_transcript(reqs, NOW + rnd)
                for impl, e in engines.items()}
        rj, tj = outs["jnp"]
        sj = convert.to_numpy(engines["jnp"].state)
        for impl in impls:
            rk, tk = outs[impl]
            if [x.pack() for x in rk] != [x.pack() for x in rj]:
                raise AssertionError(f"cross-check {impl} E={evict_every} round "
                                     f"{rnd}: responses differ")
            if not np.array_equal(tk, tj):
                raise AssertionError(f"cross-check {impl} E={evict_every} round "
                                     f"{rnd}: transcripts differ")
            diff = convert.first_difference(convert.to_numpy(engines[impl].state),
                                            sj, mask_junk=True)
            if diff is not None:
                raise AssertionError(f"cross-check {impl} E={evict_every} round "
                                     f"{rnd}: state differs at {diff}")
        note_created(reqs, rj, created)
    flushes = {impl: getattr(e, "flushes", 0) for impl, e in engines.items()}
    if evict_every > 1 and set(flushes.values()) != {n_rounds // evict_every}:
        raise AssertionError(f"cross-check flush counts {flushes}")
    return dict(impls=list(impls), evict_every=evict_every, commit=commit,
                rounds=n_rounds, flushes=flushes["jnp"],
                messages=engines["jnp"].message_count(), equal=True)


#: phase 8's sweep clock: records last written before NOW + 6 expire,
#: those written later survive, and so do those stamped ahead of it
SWEEP_NOW, SWEEP_PERIOD = NOW + 100, 94


def _req(t, auth, rcp=bytes(32), mid=bytes(16), payload=None):
    from grapevine_tpu_torch.wire import constants as C
    from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

    return QueryRequest(request_type=t, auth_identity=auth, record=RequestRecord(
        msg_id=mid, recipient=rcp,
        payload=payload if payload is not None else bytes(C.PAYLOAD_SIZE)))


def check_responses(resp, expect, where: str) -> None:
    """Each response's status, and record where one is expected
    ``(msg_id, sender, recipient, payload)``, against the model."""
    for i, (r, (status, want)) in enumerate(zip(resp, expect)):
        if r.status_code != status:
            raise AssertionError(f"{where} op {i}: status {r.status_code}, "
                                 f"expected {status}")
        got = (r.record.msg_id, r.record.sender, r.record.recipient, r.record.payload)
        if want is not None and got != want:
            raise AssertionError(f"{where} op {i}: record differs from the model")


def _expired(ts: int) -> bool:
    """The reference oracle's rule: ``now - ts > period``, signed (a record
    stamped ahead of the clock never expires)."""
    return SWEEP_NOW - ts > SWEEP_PERIOD


def run_expiry_phase(eng, model: dict, gone: set, gk, ck, card, label: str) -> dict:
    """Phase 8 on a slice's engine at the production geometry: two more
    rounds (mailboxes written only at an old clock, records stamped ahead
    of the sweep's clock, old records refreshed by updates; under delayed
    eviction they leave the window half full), the sweep, checked against
    the model with expiry; then a profiled second sweep, a read-back of
    every written id and one more CRUD round."""
    from grapevine_tpu_torch.engine.expiry import _chunk_rows
    from grapevine_tpu_torch.oblivious.bucket_cipher import epoch_next
    from grapevine_tpu_torch.wire import constants as C

    OK, NF = C.STATUS_CODE_SUCCESS, C.STATUS_CODE_NOT_FOUND
    ecfg = eng.ecfg
    b = ecfg.batch_size
    # a round at an old clock: 64 recipients nothing else writes, 2 each
    lonely = [_key("lon", i) for i in range(64)]
    reqs = [_req(C.REQUEST_TYPE_CREATE, _key("snd", i), lonely[i // 2],
                 payload=_payload(90, i)) for i in range(128)]
    resp = eng.handle_queries(reqs, NOW + 2)
    check_responses(resp, [(OK, None)] * len(reqs), f"{label} old-clock round")
    for q, r in zip(reqs, resp):
        model[r.record.msg_id] = dict(sender=q.auth_identity, recipient=q.record.recipient,
                                      payload=q.record.payload, ts=NOW + 2)
    # a round ahead of the sweep's clock: 64 new mailboxes, and updates
    # that refresh 64 records which would otherwise expire
    ahead = NOW + 200
    fut = [_key("fut", i) for i in range(64)]
    reqs = [_req(C.REQUEST_TYPE_CREATE, _key("snd", i), fut[i], payload=_payload(91, i))
            for i in range(64)]
    old = [mid for mid, m in model.items()
           if _expired(m["ts"]) and m["recipient"] not in set(lonely)][:64]
    upd = {}
    for i, mid in enumerate(old):
        m = model[mid]
        upd[mid] = _payload(92, i)
        reqs.append(_req(C.REQUEST_TYPE_UPDATE, m["sender"], m["recipient"], mid, upd[mid]))
    resp = eng.handle_queries(reqs, ahead)
    check_responses(resp, [(OK, None)] * len(reqs), f"{label} ahead-of-clock round")
    for q, r in zip(reqs[:64], resp[:64]):
        model[r.record.msg_id] = dict(sender=q.auth_identity, recipient=q.record.recipient,
                                      payload=q.record.payload, ts=ahead)
    for mid, pay in upd.items():
        model[mid].update(payload=pay, ts=ahead)
    h0 = eng.health()
    buffered = (sum(h0["evict_buffer_occupancy"].values()) if eng.evict_every > 1 else None)
    if eng.evict_every > 1 and not (buffered and h0["evict_rounds_since_flush"]):
        raise AssertionError(f"{label}: the sweep must run mid-window with the buffer "
                             f"not empty ({h0})")

    expired = {mid for mid, m in model.items() if _expired(m["ts"])}
    emptied = ({m["recipient"] for m in model.values()}
               - {m["recipient"] for mid, m in model.items() if mid not in expired})
    if not expired or len(expired) == len(model) or not emptied:
        raise AssertionError(f"{label}: the clock expires {len(expired)} of "
                             f"{len(model)} records, empties {len(emptied)} mailboxes")
    st = eng.state
    old_ep = (st.rec.epoch.clone(), st.mb.epoch.clone())
    n_chunks = {t: cfg.n_buckets_padded // _chunk_rows(cfg)
                for t, cfg in (("records", ecfg.rec), ("mailbox", ecfg.mb))}
    del st
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches(gk, ck)
    t0 = time.perf_counter()
    evicted = eng.expire(SWEEP_NOW, SWEEP_PERIOD)
    torch.cuda.synchronize()
    sweep_ms = (time.perf_counter() - t0) * 1e3
    launches = _launches(gk, ck)
    peak_added = torch.cuda.max_memory_allocated() - base
    require_launches(launches, {"cipher_rows_pallas": 2 * sum(n_chunks.values())},
                     f"{label} sweep")
    for mid in expired:
        del model[mid]
    if evicted != len(expired):
        raise AssertionError(f"{label}: the sweep evicted {evicted}, the model {len(expired)}")
    if eng.message_count() != len(model):
        raise AssertionError(f"{label}: {eng.message_count()} messages, model {len(model)}")
    recips = len({m["recipient"] for m in model.values()})
    if eng.recipient_count() != recips:
        raise AssertionError(f"{label}: {eng.recipient_count()} recipients, model {recips}")
    st = eng.state
    for name, o, ep in (("rec", st.rec, old_ep[0]), ("mb", st.mb, old_ep[1])):
        if not bool((o.nonces == ep).all()):
            raise AssertionError(f"{label}: {name}.nonces are not all the old epoch")
        if not torch.equal(o.epoch, epoch_next(ep)):
            raise AssertionError(f"{label}: {name}.epoch did not advance")
    del st
    chunk_bytes = max(4 * _chunk_rows(c) * c.row_words for c in (ecfg.rec, ecfg.mb))
    tree_bytes = 4 * ecfg.rec.n_buckets_padded * ecfg.rec.row_words
    if peak_added > 4 * chunk_bytes:
        raise AssertionError(f"{label}: the sweep added {peak_added} bytes at its peak, "
                             f"more than 4 chunks ({chunk_bytes} bytes each)")
    # a second sweep at the same clock expires nothing more: profiled
    prof = profile_round(lambda: eng.expire(SWEEP_NOW, SWEEP_PERIOD))
    if prof.pop("result") != 0:
        raise AssertionError(f"{label}: the second sweep evicted records")

    # read back every written id: the live ones by their recipient, the
    # expired and the deleted ones NOT_FOUND
    reads = [(mid, OK) for mid in model] + [(mid, NF) for mid in expired | gone]
    by_id = {**model}
    for lo in range(0, len(reads), b):
        chunk = reads[lo:lo + b]
        reqs, exp = [], []
        for mid, status in chunk:
            m = by_id.get(mid)
            reqs.append(_req(C.REQUEST_TYPE_READ, m["recipient"] if m else _key("rcp", 0),
                             mid=mid))
            exp.append((status, (mid, m["sender"], m["recipient"], m["payload"])
                        if m else None))
        check_responses(eng.handle_queries(reqs, SWEEP_NOW + 1), exp,
                        f"{label} read-back {lo // b}")
    # one more CRUD round: creates into live mailboxes, updates, deletes,
    # and zero-id reads of the mailboxes the sweep emptied
    live = sorted(model)
    q = min(b // 4, len(live) // 3)
    reqs, exp = [], []
    for i in range(q):
        r = model[live[i]]["recipient"]
        reqs.append(_req(C.REQUEST_TYPE_CREATE, _key("snd", i), r, payload=_payload(93, i)))
        exp.append((OK, None))
    for i, mid in enumerate(live[q: 2 * q]):
        m = model[mid]
        reqs.append(_req(C.REQUEST_TYPE_UPDATE, m["sender"], m["recipient"], mid,
                         _payload(94, i)))
        exp.append((OK, None))
    for mid in live[2 * q: 3 * q]:
        m = model[mid]
        reqs.append(_req(C.REQUEST_TYPE_DELETE, m["recipient"], m["recipient"], mid))
        exp.append((OK, (mid, m["sender"], m["recipient"], m["payload"])))
    for rcp in lonely[: b - len(reqs)]:
        reqs.append(_req(C.REQUEST_TYPE_READ, rcp))
        exp.append((NF, None))  # emptied by the sweep
    check_responses(eng.handle_queries(reqs, SWEEP_NOW + 2), exp, f"{label} CRUD round")
    if eng.health()["stash_overflow"] != 0:
        raise AssertionError(f"{label}: stash overflow")
    return dict(
        label=label, evict_every=eng.evict_every,
        bucket_cipher_impl=ecfg.rec.cipher_impl, now=SWEEP_NOW, period=SWEEP_PERIOD,
        evicted=evicted, emptied_mailboxes=len(emptied), messages_after=len(model),
        recipients_after=recips, buffered_rows_at_sweep=buffered, sweep_wall_ms=sweep_ms,
        # the profiled sweep: kernel time summed, and the two spans' extent
        # on the device timeline (idle gaps between launches included)
        sweep_device_ms=prof["device_ms"],
        sweep_span_ms={k: prof["span_device_ms"].get(k) for k in ("sweep_records",
                                                                  "sweep_mailbox")},
        profile=prof, chunks=n_chunks, launches=launches, peak_added_bytes=peak_added,
        chunk_bytes=chunk_bytes, records_tree_bytes=tree_bytes,
        read_back=len(reads), card=card)


def states_differ(ecfg, a, b):
    """First leaf where two engine states on the card differ (junk bucket
    masked), ``"rng"`` if only the generators do, else None."""
    from grapevine_tpu_torch.oram.path_oram import OramState

    for name in ("rec", "mb"):
        z = getattr(ecfg, name).bucket_slots
        for f in OramState._fields:
            x, y = getattr(getattr(a, name), f), getattr(getattr(b, name), f)
            if f in ("tree_val", "nonces"):
                x, y = x[:-1], y[:-1]
            elif f == "tree_idx":
                x, y = x[:-z], y[:-z]
            if x.shape != y.shape or not torch.equal(x, y):
                return f"{name}.{f}"
    for f in ("freelist", "free_top", "recipients", "seq", "hash_key", "id_key"):
        if not torch.equal(getattr(a, f), getattr(b, f)):
            return f
    if not torch.equal(a.rng.get_state(), b.rng.get_state()):
        return "rng"
    return None


class JournalClock:
    """Wall time of each journal append (seal + write + fsync), by kind,
    wrapped around one engine's durability manager."""

    def __init__(self, mgr):
        self.ms: dict[str, list] = {"round": [], "flush": [], "sweep": []}
        for kind in self.ms:
            fn = getattr(mgr, f"append_{kind}")
            setattr(mgr, f"append_{kind}", self._timed(kind, fn))

    def _timed(self, kind, fn):
        def call(*a):
            t = time.perf_counter()
            out = fn(*a)
            self.ms[kind].append((time.perf_counter() - t) * 1e3)
            return out
        return call


def recover_timed(GrapevineEngine, cfg, state_dir, DurabilityConfig, dkw: dict):
    """A facade built on ``state_dir`` (recovery in its constructor), with
    the recovery's wall time and the launches it made."""
    from grapevine_tpu_torch.engine import checkpoint as cp

    spent = []
    recover = cp.DurabilityManager.recover

    def timed(self, *a):
        t = time.perf_counter()
        out = recover(self, *a)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    cp.DurabilityManager.recover = timed
    try:
        eng = GrapevineEngine(cfg, seed=SEED, durability=DurabilityConfig(
            state_dir=state_dir, **dkw))
    finally:
        cp.DurabilityManager.recover = recover
    return eng, spent[0]


def next_round_equal(a, b, reqs, now, where: str) -> None:
    """The same round on two engines: equal responses and transcripts."""
    import numpy as np

    ra, ta = a.handle_queries_with_transcript(reqs, now)
    rb, tb = b.handle_queries_with_transcript(reqs, now)
    if [x.pack() for x in ra] != [x.pack() for x in rb]:
        raise AssertionError(f"{where}: responses of the next round differ")
    if not np.array_equal(ta, tb):
        raise AssertionError(f"{where}: transcripts of the next round differ")


def run_durability_prod(GrapevineEngine, cfg, gk, ck, card) -> dict:
    """Phase 9a: at the production geometry (E=4, ``"pallas_fused"``), no
    checkpoint: 16 rounds, 4 flushes and a sweep journaled with an fsync
    on every record; a second facade on a copy of the state dir recovers
    by replaying the journal on the card, equal to the live engine on
    every leaf and in the generator, and the next round agrees."""
    import shutil
    import tempfile

    from grapevine_tpu_torch.config import DurabilityConfig

    dkw = dict(checkpoint_every_rounds=1 << 20, journal_fsync_every=1)
    with tempfile.TemporaryDirectory() as tmp:
        live_dir = f"{tmp}/live"
        eng = GrapevineEngine(cfg, seed=SEED, durability=DurabilityConfig(
            state_dir=live_dir, **dkw))
        clock = JournalClock(eng.durability)
        _reset_launches(gk, ck)
        rounds, _, _, model, _ = run_slice(eng, 4 * EVICT_EVERY, writes=True,
                                           profile_last=False)
        evicted = eng.expire(NOW + 8, 4)
        live_launches = _launches(gk, ck)
        if eng.flushes != 4 or not evicted or eng.durability.seq != 4 * EVICT_EVERY + 5:
            raise AssertionError(f"durable run: {eng.flushes} flushes, {evicted} evicted, "
                                 f"journal at {eng.durability.seq}")
        shutil.copytree(live_dir, f"{tmp}/copy")
        journal_bytes = sum(os.path.getsize(f"{tmp}/copy/{n}")
                            for n in os.listdir(f"{tmp}/copy") if n.endswith(".wal"))
        _reset_launches(gk, ck)
        rec, replay_s = recover_timed(GrapevineEngine, cfg, f"{tmp}/copy",
                                      DurabilityConfig, dkw)
        replay_launches = _launches(gk, ck)
        records = rec.durability.replayed
        if records != eng.durability.seq:
            raise AssertionError(f"replayed {records} of {eng.durability.seq} records")
        require_launches(replay_launches, {k: v for k, v in live_launches.items() if v},
                         "journal replay")
        diff = states_differ(eng.ecfg, eng.state, rec.state)
        if diff is not None:
            raise AssertionError(f"recovered state differs from the live one at {diff}")
        from grapevine_tpu_torch.wire import constants as C

        live = sorted(model)[: eng.ecfg.batch_size]
        reqs = [_req(C.REQUEST_TYPE_READ, model[mid]["recipient"], mid=mid) for mid in live]
        next_round_equal(eng, rec, reqs, NOW + 9, "journal-only recovery")
        eng.close()
        rec.close()
        del eng, rec
    torch.cuda.empty_cache()
    ms = clock.ms
    return dict(
        max_messages=cfg.max_messages, batch_size=cfg.batch_size, evict_every=EVICT_EVERY,
        bucket_cipher_impl=cfg.bucket_cipher_impl, records=records, evicted=evicted,
        journal_bytes=journal_bytes, append_fsync_ms={k: statistics.median(v)
                                                      for k, v in ms.items()},
        append_fsync_ms_all=ms, replay_s=replay_s, replay_ms_per_record=replay_s * 1e3 / records,
        live_launches=live_launches, replay_launches=replay_launches,
        round_ms=[r["s"] * 1e3 for r in rounds], state_equal=True, card=card)


def run_durability_small(GrapevineConfig, GrapevineEngine, impl: str, card) -> dict:
    """Phase 9b at the cross-check geometry (2^14 messages, B=64, E=4):
    6 rounds, a checkpoint mid-window, 4 more rounds (a flush), a sweep
    and a partial-window flush; a second facade on a copy of the state
    dir recovers from the checkpoint plus the journal tail, equal on
    every leaf and in the generator, and the next round agrees."""
    import shutil
    import tempfile

    import numpy as np

    from grapevine_tpu_torch.config import DurabilityConfig
    from grapevine_tpu_torch.engine import checkpoint as cp

    cfg = GrapevineConfig(max_messages=2**14, max_recipients=2**10, batch_size=64,
                          bucket_cipher_impl=impl, vphases_impl="dense",
                          evict_every=EVICT_EVERY)
    dkw = dict(checkpoint_every_rounds=1 << 20)
    rng = np.random.default_rng(SEED)
    users = [_key("usr", i) for i in range(24)]
    created: list = []
    with tempfile.TemporaryDirectory() as tmp:
        eng = GrapevineEngine(cfg, seed=SEED, durability=DurabilityConfig(
            state_dir=f"{tmp}/live", **dkw))
        ckpt = {}
        for rnd in range(10):
            reqs = mixed_requests(rng, users, created, rnd)
            resp = eng.handle_queries(reqs, NOW + 10 * rnd)
            note_created(reqs, resp, created)
            if rnd == 5:
                t = time.perf_counter()
                seq = eng.checkpoint_now()
                ckpt["write_ms"] = (time.perf_counter() - t) * 1e3
                ckpt["seq"] = seq
        evicted = eng.expire(NOW + 55, 30)
        if not evicted or not eng.flush_now():
            raise AssertionError(f"{impl}: the sweep evicted {evicted}, or no flush")
        path = cp.checkpoint_path(f"{tmp}/live", ckpt["seq"])
        ckpt["bytes"] = os.path.getsize(path)
        t = time.perf_counter()
        cp.load_checkpoint(path, eng.durability.root_key, eng.ecfg)
        torch.cuda.synchronize()
        ckpt["load_ms"] = (time.perf_counter() - t) * 1e3
        shutil.copytree(f"{tmp}/live", f"{tmp}/copy")
        rec, replay_s = recover_timed(GrapevineEngine, cfg, f"{tmp}/copy",
                                      DurabilityConfig, dkw)
        d = rec.durability
        if not d.recovered_from_checkpoint or d.ckpt_seq != ckpt["seq"] or not d.replayed:
            raise AssertionError(f"{impl}: recovery did not start at the checkpoint")
        diff = states_differ(eng.ecfg, eng.state, rec.state)
        if diff is not None:
            raise AssertionError(f"{impl}: recovered state differs at {diff}")
        next_round_equal(eng, rec, mixed_requests(rng, users, created, 10), NOW + 100,
                         f"{impl} checkpoint recovery")
        # recovery = checkpoint load + replay of the journal tail
        out = dict(bucket_cipher_impl=impl, evict_every=EVICT_EVERY, checkpoint=ckpt,
                   replayed=d.replayed, recovery_s=replay_s, evicted=evicted,
                   state_equal=True, card=card)
        eng.close()
        rec.close()
    return out


#: phase 10: handle_queries calls a depth runs (the last one profiled
#: where asked), each of PIPE_CHUNKS full rounds
PIPE_CALLS, PIPE_CHUNKS = 6, 4
PIPE_NOW = NOW + 1000
#: the steady-state dispatch metrics phase 10 reports (its span names)
PIPE_SPANS = ("dispatch", "journal", "evict", "demux", "flush")


class PipeStream:
    """Phase 10's request stream, a function of the seed and of the msg_ids
    earlier calls created. Each round: B/8 creates (a sender each, into
    B/8 recipients); in call 0 the rest are reads by a stranger (NOT_FOUND),
    later B/32 updates by their senders, B/32 deletes by their recipients
    (distinct across the call) and reads by id of live messages not
    deleted in the call. Returns each call's requests and their expected
    statuses; every recipient's mailbox stays far below its cap, and the
    round's creates keep the admission bound far from the quotas."""

    def __init__(self, b: int):
        import numpy as np

        self.b = b
        self.rng = np.random.default_rng(SEED + 10)
        self.senders = [_key("psn", i) for i in range(b)]
        self.recips = [_key("prc", i) for i in range(b // 8)]
        self.live: list = []  # (msg_id, sender, recipient)

    def call(self, k: int):
        from grapevine_tpu_torch.wire import constants as C

        b, nrec = self.b, len(self.recips)
        OK, NF = C.STATUS_CODE_SUCCESS, C.STATUS_CODE_NOT_FOUND
        perm = [self.live[i] for i in self.rng.permutation(len(self.live))]
        nw = b // 32
        upd = iter(perm[:nw * PIPE_CHUNKS])
        dele = iter(perm[nw * PIPE_CHUNKS:2 * nw * PIPE_CHUNKS])
        keep = perm[2 * nw * PIPE_CHUNKS:]
        reqs, want = [], []
        for c in range(PIPE_CHUNKS):
            rnd = k * PIPE_CHUNKS + c
            for j in range(b):
                if j % 8 == 0:
                    r = self.recips[(j // 8 + rnd) % nrec]
                    reqs.append(_req(C.REQUEST_TYPE_CREATE, self.senders[j], r,
                                     payload=_payload(100 + rnd, j)))
                elif k == 0:
                    reqs.append(_req(C.REQUEST_TYPE_READ, _key("pst", 0),
                                     mid=_key("pid", rnd * b + j)[:16]))
                    want.append(NF)
                    continue
                elif j % 32 == 1:
                    mid, snd, rcp = next(upd)
                    reqs.append(_req(C.REQUEST_TYPE_UPDATE, snd, rcp, mid,
                                     _payload(200 + rnd, j)))
                elif j % 32 == 17:
                    mid, _snd, rcp = next(dele)
                    reqs.append(_req(C.REQUEST_TYPE_DELETE, rcp, rcp, mid))
                else:
                    mid, _snd, rcp = keep[int(self.rng.integers(len(keep)))]
                    reqs.append(_req(C.REQUEST_TYPE_READ, rcp, mid=mid))
                want.append(OK)
        gone = set(m for m, _, _ in perm[nw * PIPE_CHUNKS:2 * nw * PIPE_CHUNKS])
        self.live = [x for x in self.live if x[0] not in gone]
        return reqs, want

    def note(self, reqs, resp) -> None:
        from grapevine_tpu_torch.wire import constants as C

        for q, r in zip(reqs, resp):
            if q.request_type == C.REQUEST_TYPE_CREATE:
                self.live.append((r.record.msg_id, q.auth_identity, q.record.recipient))


def _check_statuses(resp, want, where: str) -> None:
    got = [r.status_code for r in resp]
    if got != want:
        bad = next(i for i, (g, w) in enumerate(zip(got, want)) if g != w)
        raise AssertionError(f"{where} op {bad}: status {got[bad]}, expected {want[bad]}")


def drive_pipeline(eng, depth: int, gk, ck, profile: bool) -> dict:
    """Phase 10 on one engine: PIPE_CALLS calls of PIPE_CHUNKS rounds
    through ``handle_queries``, then one more (profiled if ``profile``).

    Every round's ``handle_queries_async`` returns through a wrapper that
    records whether the round dispatched before it was still running on
    the card (its event not complete) when it returned; from the third
    round on it runs under ``torch.cuda.set_sync_debug_mode("error")``
    (depth 2), so any synchronizing call in the upload, the admission
    decision, the round, the flush or the output copies raises. The
    admission bound's exact read is the one sync allowed there, and is
    counted (``fallback_reads``); so are the rounds whose predecessor was
    still running when their dispatch started. Returns the calls' wall
    times (and the host's collections and allocations in each), the
    steady rounds' span medians, the overlap record, the launches, the
    response digest and the profile."""
    import hashlib

    from grapevine_tpu_torch.wire import constants as C

    stream = PipeStream(eng.ecfg.batch_size)
    pendings, overlapped, guarded, fallback_reads = [], [], [], []
    running_at_start: list = []
    read, dispatch = eng._read_bound_locked, eng.handle_queries_async
    live = {"guard": depth == 2}

    def counted_read():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return read()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            fallback_reads.append(len(pendings))

    def watched_dispatch(reqs, now):
        prev = pendings[-1] if pendings else None
        running_at_start.append(prev is not None and prev.running())
        guard = live["guard"] and len(pendings) >= 2
        if guard:
            torch.cuda.set_sync_debug_mode("error")
        try:
            p = dispatch(reqs, now)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        overlapped.append(prev is not None and prev.running())
        guarded.append(guard)
        pendings.append(p)
        return p

    eng._read_bound_locked = counted_read
    eng.handle_queries_async = watched_dispatch
    digest = hashlib.sha256()
    call_s, host, prof = [], [], None
    gc.collect()
    _reset_launches(gk, ck)
    for k in range(PIPE_CALLS + 1):
        reqs, want = stream.call(k)

        def run():
            return eng.handle_queries(reqs, PIPE_NOW + k)

        if k == PIPE_CALLS and profile:
            live["guard"] = False
            prof = profile_round(run)
            resp = prof.pop("result")
        else:
            gc0, gs0, seg0 = host_counters()
            t0 = time.perf_counter()
            resp = run()
            call_s.append(time.perf_counter() - t0)
            gc1, gs1, seg1 = host_counters()
            host.append(dict(gc_gen2=gc1 - gc0, gc_gen2_ms=(gs1 - gs0) * 1e3,
                             cuda_segments=seg1 - seg0))
        _check_statuses(resp, want, f"phase 10 depth {depth} call {k}")
        stream.note(reqs, resp)
        for r in resp:
            digest.update(r.pack())
    launches = _launches(gk, ck)
    del eng._read_bound_locked, eng.handle_queries_async
    n_rounds = len(pendings)
    if n_rounds != (PIPE_CALLS + 1) * PIPE_CHUNKS:
        raise AssertionError(f"phase 10: {n_rounds} rounds dispatched")
    steady = pendings[PIPE_CHUNKS:PIPE_CALLS * PIPE_CHUNKS]
    spans = {s: [p.spans[s][1] * 1e3 for p in steady if s in p.spans] for s in PIPE_SPANS}
    round_ms = sorted(s * 1e3 / PIPE_CHUNKS for s in call_s[1:])
    snap = eng.metrics.snapshot()
    b = eng.ecfg.batch_size
    return dict(
        depth=depth, rounds=n_rounds, calls=PIPE_CALLS + 1, chunks_per_call=PIPE_CHUNKS,
        call_ms=[s * 1e3 for s in call_s], call_host=host,
        median_round_ms=statistics.median(round_ms), max_round_ms=round_ms[-1],
        ops_per_s=b * PIPE_CHUNKS * (PIPE_CALLS - 1) / sum(call_s[1:]),
        span_median_ms={s: statistics.median(v) if v else None for s, v in spans.items()},
        registry_p50_s={s: snap.get(f"grapevine_phase_seconds{{phase={s}}}_p50")
                        for s in PIPE_SPANS},
        overlapped_rounds=sum(overlapped), overlapped=overlapped,
        prev_running_at_dispatch_start=sum(running_at_start),
        sync_guarded_dispatches=sum(guarded),
        sync_guarded_without_fallback=sum(g for i, g in enumerate(guarded)
                                          if i not in fallback_reads),
        fallback_reads=fallback_reads, flushes=eng.flushes, launches=launches,
        profile=prof and {k: v for k, v in prof.items() if k != "top_kernels"},
        top_kernels=prof and prof["top_kernels"][:5],
        responses_sha256=digest.hexdigest(), statuses_checked=True,
    )


def _fixed_urandom(n: int) -> bytes:
    return bytes((7 * i + 3) & 0xFF for i in range(n))


def run_pipeline_phase(GrapevineConfig, GrapevineEngine, geo: dict, impl: str,
                       evict_every: int, durable: bool, gk, ck, card) -> dict:
    """Phase 10 for one configuration: the same stream at depth 1, then
    (that engine freed, its final state kept) at depth 2; equal responses
    and state, and with ``durable`` (an fsync per journal record, no
    checkpoint; seal nonces and the root key fixed for the phase, so both
    journals are the same bytes) equal journal files, and a depth-1 engine
    recovered from the depth-2 state dir equal to the live one."""
    import shutil
    import tempfile

    from grapevine_tpu_torch.config import DurabilityConfig

    dkw = dict(checkpoint_every_rounds=1 << 20, journal_fsync_every=1)
    cfgs = {d: GrapevineConfig(**geo, bucket_cipher_impl=impl, evict_every=evict_every,
                               pipeline_depth=d) for d in (1, 2)}
    want = {"gather_decrypt_rows": 3, "scatter_encrypt_rows": 0} if impl == "pallas_fused" \
        else {"gather_decrypt_rows_tiled": 3, "scatter_encrypt_rows_tiled": 3}
    runs, states = {}, {}
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    urandom = os.urandom
    os.urandom = _fixed_urandom
    try:
        for depth in (1, 2):
            dur = (DurabilityConfig(state_dir=f"{tmp}/d{depth}", **dkw) if durable else None)
            eng = GrapevineEngine(cfgs[depth], seed=SEED, durability=dur)
            if eng.pipeline_depth != depth:
                raise AssertionError(f"engine runs depth {eng.pipeline_depth}")
            run = drive_pipeline(eng, depth, gk, ck, profile=depth == 2)
            rounds, flushes = run["rounds"], run["flushes"]
            expect = {k: v * rounds for k, v in want.items()}
            if evict_every > 1:
                expect["scatter_encrypt_rows"] = 2 * flushes
                if flushes != rounds // evict_every:
                    raise AssertionError(f"phase 10: {flushes} flushes in {rounds} rounds")
            require_launches(run["launches"], expect, f"pipeline depth {depth}")
            runs[depth] = run
            if depth == 1:
                states[1] = eng.state
                if durable:
                    eng.close()
                del eng
                torch.cuda.empty_cache()
            else:
                live = eng
        if runs[1]["responses_sha256"] != runs[2]["responses_sha256"]:
            raise AssertionError(f"{impl}: depth-2 responses differ from depth 1")
        diff = states_differ(live.ecfg, states[1], live.state)
        if diff is not None:
            raise AssertionError(f"{impl}: depth-2 state differs from depth 1 at {diff}")
        out = dict(bucket_cipher_impl=impl, evict_every=evict_every, durable=durable,
                   depth1=runs[1], depth2=runs[2], responses_equal=True, state_equal=True,
                   card=card)
        if durable:
            live.close()
            files = {d: sorted(n for n in os.listdir(f"{tmp}/d{d}") if n.endswith(".wal"))
                     for d in (1, 2)}
            same = files[1] == files[2] and all(
                open(f"{tmp}/d1/{n}", "rb").read() == open(f"{tmp}/d2/{n}", "rb").read()
                for n in files[1])
            if not same:
                raise AssertionError(f"{impl}: depth-2 journal bytes differ from depth 1")
            out["journal_bytes"] = sum(os.path.getsize(f"{tmp}/d2/{n}") for n in files[2])
            shutil.copytree(f"{tmp}/d2", f"{tmp}/copy")
            rec, replay_s = recover_timed(GrapevineEngine, cfgs[1], f"{tmp}/copy",
                                          DurabilityConfig, dkw)
            diff = states_differ(live.ecfg, live.state, rec.state)
            if diff is not None:
                raise AssertionError(f"{impl}: depth-1 recovery of the depth-2 journal "
                                     f"differs at {diff}")
            out.update(journal_equal=True, recovered_equal=True, replay_s=replay_s,
                       replayed=rec.durability.replayed)
            rec.close()
            del rec
    finally:
        os.urandom = urandom
        shutil.rmtree(tmp, ignore_errors=True)
    del live, states
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


#: phase 11: the serving tier at the production point (durable E=4
#: "pallas_fused"): concurrent client sessions in part a, full rounds of
#: signed ops through the scheduler in part b, the engine/frontend tier
#: in part c
SERVE_NOW = NOW + 5000
SERVE_CLIENTS, SERVE_POOL, SERVE_ROUNDS, SERVE_LOOKAHEAD = 16, 256, 12, 4
#: ops in each phase 11a session's script
SESSION_OPS = 9
TIER_CLIENTS, TIER_OPS = 4, 4
#: the phase series part a's /metrics scrape must show samples of
SERVE_PHASES = ("assembly", "verify", "dispatch", "evict", "demux", "journal", "sweep")


def _rpc_code(fn):
    """The gRPC status code ``fn`` fails with (None if it succeeds)."""
    import grpc

    try:
        fn()
    except grpc.RpcError as exc:
        return exc.code()
    return None


def serve_sessions(server, port: int) -> None:
    """Phase 11a's client work: SERVE_CLIENTS sessions authenticate, then
    run a scripted CRUD sequence at once, in three steps between
    barriers (two creates to the next two clients; zero-id read, delete
    and read of the client's own mailbox; reads by id, an update and a
    read-back of what it sent), every response checked against a dict
    model."""
    import threading

    from grapevine_tpu_torch.server.client import GrapevineClient
    from grapevine_tpu_torch.wire import constants as C

    OK, NF = C.STATUS_CODE_SUCCESS, C.STATUS_CODE_NOT_FOUND
    n = SERVE_CLIENTS
    clients = [GrapevineClient(f"insecure-grapevine://127.0.0.1:{port}",
                               identity_seed=_key("cli", i)) for i in range(n)]
    for c in clients:
        c.auth()
    model: dict = {}  # msg_id -> (sender, recipient, payload)
    sent: list = [[] for _ in range(n)]
    deleted: set = set()
    lock, barrier = threading.Lock(), threading.Barrier(n)
    errors: list = []

    def check(r, status, want=None, where=""):
        if r.status_code != status:
            raise AssertionError(f"phase 11a {where}: status {r.status_code}, "
                                 f"expected {status}")
        if want is not None:
            got = (r.record.sender, r.record.recipient, r.record.payload)
            if got != want or r.record.timestamp != SERVE_NOW:
                raise AssertionError(f"phase 11a {where}: record differs from the model")

    def mine(i, r, where):
        """A record addressed to client i, equal to the model's."""
        with lock:
            want = model.get(r.record.msg_id)
        if want is None or want[1] != clients[i].public_key:
            raise AssertionError(f"phase 11a {where}: not a message for this client")
        check(r, OK, want, where)
        return r.record.msg_id

    def script(i):
        c = clients[i]
        try:
            for k in (1, 2):
                rcp = clients[(i + k) % n].public_key
                pay = _payload(110 + k, i)
                r = c.create(rcp, pay)
                check(r, OK, (c.public_key, rcp, pay), f"client {i} create {k}")
                with lock:
                    model[r.record.msg_id] = (c.public_key, rcp, pay)
                sent[i].append(r.record.msg_id)
            barrier.wait()
            first = mine(i, c.read(), f"client {i} zero-id read")
            popped = mine(i, c.delete(), f"client {i} zero-id delete")
            with lock:
                deleted.add(popped)
            left = mine(i, c.read(), f"client {i} zero-id read after delete")
            if left == popped or first not in (popped, left):
                raise AssertionError(f"phase 11a client {i}: mailbox order broken")
            barrier.wait()
            for k, mid in enumerate(sent[i]):
                with lock:
                    want = None if mid in deleted else model[mid]
                r = c.read(mid)
                check(r, NF if want is None else OK, want, f"client {i} read {k}")
            mid = sent[i][1]
            with lock:
                gone, (snd, rcp, _) = mid in deleted, model[mid]
            pay = _payload(120, i)
            r = c.update(mid, rcp, pay)
            check(r, NF if gone else OK, None if gone else (snd, rcp, pay),
                  f"client {i} update")
            if not gone:
                with lock:
                    model[mid] = (snd, rcp, pay)
            r = c.read(mid)
            check(r, NF if gone else OK, None if gone else (snd, rcp, pay),
                  f"client {i} read-back")
        except BaseException as exc:  # re-raised on the main thread
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=script, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for c in clients:
        c.close()
    if errors:
        raise errors[0]
    live = len(model) - len(deleted)
    if server.engine.message_count() != live:
        raise AssertionError(f"phase 11a: engine holds {server.engine.message_count()} "
                             f"messages, model {live}")


def serve_refusals(server, port: int) -> dict:
    """Phase 11a: a forged challenge signature gets UNAUTHENTICATED
    without a round and counts one auth failure; a malformed envelope gets
    INVALID_ARGUMENT."""
    import grpc

    from grapevine_tpu_torch.server.client import GrapevineClient

    c = GrapevineClient(f"insecure-grapevine://127.0.0.1:{port}",
                        identity_seed=_key("forger", 0))
    c.auth()
    scheme = c._scheme

    class Forged:
        keygen = staticmethod(scheme.keygen)

        @staticmethod
        def sign(sk, ctx, msg):
            return b"\x01" * 63 + b"\x81"  # marked, bogus

    snap = server.engine.metrics.snapshot
    rounds0, fails0 = snap()["rounds"], snap()["grapevine_auth_failures_total"]
    c._scheme = Forged
    forged = _rpc_code(lambda: c.create(c.public_key, _payload(130, 0)))
    c._scheme = scheme
    if forged != grpc.StatusCode.UNAUTHENTICATED:
        raise AssertionError(f"phase 11a: a forged signature got {forged}")
    if snap()["rounds"] != rounds0:
        raise AssertionError("phase 11a: the forged op reached a round")
    if snap()["grapevine_auth_failures_total"] != fails0 + 1:
        raise AssertionError("phase 11a: the auth failure was not counted")
    junk = _rpc_code(lambda: c._query_rpc(b"\x0a\x05ab"))
    if junk != grpc.StatusCode.INVALID_ARGUMENT:
        raise AssertionError(f"phase 11a: a malformed envelope got {junk}")
    c.close()
    return dict(forged_signature=forged.name, rounds_added_by_forged_op=0,
                auth_failures_added=1, malformed_envelope=junk.name)


def scrape(mport: int) -> dict:
    """Phase 11a: /metrics once (the SERVE_PHASES series must have
    samples) and /healthz (200, healthy)."""
    import urllib.request

    body = urllib.request.urlopen(f"http://127.0.0.1:{mport}/metrics", timeout=60) \
        .read().decode()
    counts = {}
    for ph in SERVE_PHASES:
        m = re.search(r'^grapevine_phase_seconds_count\{phase="%s"\} (\S+)$' % ph, body,
                      re.M)
        counts[ph] = float(m.group(1)) if m else 0.0
    if not all(counts.values()):
        raise AssertionError(f"phase 11a: phase series without samples: {counts}")
    hz = urllib.request.urlopen(f"http://127.0.0.1:{mport}/healthz", timeout=60)
    doc = json.loads(hz.read())
    if hz.status != 200 or doc.get("healthy") is not True:
        raise AssertionError(f"phase 11a: /healthz {hz.status} {doc}")
    return dict(phase_counts=counts, healthz=hz.status, healthy=doc["healthy"])


class ServeStream:
    """Phase 11b's ops over a pool of SERVE_POOL identities, each of whose
    challenge signature is made once (the service checks challenge
    freshness, the scheduler only the signature). Each round of B: B/8
    creates (pool member j to member j + r + 1); in the first
    SERVE_LOOKAHEAD rounds the rest are reads of unknown ids by a pool
    member (NOT_FOUND); later B/32 updates by the sender, B/32 deletes by
    the recipient and reads by id by the recipient, of messages created at
    least SERVE_LOOKAHEAD rounds earlier (their ids are known by then)."""

    def __init__(self, b: int):
        import numpy as np

        from grapevine_tpu_torch.session import schnorrkel
        from grapevine_tpu_torch.wire import constants as C

        self.b = b
        self.rng = np.random.default_rng(SEED + 11)
        self.pool = []
        for i in range(SERVE_POOL):
            sk, pub = schnorrkel.keygen(_key("pool", i))
            challenge = _key("chal", i)
            sig = schnorrkel.sign(sk, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge)
            self.pool.append((pub, (pub, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge,
                                    sig)))
        self.live: list = []  # (msg_id, sender index, recipient index)

    def _op(self, t, who: int, rcp: int | None = None, mid=bytes(16), payload=None):
        from grapevine_tpu_torch.wire import constants as C
        from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

        pub, auth = self.pool[who]
        rec = RequestRecord(msg_id=mid,
                            recipient=self.pool[rcp][0] if rcp is not None else bytes(32),
                            payload=payload if payload is not None else bytes(C.PAYLOAD_SIZE))
        return QueryRequest(request_type=t, auth_identity=pub, auth_signature=auth[3],
                            record=rec), auth

    def round(self, r: int):
        """Round r's ops and their expected (status, sender, recipient,
        payload or None)."""
        from grapevine_tpu_torch.wire import constants as C

        b, n = self.b, SERVE_POOL
        OK, NF = C.STATUS_CODE_SUCCESS, C.STATUS_CODE_NOT_FOUND
        nw = b // 32
        perm = [self.live[i] for i in self.rng.permutation(len(self.live))]
        upd, dele, keep = perm[:nw], perm[nw:2 * nw], perm[2 * nw:]
        if r >= SERVE_LOOKAHEAD and len(keep) < 1:
            raise AssertionError("phase 11b: no live messages to read")
        ops, want = [], []
        iu, idl = iter(upd), iter(dele)
        for j in range(b):
            if j % 8 == 0:
                snd, rcp = (j // 8) % n, (j // 8 + r + 1) % n
                pay = _payload(140 + r, j)
                ops.append(self._op(C.REQUEST_TYPE_CREATE, snd, rcp, payload=pay))
                want.append((OK, snd, rcp, pay))
            elif r < SERVE_LOOKAHEAD:
                ops.append(self._op(C.REQUEST_TYPE_READ, j % n, mid=_key("none", r * b + j)[:16]))
                want.append((NF, None, None, None))
            elif j % 32 == 1:
                mid, snd, rcp, _ = next(iu)
                pay = _payload(150 + r, j)
                ops.append(self._op(C.REQUEST_TYPE_UPDATE, snd, rcp, mid, pay))
                want.append((OK, snd, rcp, pay))
            elif j % 32 == 17:
                mid, snd, rcp, pay = next(idl)
                ops.append(self._op(C.REQUEST_TYPE_DELETE, rcp, rcp, mid))
                want.append((OK, snd, rcp, pay))
            else:
                mid, snd, rcp, pay = keep[int(self.rng.integers(len(keep)))]
                ops.append(self._op(C.REQUEST_TYPE_READ, rcp, mid=mid))
                want.append((OK, snd, rcp, pay))
        if r >= SERVE_LOOKAHEAD:
            # updated messages come back into the pool with their new
            # payload when the round settles
            gone = {m for m, *_ in dele} | {m for m, *_ in upd}
            self.live = [x for x in self.live if x[0] not in gone]
        return ops, want

    def settle(self, ops, want, resps, r: int) -> None:
        """Check round r's responses against the model and note what it
        created and updated."""
        for j, ((req, _), (status, snd, rcp, pay), resp) in enumerate(zip(ops, want, resps)):
            if resp.status_code != status:
                raise AssertionError(f"phase 11b round {r} op {j}: status "
                                     f"{resp.status_code}, expected {status}")
            if snd is not None:
                got = (resp.record.sender, resp.record.recipient, resp.record.payload)
                if got != (self.pool[snd][0], self.pool[rcp][0], pay):
                    raise AssertionError(f"phase 11b round {r} op {j}: record differs "
                                         "from the model")
            if j % 8 == 0:
                self.live.append((resp.record.msg_id, snd, rcp, pay))
            elif r >= SERVE_LOOKAHEAD and j % 32 == 1:
                self.live.append((req.record.msg_id, snd, rcp, pay))


def serve_rounds(eng, gk, ck, card, sched=None, on_dispatch=None) -> dict:
    """Phase 11b: SERVE_ROUNDS full rounds of signed ops through a
    ``BatchScheduler`` over the phase's engine (its own, with windows only
    a full batch closes), submitted with ``submit_nowait`` SERVE_LOOKAHEAD
    rounds ahead, at the engine's depth; then one more round alone, under
    the profiler with every thread recorded. Per round: the collector's
    assembly wait, the host batch verify, dispatch and settle ms, the
    wall between dispatch starts, and whether the previous round was still
    running on the card when this round's dispatch returned.

    Phase 13a passes its server's own scheduler (``sched``, with the
    adaptive window): each round's B ops then enter its queue under the
    scheduler's lock, so the window opens on a whole round, as on a
    saturated server; the last round runs unprofiled (the server's own
    profiler gate captures in 13a), and ``on_dispatch(k)`` runs before the
    k-th dispatch (0-based)."""
    from grapevine_tpu_torch.server.scheduler import BatchScheduler

    b = eng.ecfg.batch_size
    stream = ServeStream(b)
    pendings, overlapped = [], []
    dispatch = eng.handle_queries_async

    def watched_dispatch(reqs, now):
        if on_dispatch is not None:
            on_dispatch(len(pendings))
        prev = pendings[-1] if pendings else None
        p = dispatch(reqs, now)
        overlapped.append(prev is not None and prev.running())
        pendings.append(p)
        return p

    own = sched is None
    if own:
        sched = BatchScheduler(eng, max_wait_ms=600_000.0, idle_gap_ms=600_000.0,
                               clock=lambda: SERVE_NOW)

    def submit_round(ops):
        if own:
            return [sched.submit_nowait(q, a) for q, a in ops]
        with sched._cv:  # reentrant: the collector sees the whole round at once
            return [sched.submit_nowait(q, a) for q, a in ops]

    eng.handle_queries_async = watched_dispatch
    rounds0, flushes0 = eng.metrics.snapshot()["rounds"], eng.flushes
    gc.collect()
    with eng._lock:  # an expiry sweep holds the lock through all its launches
        _reset_launches(gk, ck)
        sweeps0 = eng.metrics.snapshot()["sweeps"]
    try:
        queued: dict = {}
        gc0, gs0, _ = host_counters()
        t0 = time.perf_counter()
        for r in range(SERVE_ROUNDS + 1):
            if r >= SERVE_LOOKAHEAD or r == SERVE_ROUNDS:
                for k in sorted(queued):
                    if k <= r - SERVE_LOOKAHEAD or r == SERVE_ROUNDS:
                        ops, want, futs = queued.pop(k)
                        stream.settle(ops, want, [f.result(timeout=600) for f in futs], k)
            if r == SERVE_ROUNDS:
                break
            ops, want = stream.round(r)
            queued[r] = (ops, want, submit_round(ops))
        wall_s = time.perf_counter() - t0
        gc1, gs1, _ = host_counters()
        ops, want = stream.round(SERVE_ROUNDS)

        def one_round():
            return [f.result(timeout=600) for f in submit_round(ops)]

        if own:
            prof = profile_round(one_round, all_threads=True)
            stream.settle(ops, want, prof.pop("result"), SERVE_ROUNDS)
            if not prof["device_kernels"]:
                raise AssertionError("phase 11b: the profiler saw no kernel of the round")
        else:
            prof = None
            stream.settle(ops, want, one_round(), SERVE_ROUNDS)
        # the same batch verify with no other thread running: what the
        # collector's verify costs without contention for the interpreter
        items = [a for _, a in ops]
        t_v = time.perf_counter()
        if not sched.scheme.batch_verify(items):
            raise AssertionError("phase 11b: the round's signatures do not verify")
        verify_alone_ms = (time.perf_counter() - t_v) * 1e3
    finally:
        if own:
            sched.close()
        del eng.handle_queries_async
    launches = _launches(gk, ck)
    rounds = eng.metrics.snapshot()["rounds"] - rounds0
    flushes = eng.flushes - flushes0
    if rounds != SERVE_ROUNDS + 1 or len(pendings) != rounds:
        raise AssertionError(f"phase 11b: {rounds} rounds for {SERVE_ROUNDS + 1} full batches")
    if own:  # phase 13a's expiry thread also launches B2: it checks its own
        require_launches(launches, {"gather_decrypt_rows": 3 * rounds,
                                    "scatter_encrypt_rows": 2 * flushes}, "phase 11b")
    if flushes != (rounds0 + rounds) // EVICT_EVERY - rounds0 // EVICT_EVERY:
        raise AssertionError(f"phase 11b: {flushes} flushes in rounds {rounds0 + 1}-"
                             f"{rounds0 + rounds}")
    per = []
    timed = pendings[:SERVE_ROUNDS]
    for k, p in enumerate(timed):
        s = p.spans
        per.append(dict(
            assembly_ms=s["assembly"][1] * 1e3, verify_ms=s["verify"][1] * 1e3,
            dispatch_ms=s["dispatch"][1] * 1e3, journal_ms=s["journal"][1] * 1e3,
            settle_ms=(s["evict"][1] + s["demux"][1]) * 1e3,
            flush_ms=s["flush"][1] * 1e3 if "flush" in s else None,
            wall_ms=(timed[k + 1].spans["dispatch"][0] - s["dispatch"][0]) * 1e3
            if k + 1 < len(timed) else None,
            prev_running_at_dispatch_return=overlapped[k]))
    steady = per[1:-1]
    med = {k: statistics.median(x[k] for x in steady)
           for k in ("assembly_ms", "verify_ms", "dispatch_ms", "settle_ms", "wall_ms")}
    return dict(rounds=rounds, flushes=flushes, batch_size=b, ops=b * SERVE_ROUNDS,
                pool=SERVE_POOL, lookahead_rounds=SERVE_LOOKAHEAD,
                pipeline_depth=sched.pipeline_depth, wall_s=wall_s,
                ops_per_s=b * SERVE_ROUNDS / wall_s,
                median=med, max_wall_ms=max(x["wall_ms"] for x in steady),
                verify_alone_ms=verify_alone_ms, sweeps_at_reset=sweeps0,
                gc_gen2=gc1 - gc0, gc_gen2_ms=(gs1 - gs0) * 1e3, per_round=per,
                overlapped_rounds=sum(overlapped[:SERVE_ROUNDS]),
                profile=prof and {k: v for k, v in prof.items() if k != "top_kernels"},
                top_kernels=prof and prof["top_kernels"][:5], launches=launches,
                responses_checked=b * (SERVE_ROUNDS + 1), card=card)


def serve_tier(GrapevineConfig, geo, gk, ck, card, engine_kw=None, before_stop=None,
               where: str = "phase 11c") -> dict:
    """Phase 11c: an ``EngineServer`` on the card at
    ``"pallas_fused_tiled"``, E=1, behind a ``FrontendServer`` on gRPC
    loopback; TIER_CLIENTS clients run TIER_OPS ops each (a create to the
    next client, a zero-id read of their own mailbox, a read by id and an
    update of what they sent), every response checked; B4 and B6 launch 3
    times a round. Phase 13b passes the engine tier's observability knobs
    (``engine_kw``) and ``before_stop(engine_server) -> dict``, run with
    the tier still up and merged into the line."""
    import threading

    from grapevine_tpu_torch.server.client import GrapevineClient
    from grapevine_tpu_torch.server.tier import EngineServer, FrontendServer
    from grapevine_tpu_torch.wire import constants as C

    OK = C.STATUS_CODE_SUCCESS
    cfg = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused_tiled")
    t0 = time.perf_counter()
    engine = EngineServer(cfg, seed=SEED, clock=lambda: SERVE_NOW, **(engine_kw or {}))
    eport = engine.start("127.0.0.1:0")
    fe = FrontendServer(f"127.0.0.1:{eport}", config=cfg)
    port = fe.start("insecure-grapevine://127.0.0.1:0")
    init_s = time.perf_counter() - t0
    n = TIER_CLIENTS
    clients = [GrapevineClient(f"insecure-grapevine://127.0.0.1:{port}",
                               identity_seed=_key("tier", i)) for i in range(n)]
    for c in clients:
        c.auth()
    barrier, errors = threading.Barrier(n), []
    _reset_launches(gk, ck)

    def script(i):
        c, nxt = clients[i], clients[(i + 1) % n]
        try:
            pay = _payload(160, i)
            r = c.create(nxt.public_key, pay)
            if r.status_code != OK:
                raise AssertionError(f"{where} client {i}: create {r.status_code}")
            mid = r.record.msg_id
            barrier.wait()
            r = c.read()
            want = (clients[(i - 1) % n].public_key, c.public_key, _payload(160, (i - 1) % n))
            if r.status_code != OK or (r.record.sender, r.record.recipient,
                                       r.record.payload) != want:
                raise AssertionError(f"{where} client {i}: zero-id read differs")
            r = c.read(mid)
            if r.status_code != OK or r.record.payload != pay:
                raise AssertionError(f"{where} client {i}: read by id differs")
            r = c.update(mid, nxt.public_key, _payload(161, i))
            if r.status_code != OK or r.record.payload != _payload(161, i):
                raise AssertionError(f"{where} client {i}: update differs")
        except BaseException as exc:
            errors.append(exc)
            barrier.abort()

    t0 = time.perf_counter()
    threads = [threading.Thread(target=script, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    serve_s = time.perf_counter() - t0
    launches = _launches(gk, ck)
    rounds = engine.engine.metrics.snapshot()["rounds"]
    for c in clients:
        c.close()
    extra = {}
    try:
        if before_stop is not None and not errors:
            extra = before_stop(engine)
    finally:
        fe.stop()
        engine.stop()
    if errors:
        raise errors[0]
    require_launches(launches, {"gather_decrypt_rows_tiled": 3 * rounds,
                                "scatter_encrypt_rows_tiled": 3 * rounds}, where)
    out = dict(bucket_cipher_impl="pallas_fused_tiled", evict_every=1, clients=n,
               ops=n * TIER_OPS, rounds=rounds, init_s=init_s, serve_s=serve_s,
               launches=launches, responses_checked=n * TIER_OPS, **extra, card=card)
    del engine, fe
    torch.cuda.empty_cache()
    return out


def run_serving_phase(GrapevineConfig, geo: dict, gk, ck, card) -> dict:
    """Phase 11: the port serving the reference's wire protocol on the card
    at the production point, durable (a state dir, an fsync per record),
    at E=4 ``"pallas_fused"`` and the auto pipeline depth, with a fixed
    server clock. (a) one ``GrapevineServer`` with ``expiry_period=10``
    (its expiry loop sweeps about once a second on its own thread, and
    nothing expires under the fixed clock): concurrent sessions, the
    refusals, one /metrics and /healthz scrape; (b) full rounds through
    the scheduler; (c) the engine and frontend tier. Returns the lines."""
    import shutil
    import tempfile

    import grpc

    from grapevine_tpu_torch import session
    from grapevine_tpu_torch.config import DurabilityConfig
    from grapevine_tpu_torch.engine import expiry
    from grapevine_tpu_torch.server.service import GrapevineServer

    if session.R255_BACKEND != "native":
        raise AssertionError("phase 11: the native r255 library did not build; a "
                             "pure-Python batch verify would set the round's pace")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    cfg = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused", evict_every=EVICT_EVERY,
                          expiry_period=10)
    dcfg = DurabilityConfig(state_dir=f"{tmp}/state", checkpoint_every_rounds=1 << 20,
                            journal_fsync_every=1)
    try:
        t0 = time.perf_counter()
        server = GrapevineServer(cfg, seed=SEED, clock=lambda: SERVE_NOW, durability=dcfg)
        eng = server.engine
        if eng.pipeline_depth != 2:
            raise AssertionError(f"phase 11: the engine runs depth {eng.pipeline_depth}")
        port = server.start("insecure-grapevine://127.0.0.1:0")
        mport = server.start_metrics(0)
        init_s = time.perf_counter() - t0
        gc.collect()
        _reset_launches(gk, ck)
        snap = eng.metrics.snapshot
        t0 = time.perf_counter()
        serve_sessions(server, port)
        ops = SERVE_CLIENTS * SESSION_OPS
        sessions_s = time.perf_counter() - t0
        refusals = serve_refusals(server, port)
        deadline = time.perf_counter() + 30
        while snap()["sweeps"] < 1 and time.perf_counter() < deadline:
            time.sleep(0.05)
        metrics = scrape(mport)
        # stop the expiry loop (waiting out a sweep in progress) before the
        # launches are read and part b is timed
        server._expiry_stop.set()
        server._expiry_thread.join(timeout=60)
        launches_a = _launches(gk, ck)
        s = snap()
        rounds_a, sweeps = s["rounds"], s["sweeps"]
        per_sweep = 2 * sum(t.n_buckets_padded // expiry._chunk_rows(t)
                            for t in (eng.ecfg.rec, eng.ecfg.mb))
        require_launches(launches_a, {"gather_decrypt_rows": 3 * rounds_a,
                                      "scatter_encrypt_rows": 2 * eng.flushes,
                                      "cipher_rows_pallas": per_sweep * sweeps},
                         "phase 11a")
        if sweeps < 1:
            raise AssertionError("phase 11a: the expiry loop never swept")
        part_a = dict(
            transport=f"grpc {grpc.__version__} loopback", clients=SERVE_CLIENTS, ops=ops,
            crypto_backend=session.CRYPTO_BACKEND, r255_backend=session.R255_BACKEND,
            device=str(eng.device), pipeline_depth=eng.pipeline_depth, init_s=init_s,
            sessions_s=sessions_s,
            rounds=rounds_a, flushes=eng.flushes, sweeps=sweeps, evicted=s["evicted"],
            responses_checked=ops, **refusals, metrics=metrics, launches=launches_a,
            health={k: v for k, v in server.health().items()
                    if k in ("sessions", "messages", "recipients", "stash_overflow",
                             "batch_verifies", "auth_failures")},
            card=card)
        if part_a["health"]["stash_overflow"]:
            raise AssertionError("phase 11a: stash overflow")
        part_b = serve_rounds(eng, gk, ck, card)
        server.stop(checkpoint=False)
        del server, eng
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    part_c = serve_tier(GrapevineConfig, geo, gk, ck, card)
    return dict(a=part_a, b=part_b, c=part_c, phase_s=time.perf_counter() - t_phase)


#: phase 12: the hot standby. 12a at the production point: phase 10's
#: stream for STANDBY_CALLS calls of PIPE_CHUNKS rounds while the standby
#: follows, a sweep (nothing expires at this clock), the cut, then
#: STANDBY_TAIL rounds only the disk sees
STANDBY_CALLS, STANDBY_TAIL = 3, 3
STANDBY_NOW = NOW + 8000
STANDBY_SWEEP = (STANDBY_NOW + 50, 1 << 20)
#: seconds a phase 12 wait may take: the catch-up, a subprocess's start,
#: one of its steps
CATCH_UP_S, PROC_START_S, PROC_STEP_S = 300, 240, 120


class ThreadLaunches(dict):
    """A kernel module's ``LAUNCHES`` dict that also counts each launch by
    the thread that made it. A wrapper stores its count plus one once a
    launch; this counts the store, not the value, so two threads launching
    at once can neither lose nor double a thread's count."""

    def __init__(self, base):
        import threading

        super().__init__(base)
        self.by_thread: dict = {}
        self._lock = threading.Lock()

    def __setitem__(self, k, v):
        import threading

        if v > 0:
            with self._lock:
                t = self.by_thread.setdefault(threading.current_thread().name, {})
                t[k] = t.get(k, 0) + 1
        super().__setitem__(k, v)


class CallClock:
    """Calls, wall seconds and thread CPU seconds spent in wrapped
    functions, by the thread that called them."""

    def __init__(self):
        self.by: dict = {}

    def wrap(self, fn):
        import threading

        def call(*a, **k):
            w, c = time.perf_counter(), time.thread_time()
            try:
                return fn(*a, **k)
            finally:
                rec = self.by.setdefault(threading.current_thread().name, [0, 0.0, 0.0])
                rec[0] += 1
                rec[1] += time.perf_counter() - w
                rec[2] += time.thread_time() - c
        return call

    def report(self) -> dict:
        return {t: dict(calls=n, wall_s=w, cpu_s=c) for t, (n, w, c) in self.by.items()}


def _thread_launches(gk, ck, thread: str) -> dict:
    out = {k: 0 for k in (*gk.LAUNCHES, *ck.LAUNCHES)}
    for mod in (gk, ck):
        out.update(getattr(mod.LAUNCHES, "by_thread", {}).get(thread, {}))
    return out


def _reset_thread_launches(gk, ck) -> None:
    _reset_launches(gk, ck)
    for mod in (gk, ck):
        mod.LAUNCHES.by_thread.clear()


def _plant_root_key(*dirs: str) -> None:
    """One root seal key for a replication pair's state dirs."""
    key = os.urandom(32)
    for d in dirs:
        os.makedirs(d)
        fd = os.open(f"{d}/root.key", os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o600)
        try:
            os.write(fd, key)
        finally:
            os.close(fd)


def _wait_for(pred, limit_s: float, what: str) -> float:
    t0 = time.perf_counter()
    while not pred():
        if time.perf_counter() - t0 > limit_s:
            raise AssertionError(f"phase 12: {what} took over {limit_s} s")
        time.sleep(0.005)
    return time.perf_counter() - t0


def _door(fn, exc, text: str, where: str) -> str:
    """Run ``fn``; it must raise ``exc`` with ``text`` in its message."""
    try:
        fn()
    except exc as e:
        if text not in str(e):
            raise AssertionError(f"{where}: raised {e!r}, expected {text!r}") from e
        return str(e)[:90]
    raise AssertionError(f"{where}: the door is open (no {exc.__name__})")


def model_apply(model: dict, reqs, resp) -> None:
    """msg_id → (sender, recipient, payload) after a round's successes."""
    from grapevine_tpu_torch.wire import constants as C

    for q, r in zip(reqs, resp):
        if r.status_code != C.STATUS_CODE_SUCCESS:
            continue
        mid = q.record.msg_id
        if q.request_type == C.REQUEST_TYPE_CREATE:
            model[r.record.msg_id] = (q.auth_identity, q.record.recipient, q.record.payload)
        elif q.request_type == C.REQUEST_TYPE_UPDATE:
            model[mid] = model[mid][:2] + (q.record.payload,)
        elif q.request_type == C.REQUEST_TYPE_DELETE:
            model.pop(mid)


def serve_promoted(eng, model: dict, seeds, gk, ck) -> dict:
    """Phase 12a's serving part: the promoted engine behind
    ``EngineServer(engine=...)`` and a ``FrontendServer`` on gRPC loopback.
    Each of TIER_CLIENTS clients reads back by id every message the dead
    primary acknowledged into its mailbox, then creates one for the next
    client, reads it by id, updates it and reads it back, and deletes one
    of its own; every response checked against the model."""
    import threading

    from grapevine_tpu_torch.server.client import GrapevineClient
    from grapevine_tpu_torch.server.tier import EngineServer, FrontendServer
    from grapevine_tpu_torch.wire import constants as C

    OK, NF = C.STATUS_CODE_SUCCESS, C.STATUS_CODE_NOT_FOUND
    engine = EngineServer(engine=eng, clock=lambda: STANDBY_NOW + 100)
    eport = engine.start("127.0.0.1:0")
    fe = FrontendServer(f"127.0.0.1:{eport}", config=eng.config)
    port = fe.start("insecure-grapevine://127.0.0.1:0")
    clients = [GrapevineClient(f"insecure-grapevine://127.0.0.1:{port}", identity_seed=s)
               for s in seeds]
    for c in clients:
        c.auth()
    n = len(clients)
    mine = [sorted(m for m, (_s, r, _p) in model.items() if r == c.public_key)
            for c in clients]
    if min(map(len, mine)) < 2:
        raise AssertionError(f"phase 12a: mailboxes of {list(map(len, mine))} messages")
    errors, counts = [], [0] * n
    rounds0, flushes0 = eng.metrics.snapshot()["rounds"], eng.flushes
    _reset_launches(gk, ck)

    def expect(r, status, want, where):
        counts[i_of[threading.current_thread().name]] += 1
        got = (r.record.sender, r.record.recipient, r.record.payload)
        if r.status_code != status or (want is not None and got != want):
            raise AssertionError(f"phase 12a serve {where}: status {r.status_code}, "
                                 f"expected {status}, or the record differs from the model")

    def script(i):
        c, nxt = clients[i], clients[(i + 1) % n]
        try:
            for mid in mine[i]:
                expect(c.read(mid), OK, model[mid], f"client {i} read-back")
            pay = _payload(170, i)
            r = c.create(nxt.public_key, pay)
            expect(r, OK, None, f"client {i} create")
            mid = r.record.msg_id
            expect(c.read(mid), OK, (c.public_key, nxt.public_key, pay), f"client {i} read")
            pay2 = _payload(171, i)
            expect(c.update(mid, nxt.public_key, pay2), OK, None, f"client {i} update")
            expect(c.read(mid), OK, (c.public_key, nxt.public_key, pay2), f"client {i} re-read")
            gone = mine[i][0]
            expect(c.delete(gone, c.public_key), OK, None, f"client {i} delete")
            expect(c.read(gone), NF, None, f"client {i} read of the deleted")
        except BaseException as exc:
            errors.append(exc)

    threads = [threading.Thread(target=script, args=(i,), name=f"sby-client-{i}")
               for i in range(n)]
    i_of = {t.name: i for i, t in enumerate(threads)}
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    serve_s = time.perf_counter() - t0
    launches = _launches(gk, ck)
    rounds = eng.metrics.snapshot()["rounds"] - rounds0
    flushes = eng.flushes - flushes0
    for c in clients:
        c.close()
    fe.stop()
    engine.stop()
    if errors:
        raise errors[0]
    require_launches(launches, {"gather_decrypt_rows": 3 * rounds,
                                "scatter_encrypt_rows": 2 * flushes}, "phase 12a serving")
    return dict(clients=n, read_back=sum(map(len, mine)), ops=sum(counts),
                responses_checked=sum(counts), rounds=rounds, flushes=flushes,
                serve_s=serve_s, launches=launches)


def run_standby_prod(GrapevineConfig, GrapevineEngine, geo: dict, gk, ck, card) -> dict:
    """Phase 12a: a primary ``GrapevineEngine`` at the production point
    (E=4 ``"pallas_fused"``, an fsync per record, depth 2) ships through
    ``JournalShipper`` to a ``StandbyReplica`` on the same card, over
    loopback; live rounds and a sweep, catch-up and leaf equality; the
    cut and a tail; the fenced promote; three doors; serving."""
    import shutil
    import tempfile

    from grapevine_tpu_torch.config import DurabilityConfig
    from grapevine_tpu_torch.engine import checkpoint as cp
    from grapevine_tpu_torch.engine import expiry
    from grapevine_tpu_torch.engine.journal import KIND_FLUSH, KIND_ROUND, JournalError
    from grapevine_tpu_torch.engine.replication import (
        JournalShipper,
        ReplicationError,
        StandbyReplica,
    )
    from grapevine_tpu_torch.session import get_signature_scheme

    cfg = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused", evict_every=EVICT_EVERY)
    dkw = dict(checkpoint_every_rounds=1 << 20, journal_fsync_every=1)
    b = cfg.batch_size
    seeds = [_key("sby", i) for i in range(TIER_CLIENTS)]
    scheme = get_signature_scheme(cfg.signature_scheme)
    tmp = tempfile.mkdtemp()
    pdir, sdir = f"{tmp}/primary", f"{tmp}/standby"
    _plant_root_key(pdir, sdir, f"{tmp}/loser")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_bytes = torch.cuda.memory_allocated()
    shipper = primary = replica = None
    seal, unseal = cp.seal, cp.unseal
    try:
        t0 = time.perf_counter()
        primary = GrapevineEngine(cfg, seed=SEED, durability=DurabilityConfig(
            state_dir=pdir, **dkw))
        replica = StandbyReplica(cfg, seed=SEED, durability=DurabilityConfig(
            state_dir=sdir, **dkw))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if primary.pipeline_depth != 2:
            raise AssertionError(f"phase 12a: the primary runs depth {primary.pipeline_depth}")
        # each applied frame's wall on the standby's thread, by kind, and
        # where it goes: the seal checks (the shipper's rescans of the
        # segment, the standby's decode), the local append, the replay
        apply_ms: dict = {"round": [], "flush": [], "sweep": []}
        replay_ms: dict = {"round": [], "flush": [], "sweep": []}
        kind_of = {KIND_ROUND: "round", KIND_FLUSH: "flush"}
        seen: list = []
        replay, apply_locked = replica.engine._replay_record, replica._apply_locked
        seals = CallClock()
        cp.seal, cp.unseal = seals.wrap(cp.seal), seals.wrap(cp.unseal)
        appends = CallClock()
        replica.dm.append_raw_frame = appends.wrap(replica.dm.append_raw_frame)
        primary_journal = JournalClock(primary.durability)

        def noted_replay(state, rec):
            kind = kind_of.get(rec.kind, "sweep")
            seen.append(kind)
            t = time.perf_counter()
            out = replay(state, rec)
            replay_ms[kind].append((time.perf_counter() - t) * 1e3)
            return out

        def timed_apply(seq, frame):
            t = time.perf_counter()
            out = apply_locked(seq, frame)
            if out:
                apply_ms[seen.pop()].append((time.perf_counter() - t) * 1e3)
            return out

        replica.engine._replay_record = noted_replay
        replica._apply_locked = timed_apply
        shipper = JournalShipper(primary, ("127.0.0.1", replica.listen()))
        shipper.start()
        stream = PipeStream(b)
        stream.recips[:TIER_CLIENTS] = [scheme.keygen(s)[1] for s in seeds]
        model: dict = {}
        gc.collect()
        _reset_thread_launches(gk, ck)
        call_s = []
        for k in range(STANDBY_CALLS):
            reqs, want = stream.call(k)
            t0 = time.perf_counter()
            resp = primary.handle_queries(reqs, STANDBY_NOW + k)
            call_s.append(time.perf_counter() - t0)
            _check_statuses(resp, want, f"phase 12a call {k}")
            stream.note(reqs, resp)
            model_apply(model, reqs, resp)
        trailing = primary.durability.seq - replica.dm.applied_seq
        t0 = time.perf_counter()
        evicted = primary.expire(*STANDBY_SWEEP)
        sweep_s = time.perf_counter() - t0
        catch_up_s = _wait_for(lambda: replica.dm.applied_seq == primary.durability.seq,
                               CATCH_UP_S, "the standby's catch-up")
        n_rounds = STANDBY_CALLS * PIPE_CHUNKS
        flushes = n_rounds // EVICT_EVERY
        per_sweep = 2 * sum(t.n_buckets_padded // expiry._chunk_rows(t)
                            for t in (primary.ecfg.rec, primary.ecfg.mb))
        want_l = {"gather_decrypt_rows": 3 * n_rounds, "scatter_encrypt_rows": 2 * flushes,
                  "cipher_rows_pallas": per_sweep}
        live = {"primary": _thread_launches(gk, ck, "MainThread"),
                "standby": _thread_launches(gk, ck, "standby-listener")}
        require_launches(live["primary"], want_l, "phase 12a primary")
        require_launches(live["standby"], want_l, "phase 12a standby applies")
        if evicted or primary.flushes != flushes:
            raise AssertionError(f"phase 12a: {evicted} evicted, {primary.flushes} flushes")
        with replica.engine._lock:
            diff = states_differ(primary.ecfg, primary.state, replica.engine.state)
        if diff is not None:
            raise AssertionError(f"phase 12a: the standby differs from the primary at {diff}")
        ship = shipper.stats()
        if ship["illegal_frames"] or not ship["cadence_ok"] \
                or ship["frames_shipped"] != primary.durability.seq:
            raise AssertionError(f"phase 12a: shipper books {ship}")
        live_apply = {k: list(v) for k, v in apply_ms.items()}
        breakdown = dict(
            seal_and_check=seals.report(), standby_append_raw=appends.report(),
            standby_replay_ms={k: dict(median=statistics.median(v), max=max(v))
                               for k, v in replay_ms.items() if v},
            primary_append_fsync_ms={k: statistics.median(v)
                                     for k, v in primary_journal.ms.items() if v})
        held_live = torch.cuda.memory_allocated() - base_bytes
        # the cut: the tail reaches the primary's disk only
        shipper.close()
        reqs, want = stream.call(STANDBY_CALLS)
        reqs, want = reqs[:STANDBY_TAIL * b], want[:STANDBY_TAIL * b]
        resp = primary.handle_queries(reqs, STANDBY_NOW + STANDBY_CALLS)
        _check_statuses(resp, want, "phase 12a tail")
        model_apply(model, reqs, resp)
        dead_seq = primary.durability.seq
        primary.close()
        _reset_thread_launches(gk, ck)
        info = replica.promote(primary_state_dir=pdir)
        require_launches(_thread_launches(gk, ck, "MainThread"),
                         {"gather_decrypt_rows": 3 * STANDBY_TAIL}, "phase 12a promote")
        promote_apply_ms = apply_ms["round"][len(live_apply["round"]):]
        if (info["epoch"], info["drained_frames"], info["applied_seq"]) != (
                1, STANDBY_TAIL, dead_seq):
            raise AssertionError(f"phase 12a: promote returned {info}")
        diff = states_differ(primary.ecfg, primary.state, replica.engine.state)
        if diff is not None:
            raise AssertionError(f"phase 12a: the promoted state differs from the dead "
                                 f"primary's at {diff}")
        held_both = torch.cuda.memory_allocated() - base_bytes
        peak_both = torch.cuda.max_memory_allocated() - base_bytes
        promote_launches = _launches(gk, ck)
        primary = None
        gc.collect()
        torch.cuda.empty_cache()
        doors = {
            "shipped_frame": _door(lambda: replica.apply_frame(replica.dm.seq + 1, bytes(64)),
                                   ReplicationError, "promoted", "phase 12a door 1"),
            "revived_primary": _door(lambda: GrapevineEngine(cfg, seed=SEED,
                                                             durability=DurabilityConfig(
                                                                 state_dir=pdir, **dkw)),
                                     JournalError, "fenced", "phase 12a door 2"),
        }
        gc.collect()
        torch.cuda.empty_cache()
        loser = StandbyReplica(cfg, seed=SEED, durability=DurabilityConfig(
            state_dir=f"{tmp}/loser", **dkw))
        doors["second_promote"] = _door(lambda: loser.promote(primary_state_dir=pdir),
                                        JournalError, "already fenced", "phase 12a door 3")
        loser.close()
        del loser
        gc.collect()
        torch.cuda.empty_cache()
        serving = serve_promoted(replica.engine, model, seeds, gk, ck)
        rnd_ms = sorted(s * 1e3 / PIPE_CHUNKS for s in call_s)
        every = [x for v in live_apply.values() for x in v]
        return dict(
            max_messages=cfg.max_messages, batch_size=b, evict_every=EVICT_EVERY,
            bucket_cipher_impl=cfg.bucket_cipher_impl, pipeline_depth=2, init_s=init_s,
            rounds=n_rounds, flushes=flushes, sweeps=1,
            primary_round_ms=rnd_ms, primary_median_round_ms=statistics.median(rnd_ms),
            apply_ms={k: dict(median=statistics.median(v), max=max(v), n=len(v))
                      for k, v in live_apply.items() if v},
            apply_median_ms=statistics.median(every), apply_max_ms=max(every),
            apply_ms_all=live_apply, sweep_s=sweep_s,
            frames_trailing_at_last_round=trailing, catch_up_s=catch_up_s,
            frames_shipped=ship["frames_shipped"], bytes_shipped=ship["bytes_shipped"],
            cadence_ok=ship["cadence_ok"], illegal_frames=ship["illegal_frames"],
            standby_equal=True, breakdown=breakdown, promote_apply_ms=promote_apply_ms,
            rto_ms=info["rto_seconds"] * 1e3,
            drained_frames=info["drained_frames"], applied_seq=info["applied_seq"],
            epoch=info["epoch"], promoted_equal=True, rpo_frames=0, doors=doors,
            held_bytes_both_live=held_live, held_bytes_both_after_promote=held_both,
            peak_bytes_both=peak_both, launches_live=live, launches_promote=promote_launches,
            serving=serving, phase_s=time.perf_counter() - t_phase, card=card)
    finally:
        cp.seal, cp.unseal = seal, unseal
        if shipper is not None:
            shipper.close()
        if replica is not None:
            replica.close()
        del primary, replica
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)


class _Proc:
    """A subprocess whose stdout lines are read by a thread; every wait on
    it has a wall limit, and a limit passed fails the phase."""

    def __init__(self, argv, log_path: str, name: str):
        import queue
        import threading

        self.name = name
        self.log_path = log_path
        self._err = open(log_path, "w")
        self.p = subprocess.Popen(argv, cwd=os.path.dirname(os.path.abspath(__file__)),
                                  stdout=subprocess.PIPE, stderr=self._err, text=True)
        self.lines: queue.Queue = queue.Queue()
        threading.Thread(target=self._pump, daemon=True).start()

    def _pump(self):
        for line in self.p.stdout:
            self.lines.put(line)
        self.lines.put(None)

    def expect(self, needle: str, limit_s: float) -> str:
        import queue

        deadline = time.perf_counter() + limit_s
        while True:
            try:
                line = self.lines.get(timeout=max(0.0, deadline - time.perf_counter()))
            except queue.Empty:
                raise AssertionError(f"phase 12b: no {needle!r} within {limit_s} s") from None
            if line is None:
                raise AssertionError(f"phase 12b: the process exited before {needle!r}: "
                                     f"{self.tail(2000)}")
            if needle in line:
                return line.strip()

    def tail(self, n: int) -> str:
        with open(self.log_path) as fh:
            return fh.read()[-n:]

    def close(self):
        if self.p.poll() is None:
            self.p.kill()
        self.p.wait(timeout=60)
        self._err.close()


#: log lines that mark a replication link dropped, by the side that logs them
LINK_EVENTS = ("replication feed dropped", "replication link lost", "Traceback")


def _link_events(log_path: str) -> dict:
    with open(log_path) as fh:
        text = fh.read()
    return {e: text.count(e) for e in LINK_EVENTS}


def _healthz(port: int) -> dict:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
            return json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return json.loads(e.read().decode())


def run_standby_runbook(card) -> dict:
    """Phase 12b: the runbook over real processes on the card, at 2^14
    messages, B=64, E=1, ``"pallas_fused_tiled"`` (B4 and B6 on the
    standby's replays and its promoted rounds; a CUDA tensor launches them
    or raises, so a run that passes ran them): an engine-role primary
    ships to a standby-role process; signed writes are acknowledged over
    gRPC; the primary is SIGKILLed and the standby SIGUSR1ed; every
    acknowledged write reads back from the promoted port."""
    import shutil
    import signal
    import tempfile

    from grapevine_tpu_torch.server.tier import _EngineStub
    from grapevine_tpu_torch.session import get_signature_scheme
    from grapevine_tpu_torch.wire import constants as C
    from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

    scheme = get_signature_scheme("schnorrkel")
    OK = C.STATUS_CODE_SUCCESS
    tmp = tempfile.mkdtemp()
    pdir, sdir = f"{tmp}/primary", f"{tmp}/standby"
    _plant_root_key(pdir, sdir)
    cli = [sys.executable, "-m", "grapevine_tpu_torch.server.cli", "--device", "cuda"]
    geometry = ["--msg-capacity", str(2**14), "--recipient-capacity", str(2**10),
                "--batch-size", "64", "--evict-every", "1",
                "--bucket-cipher-impl", "pallas_fused_tiled", "--batch-wait-ms", "20"]
    procs = []
    lag, pmport = {}, None
    t_phase = time.perf_counter()

    def signed(seed, rt, recipient, payload, challenge, msg_id=C.ZERO_MSG_ID):
        sk, pub = scheme.keygen(seed)
        sig = scheme.sign(sk, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge)
        req = QueryRequest(request_type=rt, auth_identity=pub, auth_signature=sig,
                           record=RequestRecord(msg_id=msg_id, recipient=recipient,
                                                payload=payload))
        return req, (pub, C.GRAPEVINE_CHALLENGE_SIGNING_CONTEXT, challenge, sig)

    try:
        t0 = time.perf_counter()
        standby = _Proc(cli + ["--role", "standby", "--state-dir", sdir, "--standby-listen",
                               "127.0.0.1:0", "--promote-from", pdir, "--engine-listen",
                               "127.0.0.1:0", "--metrics-port", "0"] + geometry,
                        f"{tmp}/standby.log", "standby")
        procs.append(standby)
        feed = int(standby.expect("standby replica on port", PROC_START_S).rsplit(" ", 1)[1])
        smport = int(standby.expect("metrics endpoint on port", PROC_STEP_S).rsplit(" ", 1)[1])
        standby_start_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        primary = _Proc(cli + ["--role", "engine", "--engine-listen", "127.0.0.1:0",
                               "--state-dir", pdir, "--replicate-to", f"127.0.0.1:{feed}",
                               "--metrics-port", "0"] + geometry, f"{tmp}/primary.log",
                        "primary")
        procs.append(primary)
        eport = int(primary.expect("engine tier listening on port", PROC_START_S)
                    .rsplit(" ", 1)[1])
        pmport = int(primary.expect("metrics endpoint on port", PROC_STEP_S).rsplit(" ", 1)[1])
        primary_start_s = time.perf_counter() - t0
        # acknowledged writes: 4 into mailbox X, 12 elsewhere
        x_seed = _key("sbx", 0)
        x_sk, x_pub = scheme.keygen(x_seed)
        stub = _EngineStub(f"127.0.0.1:{eport}", deadline_s=PROC_STEP_S)
        acked = []
        t0 = time.perf_counter()
        for i in range(16):
            rcp = x_pub if i < 4 else _key("sbr", i)
            req, auth = signed(_key("sbs", i), C.REQUEST_TYPE_CREATE, rcp, _payload(180, i),
                               bytes([i + 1]) * C.CHALLENGE_SIZE)
            r = stub.submit(req, auth=auth)
            if r.status_code != OK:
                raise AssertionError(f"phase 12b: write {i} got {r.status_code}")
            acked.append((i, r.record.msg_id, rcp))
        writes_s = time.perf_counter() - t0
        stub.close()
        seq = _healthz(pmport)["durability"]["journal_seq"]

        def caught_up():
            lag.update(_healthz(smport))
            return lag.get("replication_connected") and lag["durability"]["applied_seq"] >= seq

        catch_up_s = _wait_for(caught_up, PROC_STEP_S, "phase 12b's catch-up")
        primary.p.send_signal(signal.SIGKILL)
        primary.p.wait(timeout=PROC_STEP_S)
        t0 = time.perf_counter()
        standby.p.send_signal(signal.SIGUSR1)
        promoted = standby.expect("standby promoted: epoch", PROC_STEP_S)
        pport = int(standby.expect("promoted engine tier listening on port", PROC_STEP_S)
                    .rsplit(" ", 1)[1])
        flip_s = time.perf_counter() - t0
        if "epoch 1," not in promoted or not _healthz(smport)["promoted"]:
            raise AssertionError(f"phase 12b: {promoted}")
        stub = _EngineStub(f"127.0.0.1:{pport}", deadline_s=PROC_STEP_S)
        read_back = 0
        for i, mid, rcp in acked[4:]:
            req, auth = signed(_key("sbs", i), C.REQUEST_TYPE_READ, rcp, bytes(C.PAYLOAD_SIZE),
                               bytes([0x40 + i]) * C.CHALLENGE_SIZE, msg_id=mid)
            r = stub.submit(req, auth=auth)
            if r.status_code != OK or r.record.payload != _payload(180, i):
                raise AssertionError(f"phase 12b: acknowledged write {i} did not read back")
            read_back += 1
        for i in range(4):
            req, auth = signed(x_seed, C.REQUEST_TYPE_DELETE, C.ZERO_PUBKEY,
                               bytes(C.PAYLOAD_SIZE), bytes([0x80 + i]) * C.CHALLENGE_SIZE)
            r = stub.submit(req, auth=auth)
            if r.status_code != OK or r.record.payload != _payload(180, i):
                raise AssertionError(f"phase 12b: mailbox X pop {i} differs")
            read_back += 1
        req, auth = signed(_key("sbs", 99), C.REQUEST_TYPE_CREATE, _key("sbr", 99),
                           _payload(181, 0), b"\xaa" * C.CHALLENGE_SIZE)
        if stub.submit(req, auth=auth).status_code != OK:
            raise AssertionError("phase 12b: the promoted engine refused a new write")
        stub.close()
        standby.p.send_signal(signal.SIGTERM)
        rc = standby.p.wait(timeout=PROC_STEP_S)
        if rc != 0:
            raise AssertionError(f"phase 12b: the promoted standby exited {rc}")
        return dict(max_messages=2**14, batch_size=64, evict_every=1,
                    bucket_cipher_impl="pallas_fused_tiled", device="cuda",
                    standby_start_s=standby_start_s, primary_start_s=primary_start_s,
                    acked_writes=len(acked), writes_s=writes_s, journal_seq=seq,
                    catch_up_s=catch_up_s, promoted_line=promoted, flip_s=flip_s,
                    read_back=read_back, dropped=len(acked) - read_back,
                    link_events={p.name: _link_events(p.log_path) for p in procs},
                    phase_s=time.perf_counter() - t_phase, card=card)
    except Exception as exc:
        # the processes' logs die with the phase's directory: keep their
        # ends, and the standby's last health, in the failure
        tails = "".join(f"\n--- {p.name} log, last 3000 bytes ---\n{p.tail(3000)}"
                        for p in procs)
        try:
            primary_health = _healthz(pmport) if pmport else None
        except OSError as e:
            primary_health = repr(e)
        raise AssertionError(f"{exc}\nstandby health: {lag}\nprimary health: "
                             f"{primary_health}{tails}") from exc
    finally:
        for p in procs:
            p.close()
        shutil.rmtree(tmp, ignore_errors=True)


def run_standby_bootstrap(GrapevineConfig, GrapevineEngine, gk, ck, card) -> dict:
    """Phase 12c at 2^14 messages, B=64, E=4 ``"pallas_fused"``: the
    primary checkpoints mid-window before the standby first connects, so
    the standby gets the sealed checkpoint (MSG_CKPT) and installs it on
    the card, then follows 4 more rounds and a sweep, its applies launching
    B3/B5/B2 at their counts, and equals the primary leaf for leaf."""
    import shutil
    import tempfile

    import numpy as np

    from grapevine_tpu_torch.config import DurabilityConfig
    from grapevine_tpu_torch.engine import expiry
    from grapevine_tpu_torch.engine.replication import JournalShipper, StandbyReplica

    cfg = GrapevineConfig(max_messages=2**14, max_recipients=2**10, batch_size=64,
                          bucket_cipher_impl="pallas_fused", vphases_impl="dense",
                          evict_every=EVICT_EVERY)
    dkw = dict(checkpoint_every_rounds=1 << 20)
    tmp = tempfile.mkdtemp()
    pdir, sdir = f"{tmp}/primary", f"{tmp}/standby"
    _plant_root_key(pdir, sdir)
    rng = np.random.default_rng(SEED + 12)
    users = [_key("usr", i) for i in range(24)]
    created: list = []
    shipper = primary = replica = None
    try:
        primary = GrapevineEngine(cfg, seed=SEED, durability=DurabilityConfig(
            state_dir=pdir, **dkw))
        for rnd in range(6):
            reqs = mixed_requests(rng, users, created, rnd)
            note_created(reqs, primary.handle_queries(reqs, NOW + 10 * rnd), created)
        t0 = time.perf_counter()
        ck_seq = primary.checkpoint_now()
        write_ms = (time.perf_counter() - t0) * 1e3
        ck_bytes = os.path.getsize(f"{pdir}/ckpt-{ck_seq:016d}.sealed")
        replica = StandbyReplica(cfg, seed=SEED, durability=DurabilityConfig(
            state_dir=sdir, **dkw))
        installs = []
        install = replica.dm.install_checkpoint

        def timed_install(seq, blob):
            t = time.perf_counter()
            out = install(seq, blob)
            torch.cuda.synchronize()
            installs.append((seq, (time.perf_counter() - t) * 1e3))
            return out

        replica.dm.install_checkpoint = timed_install
        shipper = JournalShipper(primary, ("127.0.0.1", replica.listen()))
        _reset_thread_launches(gk, ck)
        t0 = time.perf_counter()
        shipper.start()
        _wait_for(lambda: replica.dm.applied_seq == ck_seq, CATCH_UP_S,
                  "phase 12c's checkpoint install")
        install_wall_s = time.perf_counter() - t0
        if [s for s, _ in installs] != [ck_seq] or replica.dm.ckpt_seq != ck_seq:
            raise AssertionError(f"phase 12c: installs {installs}, standby at "
                                 f"{replica.dm.ckpt_seq}, checkpoint {ck_seq}")
        flushes0 = primary.flushes
        for rnd in range(6, 10):
            reqs = mixed_requests(rng, users, created, rnd)
            note_created(reqs, primary.handle_queries(reqs, NOW + 10 * rnd), created)
        evicted = primary.expire(NOW + 55, 30)
        _wait_for(lambda: replica.dm.applied_seq == primary.durability.seq, CATCH_UP_S,
                  "phase 12c's catch-up")
        per_sweep = 2 * sum(t.n_buckets_padded // expiry._chunk_rows(t)
                            for t in (primary.ecfg.rec, primary.ecfg.mb))
        standby_l = _thread_launches(gk, ck, "standby-listener")
        require_launches(standby_l, {"gather_decrypt_rows": 3 * 4,
                                     "scatter_encrypt_rows": 2 * (primary.flushes - flushes0),
                                     "cipher_rows_pallas": per_sweep},
                         "phase 12c standby applies")
        if not evicted:
            raise AssertionError("phase 12c: the sweep evicted nothing")
        with replica.engine._lock:
            diff = states_differ(primary.ecfg, primary.state, replica.engine.state)
        if diff is not None:
            raise AssertionError(f"phase 12c: the bootstrapped standby differs at {diff}")
        return dict(max_messages=cfg.max_messages, batch_size=cfg.batch_size,
                    evict_every=EVICT_EVERY, bucket_cipher_impl=cfg.bucket_cipher_impl,
                    checkpoint_seq=ck_seq, checkpoint_bytes=ck_bytes,
                    checkpoint_write_ms=write_ms, install_ms=installs[0][1],
                    install_wall_s=install_wall_s, frames_after=primary.durability.seq - ck_seq,
                    evicted=evicted, standby_launches=standby_l, standby_equal=True,
                    card=card)
    finally:
        if shipper is not None:
            shipper.close()
        if primary is not None:
            primary.close()
        if replica is not None:
            replica.close()
        del primary, replica
        gc.collect()
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)


def run_standby_phase(GrapevineConfig, GrapevineEngine, geo: dict, gk, ck, card) -> dict:
    """Phase 12 (a, b, c) with the launch counts kept by thread, so the
    standby's applies are counted apart from the primary's rounds."""
    originals = gk.LAUNCHES, ck.LAUNCHES
    gk.LAUNCHES, ck.LAUNCHES = ThreadLaunches(gk.LAUNCHES), ThreadLaunches(ck.LAUNCHES)
    try:
        a = run_standby_prod(GrapevineConfig, GrapevineEngine, geo, gk, ck, card)
        c = run_standby_bootstrap(GrapevineConfig, GrapevineEngine, gk, ck, card)
    finally:
        for mod, orig in zip((gk, ck), originals):
            orig.update(mod.LAUNCHES)
            mod.LAUNCHES = orig
    b = run_standby_runbook(card)
    return dict(a=a, b=b, c=c)


#: phase 13: the serving tier with every round observer the reference
#: attaches to a production engine. 13a at the production point (phase
#: 11b's stream through the server's own scheduler), 13b the engine tier at
#: 2^14 behind a frontend, and a fleet aggregator over both metrics ports
OBS_NOW = NOW + 12000
#: 13a's enforced SLO target, in multiples of phase 11b's median wall
#: between dispatches in the same run: an op's commit waits up to
#: SERVE_LOOKAHEAD rounds of queue, so honest rounds stay inside it
OBS_SLO_FACTOR = 10
#: 13a's dispatches OBS_GUARD[0] to OBS_GUARD[1] - 1 (0-based) run under
#: set_sync_debug_mode("error"); the profiler gate's capture brackets
#: dispatch OBS_PROFILE_AT, which closes the third window (its flush
#: launches B5), outside the guard
OBS_GUARD, OBS_PROFILE_AT, OBS_PROFILE_MS = (2, 10), 11, 300
#: the metric families the reference's attach_round_observability
#: registers (cost monitor, workload telemetry, SLO tracker, round
#: tracer); tests/test_torch_observability_jax.py holds this list equal
#: to the reference's
OBS_FAMILIES = (
    "grapevine_cost_bandwidth_gbps", "grapevine_cost_phase_cipher_rows",
    "grapevine_cost_phase_gather_rows", "grapevine_cost_phase_hbm_bytes",
    "grapevine_cost_phase_scatter_rows", "grapevine_cost_phase_sort_keys",
    "grapevine_cost_roofline_floor_ms", "grapevine_cost_roofline_residual",
    "grapevine_cost_roofline_residual_max", "grapevine_cost_steady_round_hbm_bytes",
    "grapevine_load_arrival_rate_ops_s", "grapevine_load_arrivals_total",
    "grapevine_load_backpressure_arrivals_total", "grapevine_load_batch_fill",
    "grapevine_load_phase_utilization", "grapevine_load_queue_depth",
    "grapevine_load_saturated_rounds_total", "grapevine_slo_alert",
    "grapevine_slo_breaches_total", "grapevine_slo_burn_rate_fast",
    "grapevine_slo_burn_rate_slow", "grapevine_slo_commit_latency_seconds",
    "grapevine_slo_rounds_total", "grapevine_slo_target_ms",
    "grapevine_trace_ring_rounds", "grapevine_trace_rounds_total",
    "grapevine_round_bubble_ratio",
)
#: the achieved-bandwidth calibration's copy: bytes read (as many written)
HBM_COPY_BYTES = 2 << 30


def hbm_copy_gbps(n_bytes: int = HBM_COPY_BYTES, reps: int = 5) -> dict:
    """Achieved device-memory bandwidth: a device-to-device copy of
    ``n_bytes`` (read once, written once), best of ``reps`` by CUDA events
    after one warm-up copy. Phase 13a's ``cost_calibrate``."""
    src = torch.ones(n_bytes // 4, dtype=torch.int32, device="cuda")
    dst = torch.empty_like(src)
    dst.copy_(src)
    ms = []
    for _ in range(reps):
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        dst.copy_(src)
        t1.record()
        t1.synchronize()
        ms.append(t0.elapsed_time(t1))
    if not torch.equal(dst[-4:], src[-4:]):
        raise AssertionError("phase 13a: the bandwidth copy is wrong")
    del src, dst
    torch.cuda.empty_cache()
    best = min(ms)
    return dict(bytes_read=n_bytes, bytes_moved=2 * n_bytes, reps=reps, ms=ms, best_ms=best,
                gbps=2 * n_bytes / (best / 1e3) / 1e9)


class SyncGuard:
    """Run an engine's dispatches number ``first`` to ``last - 1`` (0-based,
    counted here) and the flush their lock hold closes under
    ``torch.cuda.set_sync_debug_mode("error")``: any synchronizing call in
    the upload, the admission decision, the round, the flush or the output
    copies (the transcript's included) raises in the dispatching thread.
    The wrappers sit inside the engine lock (``_dispatch_round`` and
    ``_flush_window_locked``), so a sweep or a scrape on another thread,
    which take the same lock, never runs under the guard. The admission
    bound's exact read, the one sync allowed, is counted by dispatch (a
    sweep's read of the same values, under the lock between dispatches,
    is not a dispatch's)."""

    def __init__(self, eng, first: int, last: int):
        self.eng, self.first, self.last = eng, first, last
        self.n = self.guarded = 0
        self.on = self.dispatching = False
        self.fallback_reads: list = []

    def install(self) -> None:
        eng = self.eng
        dispatch, flush, read = (eng._dispatch_round, eng._flush_window_locked,
                                 eng._read_bound_locked)

        def guarded(fn, *a, **k):
            if not self.on:
                return fn(*a, **k)
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        def dispatch_round(*a, **k):
            self.on = self.first <= self.n < self.last
            self.guarded += self.on
            self.n += 1
            self.dispatching = True
            try:
                return guarded(dispatch, *a, **k)
            finally:
                self.dispatching = False

        def flush_window_locked(*a, **k):
            try:
                return guarded(flush, *a, **k)
            finally:
                self.on = False

        def counted_read():
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return read()
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                if self.dispatching:
                    self.fallback_reads.append(self.n - 1)

        eng._dispatch_round = dispatch_round
        eng._flush_window_locked = flush_window_locked
        eng._read_bound_locked = counted_read

    def remove(self) -> None:
        del self.eng._dispatch_round, self.eng._flush_window_locked
        del self.eng._read_bound_locked


def _get(url: str):
    """(status, body bytes) of a GET; an HTTP error status is a result."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def obs_endpoints(url: str, rounds: int, where: str) -> dict:
    """/leakaudit 200 PASS, /flightrec holding every round, /trace as
    Chrome trace JSON with one round per seq, /healthz 200 with the SLO
    and the leak fold, and /metrics with every reference family."""
    from grapevine_tpu_torch.obs import parse_exposition

    st, body = _get(f"{url}/leakaudit")
    audit = json.loads(body)
    if st != 200 or audit["verdict"] != "PASS" or audit["rounds_observed"] != rounds \
            or audit["rounds_dropped"]:
        raise AssertionError(f"{where}: /leakaudit {st} {audit['verdict']}, "
                             f"{audit['rounds_observed']} of {rounds} rounds")
    st, body = _get(f"{url}/flightrec")
    if st != 200 or json.loads(body)["retained"] != rounds:
        raise AssertionError(f"{where}: /flightrec {st}")
    st, body = _get(f"{url}/trace")
    trace = json.loads(body)
    seqs = {e["args"]["seq"] for e in trace["traceEvents"] if e["ph"] == "X"}
    if st != 200 or len(seqs) != rounds or trace["otherData"]["rounds_recorded_total"] != rounds:
        raise AssertionError(f"{where}: /trace {st}, {len(seqs)} rounds of {rounds}")
    st, body = _get(f"{url}/healthz")
    hz = json.loads(body)
    if st != 200 or hz.get("leakaudit") != "PASS" or "slo" not in hz:
        raise AssertionError(f"{where}: /healthz {st} {hz}")
    st, body = _get(f"{url}/metrics")
    fams = parse_exposition(body.decode())
    missing = [f for f in OBS_FAMILIES if f not in fams]
    if st != 200 or missing:
        raise AssertionError(f"{where}: /metrics lacks {missing}")
    return dict(leakaudit=dict(status=200, verdict=audit["verdict"],
                               detectors={f"{d['name']}/{d['tree']}": d["statistic"]
                                          for d in audit["detectors"]}),
                trace_events=len(trace["traceEvents"]), trace_rounds=len(seqs),
                bubble_ratio=trace["otherData"]["bubble_ratio"],
                healthz=dict(status=200, healthy=hz["healthy"], leakaudit=hz["leakaudit"],
                             slo={k: hz["slo"][k] for k in ("ok", "enforced", "target_ms",
                                                            "fast_burn_rate", "fast_rounds")}),
                metric_families=len(fams), reference_families_present=len(OBS_FAMILIES))


def leak_canary(eng, seen: list) -> dict:
    """A second EngineLeakMonitor (its own registry and endpoint) fed the
    rounds phase 13a's monitor saw with the records column fixed at leaf
    0: its uniformity detector turns SUSPECT and ``/leakaudit`` 503."""
    from grapevine_tpu_torch.obs import MetricsServer, TelemetryRegistry
    from grapevine_tpu_torch.obs.leakmon import EngineLeakMonitor

    ecfg = eng.ecfg
    d = ecfg.mb_choices
    canary = EngineLeakMonitor(ecfg.mb.leaves, ecfg.rec.leaves, d, registry=TelemetryRegistry())
    try:
        for batch, tr in seen:
            tr = tr.copy()
            tr[:, d] = 0
            canary.submit_round(batch, tr, ecfg.batch_size, ecfg.batch_size)
        if not canary.flush(60):
            raise AssertionError("phase 13a: the canary monitor did not drain")
        v = canary.verdict()
        srv = MetricsServer(TelemetryRegistry(), health=lambda: (True, {}), port=0,
                            leakaudit=canary.verdict)
        st, body = _get(f"http://127.0.0.1:{srv.start()}/leakaudit")
        srv.stop()
    finally:
        canary.close()
    tripped = [f"{x['name']}/{x['tree']}" for x in v["detectors"] if x["verdict"] == "SUSPECT"]
    if v["verdict"] != "SUSPECT" or "uniformity/rec" not in tripped or st != 503 \
            or json.loads(body)["verdict"] != "SUSPECT":
        raise AssertionError(f"phase 13a: the fixed-leaf canary got {v['verdict']}, {st}")
    return dict(verdict=v["verdict"], status=st, tripped=tripped, rounds=len(seen))


def run_observability_phase(GrapevineConfig, geo: dict, gk, ck, card, serve_b: dict) -> dict:
    """Phase 13. (a) A ``GrapevineServer`` at the production point, E=4
    ``"pallas_fused"``, durable (an fsync per record), depth 2, its expiry
    thread running, with the leak monitor, an enforced SLO (OBS_SLO_FACTOR
    times phase 11b's median wall), the adaptive window and the profiler
    gate, ``GRAPEVINE_COST_GBPS`` set from this run's copy bandwidth
    (the expiry thread sweeps until the capture below);
    ``start_metrics`` runs the sort and posmap calibrations (their seconds,
    wall and the memory they add on top of the engine); phase 11b's stream
    through the server's scheduler, every response checked, with
    dispatches OBS_GUARD under the sync guard (the transcript rides the
    round's copies and event) and a ``/profile?ms=OBS_PROFILE_MS`` capture
    around dispatch OBS_PROFILE_AT (B3, B5 in its trace; a second request
    409); then the endpoints, the fixed-leaf canary, the costmon residual
    of each round and the leak monitor's thread CPU, beside phase 11b's
    numbers. (b) An ``EngineServer`` at 2^14, E=1 ``"pallas_fused_tiled"``,
    with the leak monitor and tracer, behind a ``FrontendServer`` (phase
    11c's clients); a ``FleetAggregator`` over (a)'s and (b)'s metrics
    ports: merged family count, ``healthz``, ``leakaudit`` and lag."""
    import shutil
    import tempfile
    import threading

    from grapevine_tpu_torch.config import DurabilityConfig
    from grapevine_tpu_torch.engine import expiry
    from grapevine_tpu_torch.obs import FleetAggregator, FleetConfig, parse_exposition
    from grapevine_tpu_torch.obs.leakmon import LeakMonitorConfig
    from grapevine_tpu_torch.obs.slo import SloConfig
    from grapevine_tpu_torch.server.service import GrapevineServer

    t_phase = time.perf_counter()
    bw = hbm_copy_gbps()
    os.environ["GRAPEVINE_COST_GBPS"] = repr(bw["gbps"])
    target_ms = OBS_SLO_FACTOR * serve_b["median"]["wall_ms"]
    tmp = tempfile.mkdtemp()
    cfg = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused", evict_every=EVICT_EVERY,
                          expiry_period=10)
    dcfg = DurabilityConfig(state_dir=f"{tmp}/state", checkpoint_every_rounds=1 << 20,
                            journal_fsync_every=1)
    server = None
    try:
        t0 = time.perf_counter()
        server = GrapevineServer(cfg, seed=SEED, clock=lambda: OBS_NOW, durability=dcfg,
                                 leakmon=LeakMonitorConfig(),
                                 slo=SloConfig(commit_p99_ms=target_ms),
                                 adaptive_batch=True, profile_enable=True)
        eng = server.engine
        if eng.pipeline_depth != 2:
            raise AssertionError(f"phase 13a: the engine runs depth {eng.pipeline_depth}")
        server.start("insecure-grapevine://127.0.0.1:0")
        init_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mport = server.start_metrics(0)
        calib_wall_s = time.perf_counter() - t0
        snap = eng.metrics.snapshot()
        calib = {ph: snap[f"grapevine_phase_seconds{{phase={ph}}}_sum"] for ph in ("sort",
                                                                              "posmap")}
        if any(snap[f"grapevine_phase_seconds{{phase={ph}}}_count"] != 1 for ph in calib):
            raise AssertionError(f"phase 13a: calibrations {calib}")
        calibration = dict(sort_s=calib["sort"], posmap_s=calib["posmap"],
                           wall_s=calib_wall_s, engine_held_bytes=held,
                           peak_added_bytes=torch.cuda.max_memory_allocated() - held)
        url = f"http://127.0.0.1:{mport}"
        # a first, 1 ms capture pays the profiler's one-time start-up in
        # this process before any round is timed
        t0 = time.perf_counter()
        st, body = _get(f"{url}/profile?ms=1")
        if st != 200:
            raise AssertionError(f"phase 13a: the warm-up capture got {st} {body[:200]}")
        shutil.rmtree(json.loads(body)["trace_dir"], ignore_errors=True)
        warm_capture_s = time.perf_counter() - t0
        lm = server.leakmon
        clock = CallClock()
        lm._process = clock.wrap(lm._process)
        seen: list = []
        submit = lm.submit_round

        def keep(batch, transcript, *a, **k):
            seen.append((batch, transcript))
            return submit(batch, transcript, *a, **k)

        lm.submit_round = keep
        device_ms: list = []  # each round's device span, which the monitor scores
        observe = eng.costmon.observe_round

        def scored(spans):
            observe(spans)
            device_ms.append(spans["device"][1] * 1e3)

        eng.costmon.observe_round = scored
        cap, waiters = {}, []

        def capture():
            st, body = _get(f"{url}/profile?ms={OBS_PROFILE_MS}")
            cap["first"] = (st, json.loads(body) if st == 200 else body[:200])

        def second():
            cap["second"] = _get(f"{url}/profile?ms=10")[0]

        def on_dispatch(k):
            if k != OBS_PROFILE_AT:
                return
            # the expiry thread stops here (waiting out a sweep in
            # progress): a sweep holds the engine lock for up to ~300 ms
            # and would push this round out of the capture's window
            server._expiry_stop.set()
            server._expiry_thread.join(timeout=60)
            waiters.append(threading.Thread(target=capture, name="profile-first"))
            waiters[-1].start()
            # this round's kernels (and its flush's) land in the capture
            if not server.profiler.live.wait(60):
                raise AssertionError("phase 13a: the profiler gate never started")
            waiters.append(threading.Thread(target=second, name="profile-second"))
            waiters[-1].start()

        sweep_s0 = eng.metrics.snapshot()["grapevine_phase_seconds{phase=sweep}_sum"]
        guard = SyncGuard(eng, *OBS_GUARD)
        guard.install()
        try:
            part = serve_rounds(eng, gk, ck, card, sched=server.scheduler,
                                on_dispatch=on_dispatch)
        finally:
            guard.remove()
            for t in waiters:
                t.join(timeout=120)
        if server._expiry_thread.is_alive():
            raise AssertionError("phase 13a: the expiry thread outlived the capture")
        launches = _launches(gk, ck)
        rounds, flushes = part["rounds"], part["flushes"]
        snap = eng.metrics.snapshot()
        sweeps = snap["sweeps"] - part["sweeps_at_reset"]
        sweep_s = snap["grapevine_phase_seconds{phase=sweep}_sum"] - sweep_s0
        per_sweep = 2 * sum(t.n_buckets_padded // expiry._chunk_rows(t)
                            for t in (eng.ecfg.rec, eng.ecfg.mb))
        require_launches(launches, {"gather_decrypt_rows": 3 * rounds,
                                    "scatter_encrypt_rows": 2 * flushes,
                                    "cipher_rows_pallas": per_sweep * sweeps}, "phase 13a")
        if guard.guarded != OBS_GUARD[1] - OBS_GUARD[0]:
            raise AssertionError(f"phase 13a: {guard.guarded} guarded dispatches")
        if not lm.flush(120):
            raise AssertionError("phase 13a: the leak monitor did not drain")
        if len(seen) != rounds:
            raise AssertionError(f"phase 13a: the monitor got {len(seen)} of {rounds} rounds")
        st, prof = cap.get("first", (None, None))
        if st != 200 or cap.get("second") != 409:
            raise AssertionError(f"phase 13a: /profile {st} {prof}, second {cap.get('second')}")
        with open(os.path.join(prof["trace_dir"], "trace.json")) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
        profiled = {name: sum(1 for e in events if e.get("cat") == "kernel"
                              and f"ring_kernel<{inst}>" in e["name"])
                    for name, inst in (("gather_decrypt_rows", "128, 1, 1"),
                                       ("scatter_encrypt_rows", "128, 1, 0"))}
        if not all(profiled.values()):
            raise AssertionError(f"phase 13a: the capture's kernels lack B3/B5: {profiled}")
        shutil.rmtree(prof["trace_dir"], ignore_errors=True)
        endpoints = obs_endpoints(url, rounds, "phase 13a")
        canary = leak_canary(eng, seen)
        lm_cpu = clock.report()
        health = server.health()
        if health["stash_overflow"]:
            raise AssertionError("phase 13a: stash overflow")
        residual_max = eng.metrics.registry.snapshot()["grapevine_cost_roofline_residual_max"]
        if abs(residual_max - max(device_ms) / eng.costmon.floor_ms) > 1e-9 * residual_max:
            raise AssertionError(f"phase 13a: residual max {residual_max}")
        part_a = dict(
            rounds=rounds, flushes=flushes, sweeps=sweeps, sweep_s=sweep_s,
            batch_size=part["batch_size"],
            responses_checked=part["responses_checked"], init_s=init_s,
            slo_target_ms=target_ms, hbm_copy=bw, cost_bandwidth_gbps=eng.costmon.bandwidth_gbps,
            cost_floor_ms=eng.costmon.floor_ms,
            residual_per_round=[d / eng.costmon.floor_ms for d in device_ms],
            device_span_ms_per_round=device_ms, calibration=calibration,
            sync_guarded_dispatches=guard.guarded, fallback_reads=guard.fallback_reads,
            profile=dict(ms=prof["ms"], status=st, second_status=cap["second"],
                         warm_up_capture_s=warm_capture_s,
                         events=len(events), kernel_names=len(kernels),
                         kernel_events=profiled),
            leakmon_thread=lm_cpu, leak_verdict=lm.verdict()["verdict"],
            canary=canary, endpoints=endpoints,
            adaptive_decisions={k.split("=")[1][:-1]: v for k, v in snap.items()
                                if k.startswith("grapevine_host_adaptive_decisions_total")},
            beside_11b=dict(
                round_wall_median_ms=(serve_b["median"]["wall_ms"], part["median"]["wall_ms"]),
                round_wall_max_ms=(serve_b["max_wall_ms"], part["max_wall_ms"]),
                ops_per_s=(serve_b["ops_per_s"], part["ops_per_s"]),
                verify_median_ms=(serve_b["median"]["verify_ms"], part["median"]["verify_ms"]),
                dispatch_median_ms=(serve_b["median"]["dispatch_ms"],
                                    part["median"]["dispatch_ms"]),
                settle_median_ms=(serve_b["median"]["settle_ms"], part["median"]["settle_ms"]),
                leakmon_cpu_s_per_round=(None, sum(v["cpu_s"] for v in lm_cpu.values())
                                         / rounds)),
            per_round=part["per_round"], launches=launches, card=card)
        geo_b = dict(max_messages=2**14, max_recipients=2**10, batch_size=64,
                     vphases_impl="dense")

        def fleet_view(engine_server) -> dict:
            mport_b = engine_server.start_metrics(0)
            rounds_b = engine_server.engine.metrics.snapshot()["rounds"]
            if not engine_server.leakmon.flush(60):
                raise AssertionError("phase 13b: the leak monitor did not drain")
            ep_b = obs_endpoints(f"http://127.0.0.1:{mport_b}", rounds_b, "phase 13b")
            agg = FleetAggregator(FleetConfig(members=(f"127.0.0.1:{mport}",
                                                       f"127.0.0.1:{mport_b}"),
                                              scrape_interval_s=0.5))
            t_s = time.perf_counter()
            agg.scrape_once()
            scrape_s = time.perf_counter() - t_s
            fport = agg.serve(0)
            try:
                furl = f"http://127.0.0.1:{fport}"
                st_m, body = _get(f"{furl}/metrics")
                fams = parse_exposition(body.decode())
                st_h, hz = _get(f"{furl}/healthz")
                st_l, la = _get(f"{furl}/leakaudit")
                hz, la = json.loads(hz), json.loads(la)
                fsnap = agg.registry.snapshot()
            finally:
                agg.stop()
            if st_m != 200 or not all(f in fams for f in OBS_FAMILIES):
                raise AssertionError(f"phase 13b: the fleet's /metrics {st_m}")
            if st_l != 200 or [m["verdict"] for m in la["members"]] != ["PASS", "PASS"]:
                raise AssertionError(f"phase 13b: the fleet's /leakaudit {st_l} {la}")
            if st_h != 200 or not all(m["up"] for m in hz["members"]):
                raise AssertionError(f"phase 13b: the fleet's /healthz {st_h} {hz}")
            lag = {k: v for k, v in fsnap.items()
                   if k.startswith(("grapevine_fleet_journal_lag",
                                    "grapevine_fleet_member_stale_age"))}
            return dict(endpoints=ep_b, fleet=dict(
                merged_families=len(fams), healthz=dict(status=st_h, healthy=hz["healthy"],
                                                       members=hz["members"]),
                leakaudit=dict(status=st_l, verdict=la["verdict"],
                               members=[m["verdict"] for m in la["members"]]),
                scrape_once_s=scrape_s, lag=lag))

        part_b = serve_tier(GrapevineConfig, geo_b, gk, ck, card,
                            engine_kw=dict(leakmon=LeakMonitorConfig(), trace_ring_size=64),
                            before_stop=fleet_view, where="phase 13b")
        server.stop(checkpoint=False)
        server = None
    finally:
        if server is not None:
            server.stop(checkpoint=False)
        os.environ.pop("GRAPEVINE_COST_GBPS", None)
        shutil.rmtree(tmp, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()
    return dict(a=part_a, b=part_b, phase_s=time.perf_counter() - t_phase)


#: phase 14: the recursive position map and the radix sort at the
#: production point, each slice beside a flat, "xla" twin from the seed
POSMAP_KNOBS = dict(posmap_impl="recursive", sort_impl="radix")


def _record_responses(eng) -> list:
    """Keep every response of ``eng.handle_queries`` (packed, per call)."""
    log: list = []
    real = eng.handle_queries

    def handle(reqs, now):
        resp = real(reqs, now)
        log.append([r.pack() for r in resp])
        return resp

    eng.handle_queries = handle
    return log


def _new_engine(GrapevineEngine, cfg, logs: list):
    """A production engine (seed ``SEED``) with its responses recorded
    into ``logs``; returns it with its init seconds and the device bytes
    it holds once built."""
    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = GrapevineEngine(cfg, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    logs.append(_record_responses(eng))
    return eng, init_s, torch.cuda.memory_allocated() - m0


def posmap_twin_check(convert, eng, twin, where: str) -> None:
    """A recursive/radix engine against its flat/"xla" twin: every payload
    leaf (the trees, stashes, buffers, nonces, keys, epochs, freelist and
    counters; junk bucket masked) and the generator equal, and each
    recursive map's logical table equal to the twin's flat table."""
    import numpy as np

    from grapevine_tpu_torch.oram.posmap import read_table

    def payload(e):
        return {k: v for k, v in convert.to_numpy(e.state).items()
                if ".posmap" not in k and not k.endswith("_leaf")}

    diff = convert.first_difference(payload(eng), payload(twin), mask_junk=True)
    if diff is not None:
        raise AssertionError(f"{where}: the payload state differs from the twin's at {diff}")
    if not torch.equal(eng.state.rng.get_state(), twin.state.rng.get_state()):
        raise AssertionError(f"{where}: the generator differs from the twin's")
    for t in ("rec", "mb"):
        mine = read_table(getattr(eng.ecfg, t), getattr(eng.state, t).posmap)
        flat = read_table(getattr(twin.ecfg, t), getattr(twin.state, t).posmap)
        if not np.array_equal(mine, flat):
            raise AssertionError(f"{where}: the {t} position table differs from the twin's")
        if int(getattr(eng.state, t).posmap.inner.overflow):
            raise AssertionError(f"{where}: the {t} internal ORAM overflowed")


def radix_bench(ecfg) -> dict:
    """``radix_rank`` against the comparison sort on the card (CUDA events,
    20 launches) at each eviction working set of the round: records,
    mailbox and the records map's internal round, keys below 2^height."""
    from grapevine_tpu_torch.oblivious.radix import radix_rank
    from grapevine_tpu_torch.oram.posmap import inner_oram_config
    from grapevine_tpu_torch.u32 import widen

    b, d = ecfg.batch_size, ecfg.mb_choices
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for name, cfg, nb in (("records", ecfg.rec, b), ("mailbox", ecfg.mb, b * d),
                          ("records_map", inner_oram_config(ecfg.rec.posmap), b)):
        w = cfg.stash_size + nb * cfg.path_len * cfg.bucket_slots + nb
        keys = torch.randint(0, cfg.leaves, (w,), generator=gen, device="cuda").to(torch.int32)
        out[name] = dict(keys=w, key_bits=cfg.height + 1,
                         radix_ms=cuda_ms(lambda: radix_rank(keys, cfg.height + 1), 20),
                         sort_ms=cuda_ms(lambda: torch.sort(widen(keys), stable=True), 20))
    return out


def _span_ms(prof: dict) -> dict:
    return {k: prof["span_device_ms"].get(k) for k in POSMAP_SPANS}


def run_posmap_phase(GrapevineConfig, GrapevineEngine, convert, geo: dict, gk, ck,
                     card) -> dict:
    """Phase 14: ``posmap_impl="recursive"``, ``sort_impl="radix"`` at the
    production point, each slice run first by a flat, ``"xla"`` twin from
    the same seed and requests: (a) E=1 ``"pallas_fused_tiled"``, 7 rounds
    of phase 6's CRUD (B4, B6), the 3rd to 6th dispatches at depth 2 under
    ``set_sync_debug_mode("error")``; (b) E=4 ``"pallas_fused"``, 4 windows
    (B3, B5; the internal trees flush inside each flush); (c) phase 8's
    sweep on (b)'s engine (B2 for the rows, the plain keystream for the
    leaf plane). Every response is checked against the dict model and
    equals the twin's; the payload state and the position tables equal the
    twin's after each slice."""
    from grapevine_tpu_torch.oram.posmap import posmap_hbm_bytes, posmap_private_bytes

    t_phase = time.perf_counter()
    out: dict = {}
    # (a) E=1, the tiled kernels
    cfg_t = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused_tiled")
    cfg_r = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused_tiled", **POSMAP_KNOBS)
    logs: list = []
    twin, _, twin_mem = _new_engine(GrapevineEngine, cfg_t, logs)
    t_rounds, _, t_prof, *_ = run_slice(twin, 7, writes=True, profile_last=True)
    torch.cuda.reset_peak_memory_stats()
    eng, init_s, rec_mem = _new_engine(GrapevineEngine, cfg_r, logs)
    if eng.pipeline_depth != 2:
        raise AssertionError(f"phase 14a: the engine runs depth {eng.pipeline_depth}")
    guard = SyncGuard(eng, 2, 6)
    guard.install()
    _reset_launches(gk, ck)
    rounds, health, prof, *_ = run_slice(eng, 7, writes=True, profile_last=True)
    launches_a = _launches(gk, ck)
    guard.remove()
    require_launches(launches_a, {"gather_decrypt_rows_tiled": 21,
                                  "scatter_encrypt_rows_tiled": 21}, "phase 14a")
    # the admission bound's exact read is the one sync a dispatch may make
    # (a fresh engine's first); none of the guarded ones may
    guarded_reads = [i for i in guard.fallback_reads if guard.first <= i < guard.last]
    if guard.guarded != 4 or guarded_reads:
        raise AssertionError(f"phase 14a: {guard.guarded} guarded dispatches, exact "
                             f"reads in dispatches {guard.fallback_reads}")
    if logs[0] != logs[1]:
        raise AssertionError("phase 14a: the responses differ from the twin's")
    posmap_twin_check(convert, eng, twin, "phase 14a")
    line_a = slice_stats(cfg_r, rounds, health, init_s, launches_a, card)
    twin_ms = sorted(r["s"] * 1e3 for r in t_rounds[1:] if not r.get("profiled"))
    line_a.update(
        guarded_dispatches=guard.guarded, host_syncs=0,
        exact_reads=guard.fallback_reads,
        max_round_ms=max(line_a["round_ms"][1:]),
        span_device_ms=_span_ms(prof), round_device_ms=prof["device_ms"],
        twin=dict(median_round_ms=statistics.median(twin_ms), max_round_ms=max(twin_ms),
                  span_device_ms=_span_ms(t_prof), round_device_ms=t_prof["device_ms"]),
        engine_bytes=rec_mem, twin_engine_bytes=twin_mem, added_bytes=rec_mem - twin_mem,
        analytic_added=dict(
            hbm_bytes={t: posmap_hbm_bytes(getattr(eng.ecfg, t)) for t in ("rec", "mb")},
            private_bytes={t: posmap_private_bytes(getattr(eng.ecfg, t))
                           for t in ("rec", "mb")},
            flat_private_bytes={t: posmap_private_bytes(getattr(twin.ecfg, t))
                                for t in ("rec", "mb")}),
        posmap_spec={t: dataclasses.asdict(getattr(eng.ecfg, t).posmap)
                     for t in ("rec", "mb")},
        profile_top_kernels=prof["top_kernels"][:6], responses_equal_twin=True)
    line_a["radix_vs_sort_ms"] = radix_bench(eng.ecfg)
    out["a"] = line_a
    del eng, twin
    gc.collect()
    torch.cuda.empty_cache()

    # (b) E=4, the ring kernels, then (c) the sweep on the same engines
    logs = []

    def factory(cfg, seed):
        e, _, mem = _new_engine(GrapevineEngine, cfg, logs)
        mems.append(mem)
        return e

    mems: list = []
    cfg_t = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused", evict_every=EVICT_EVERY)
    cfg_r = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused",
                            evict_every=EVICT_EVERY, **POSMAP_KNOBS)
    t_line, t_prof, _, twin, t_model, t_gone = run_evict_slice(factory, cfg_t, gk, ck, card)
    line_b, prof_b, launches_b, eng, model, gone = run_evict_slice(factory, cfg_r, gk, ck,
                                                                   card)
    if logs[0] != logs[1]:
        raise AssertionError("phase 14b: the responses differ from the twin's")
    posmap_twin_check(convert, eng, twin, "phase 14b")
    line_b.update(
        span_device_ms=_span_ms(prof_b), added_bytes=mems[1] - mems[0],
        twin=dict(median_fetch_round_ms=t_line["median_fetch_round_ms"],
                  median_flush_ms=t_line["median_flush_ms"],
                  span_device_ms=_span_ms(t_prof)),
        responses_equal_twin=True)
    out["b"] = line_b
    t_exp = run_expiry_phase(twin, t_model, t_gone, gk, ck, card, "phase 14c twin")
    exp = run_expiry_phase(eng, model, gone, gk, ck, card, "phase 14c")
    if logs[0] != logs[1] or t_exp["evicted"] != exp["evicted"]:
        raise AssertionError("phase 14c: the sweep's responses differ from the twin's")
    posmap_twin_check(convert, eng, twin, "phase 14c")
    prof_c = exp.pop("profile")
    exp.update(leaf_plane_device_ms=prof_c["span_device_ms"].get("leaf_plane"),
               twin_sweep_wall_ms=t_exp["sweep_wall_ms"],
               twin_sweep_device_ms=t_exp["sweep_device_ms"])
    out["c"] = exp
    del eng, twin
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = {k: launches_a.get(k, 0) + launches_b.get(k, 0)
                       + exp["launches"].get(k, 0) for k in KERNELS}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def scan_twin_check(convert, eng, twin, where: str) -> None:
    """A scan engine against its dense twin: every state leaf (junk
    bucket masked; the position tables included) and the generator."""
    diff = convert.first_difference(convert.to_numpy(eng.state), convert.to_numpy(twin.state),
                                    mask_junk=True)
    if diff is not None:
        raise AssertionError(f"{where}: the state differs from the twin's at {diff}")
    if not torch.equal(eng.state.rng.get_state(), twin.state.rng.get_state()):
        raise AssertionError(f"{where}: the generator differs from the twin's")


def _scan_spans(prof: dict) -> dict:
    return {k: prof["span_device_ms"].get(k) for k in SCAN_SPANS}


def _peak_run(fn):
    """``fn()`` with the device bytes it allocated above what was resident
    when it started, at its peak: ``(result, peak_bytes)``."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def _scan_pair_e1(GrapevineConfig, GrapevineEngine, convert, geo: dict, n_rounds: int,
                  gk, ck, card, where: str, guard: bool):
    """A dense twin, then a scan engine, each ``n_rounds`` rounds of phase
    6's CRUD at E=1 ``"pallas_fused_tiled"`` (3 B4 and 3 B6 a round), the
    last one profiled; with ``guard`` the scan engine's 3rd to 6th
    dispatches run under ``set_sync_debug_mode("error")``. Responses,
    state and generator equal the twin's. Returns the line and the twin."""
    logs: list = []
    cfg_d = GrapevineConfig(**dict(geo, vphases_impl="dense"),
                            bucket_cipher_impl="pallas_fused_tiled")
    cfg_s = GrapevineConfig(**dict(geo, vphases_impl="scan"),
                            bucket_cipher_impl="pallas_fused_tiled")
    want = {"gather_decrypt_rows_tiled": 3 * n_rounds, "scatter_encrypt_rows_tiled": 3 * n_rounds}
    twin, _, twin_mem = _new_engine(GrapevineEngine, cfg_d, logs)
    _reset_launches(gk, ck)
    (t_rounds, _, t_prof, *_), t_peak = _peak_run(
        lambda: run_slice(twin, n_rounds, writes=True, profile_last=True))
    require_launches(_launches(gk, ck), want, f"{where} twin")
    eng, init_s, scan_mem = _new_engine(GrapevineEngine, cfg_s, logs)
    if eng.ecfg.vphases_impl != "scan" or twin.ecfg.vphases_impl != "dense":
        raise AssertionError(f"{where}: the engines run {eng.ecfg.vphases_impl} and "
                             f"{twin.ecfg.vphases_impl}")
    g = SyncGuard(eng, 2, 6)
    if guard:
        g.install()
    _reset_launches(gk, ck)
    (rounds, health, prof, *_), s_peak = _peak_run(
        lambda: run_slice(eng, n_rounds, writes=True, profile_last=True))
    launches = _launches(gk, ck)
    if guard:
        g.remove()
    require_launches(launches, want, where)
    guarded_reads = [i for i in g.fallback_reads if g.first <= i < g.last]
    if guard and (g.guarded != 4 or guarded_reads):
        raise AssertionError(f"{where}: {g.guarded} guarded dispatches, exact reads in "
                             f"dispatches {g.fallback_reads}")
    if logs[0] != logs[1]:
        raise AssertionError(f"{where}: the responses differ from the twin's")
    scan_twin_check(convert, eng, twin, where)
    line = slice_stats(cfg_s, rounds, health, init_s, launches, card)
    twin_ms = sorted(r["s"] * 1e3 for r in t_rounds[1:] if not r.get("profiled"))
    line.update(
        vphases_impl="scan", max_round_ms=max(line["round_ms"][1:]),
        round_device_ms=prof["device_ms"], span_device_ms=_scan_spans(prof),
        round_device_busy_share=prof["device_busy_share"],
        peak_bytes_over_resident=s_peak, engine_bytes=scan_mem,
        twin=dict(median_round_ms=statistics.median(twin_ms), max_round_ms=max(twin_ms),
                  round_device_ms=t_prof["device_ms"], span_device_ms=_scan_spans(t_prof),
                  round_device_busy_share=t_prof["device_busy_share"],
                  peak_bytes_over_resident=t_peak, engine_bytes=twin_mem),
        peak_bytes_scan_minus_twin=s_peak - t_peak,
        profile_top_kernels=prof["top_kernels"][:6],
        twin_top_kernels=t_prof["top_kernels"][:6], responses_equal_twin=True)
    if guard:
        line.update(guarded_dispatches=g.guarded, host_syncs=0, exact_reads=g.fallback_reads)
    del eng
    return line, twin, launches


def run_scan_phase(GrapevineConfig, GrapevineEngine, convert, geo: dict, gk, ck,
                   card, load_phase) -> dict:
    """Phase 15: ``vphases_impl="scan"``, each part run after a dense twin
    from the same seed and requests: (a) the production point, E=1
    ``"pallas_fused_tiled"``, 7 rounds of phase 6's CRUD, the 3rd to 6th
    scan dispatches at depth 2 under ``set_sync_debug_mode("error")``;
    then ``load_phase`` (phase 16) on (a)'s dense twin; (b) E=4
    ``"pallas_fused"``, 2 windows; (c) B=4096 at 2^20 messages, E=1
    tiled, 5 rounds. Every response is checked against the model and
    equals the twin's; state and generator equal the twin's."""
    t_phase = time.perf_counter()
    out: dict = {}
    line_a, twin, launches_a = _scan_pair_e1(GrapevineConfig, GrapevineEngine, convert, geo,
                                             7, gk, ck, card, "phase 15a", guard=True)
    out["a"] = line_a
    out["load"] = load_phase(twin)
    del twin
    gc.collect()
    torch.cuda.empty_cache()

    # (b) E=4, the ring kernels, 2 windows
    logs: list = []
    mems: list = []

    def factory(cfg, seed):
        e, _, mem = _new_engine(GrapevineEngine, cfg, logs)
        mems.append(mem)
        return e

    cfg_d = GrapevineConfig(**dict(geo, vphases_impl="dense"), bucket_cipher_impl="pallas_fused",
                            evict_every=EVICT_EVERY)
    cfg_s = GrapevineConfig(**dict(geo, vphases_impl="scan"), bucket_cipher_impl="pallas_fused",
                            evict_every=EVICT_EVERY)
    (t_line, t_prof, *_rest), t_peak = _peak_run(
        lambda: run_evict_slice(factory, cfg_d, gk, ck, card, windows=2))
    twin = _rest[1]
    (line_b, prof_b, launches_b, eng, *_), s_peak = _peak_run(
        lambda: run_evict_slice(factory, cfg_s, gk, ck, card, windows=2))
    if logs[0] != logs[1]:
        raise AssertionError("phase 15b: the responses differ from the twin's")
    scan_twin_check(convert, eng, twin, "phase 15b")
    line_b.update(
        vphases_impl="scan", span_device_ms=_scan_spans(prof_b),
        profiled_round_and_flush_device_ms=prof_b["device_ms"],
        peak_bytes_with_engine=s_peak, twin_peak_bytes_with_engine=t_peak,
        twin=dict(median_fetch_round_ms=t_line["median_fetch_round_ms"],
                  median_flush_ms=t_line["median_flush_ms"],
                  profiled_round_and_flush_device_ms=t_prof["device_ms"],
                  span_device_ms=_scan_spans(t_prof)),
        responses_equal_twin=True)
    out["b"] = line_b
    del eng, twin
    gc.collect()
    torch.cuda.empty_cache()

    # (c) B=4096: twice the production batch. The vectorized admission
    # needs room for B new recipients (recipients + B <= max_recipients),
    # so the table doubles too (2^13); at 2^12 every round after the
    # first would take the sequential admission walk
    geo_c = dict(geo, batch_size=2 * geo["batch_size"],
                 max_recipients=2 * geo["max_recipients"])
    line_c, twin, launches_c = _scan_pair_e1(GrapevineConfig, GrapevineEngine, convert, geo_c,
                                             5, gk, ck, card, "phase 15c", guard=False)
    out["c"] = line_c
    del twin
    gc.collect()
    torch.cuda.empty_cache()
    out["launches"] = {k: launches_a.get(k, 0) + launches_b.get(k, 0) + launches_c.get(k, 0)
                       for k in KERNELS}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def run_load_phase(eng, gk, ck, card) -> dict:
    """Phase 16: the load harness on a production engine (phase 15a's
    dense twin, the default path) behind a ``BatchScheduler``:
    ``calibrate_unloaded_round``, then ``ramp_to_saturation`` from 0.25x
    the calibrated ops/s, factor 2, 4 steps of 2 s, replayed open-loop
    through ``ScenarioRunner``, graded by ``analyze_ramp``. Every settled
    status is in ``OK_STATUSES`` and no op of a step at or below the knee
    is left unsettled; 3 B4 and 3 B6 a round."""
    import numpy as np

    from grapevine_tpu_torch.load import (
        ScenarioRunner,
        analyze_ramp,
        calibrate_unloaded_round,
        ramp_to_saturation,
    )
    from grapevine_tpu_torch.load.harness import OK_STATUSES
    from grapevine_tpu_torch.server.scheduler import BatchScheduler

    t_phase = time.perf_counter()
    gc.collect()
    t_round, est, target_ms = calibrate_unloaded_round(eng, NOW + 50, reps=3)
    schedule = ramp_to_saturation(0.25 * est, 2.0, 4, 2.0, SEED, n_idents=64)
    d0 = eng._dispatched
    sched = BatchScheduler(eng, clock=lambda: NOW + 60)
    _reset_launches(gk, ck)
    try:
        res = ScenarioRunner(sched, n_idents=64, settle_timeout_s=120.0).run(schedule)
    finally:
        sched.close()
    launches = _launches(gk, ck)
    rounds = eng._dispatched - d0
    require_launches(launches, {"gather_decrypt_rows_tiled": 3 * rounds,
                                "scatter_encrypt_rows_tiled": 3 * rounds}, "phase 16")
    ramp = analyze_ramp(schedule, res, target_ms=target_ms)
    settled = ~np.isnan(res.latency_s)
    bad = sorted(set(res.status[settled].tolist()) - set(OK_STATUSES))
    if bad:
        raise AssertionError(f"phase 16: statuses outside OK_STATUSES: {bad}")
    steps = []
    for sm, st in zip(schedule.meta["steps"], ramp["steps"]):
        in_step = (schedule.t_s >= sm["t0"]) & (schedule.t_s < sm["t1"])
        if st["offered_rate"] <= ramp["knee_ops_per_sec"] and not settled[in_step].all():
            raise AssertionError(f"phase 16: {int((~settled[in_step]).sum())} ops of the "
                                 f"{st['offered_rate']} ops/s step (at or below the knee) "
                                 "never settled")
        skew = res.skew_s[in_step]
        steps.append(dict(st, settled_ops_per_sec=st["achieved_ops_per_sec"],
                          dispatch_skew_p50_ms=float(np.percentile(skew, 50)) * 1e3,
                          dispatch_skew_p99_ms=float(np.percentile(skew, 99)) * 1e3,
                          unsettled=int((~settled[in_step]).sum())))
    return dict(
        calibrated=dict(t_round_ms=t_round * 1e3, est_ops_per_s=est, knee_target_ms=target_ms),
        ramp=dict(rate0=schedule.meta["rate0"], factor=schedule.meta["factor"],
                  step_s=schedule.meta["step_s"], n_ops=schedule.n_ops),
        steps=steps, knee_ops_per_s=ramp["knee_ops_per_sec"],
        knee_p99_commit_ms=ramp["knee_p99_commit_ms"], saturated=ramp["saturated"],
        first_failing_rate=ramp["first_failing_rate"], summary=res.summary(),
        rounds=rounds, launches=launches, card=card,
        phase_s=time.perf_counter() - t_phase)


#: phase 17a's rounds: (batch size, rounds) — each an engine of its own
OP_ROUNDS = ((8, 12), (64, 3))
#: phase 17b's rounds (each runs four B=64 engines, the plain one slowest)
OP_XC_ROUNDS = 2


def op_kernel_checks(op_ecfg, gk, ck) -> list:
    """B2 at the op-major engine's shapes: one access's path rows, records
    (path_len x 1028 words) and mailbox (path_len x 6084), decrypted under
    their nonces (about one bucket in eight never written, the identity
    branch) and encrypted under the write epoch, each against its plain
    version (tolerance 0), with its time, the plain version's and the
    card's bound; the launch plan at these row counts."""
    from grapevine_tpu_torch.oram.path_oram import path_bucket_indices

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    rounds = op_ecfg.rec.cipher_rounds
    shapes = []
    for tree, cfg in (("records", op_ecfg.rec), ("mailbox", op_ecfg.mb)):
        z, zv = cfg.bucket_slots, cfg.bucket_slots * cfg.value_words
        w, r = z + zv, cfg.path_len

        def rnd(*shape):
            return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                                 device=dev, dtype=torch.int32)

        key, pidx, pval = rnd(8), rnd(r, z), rnd(r, zv)
        leaf = torch.randint(0, cfg.leaves, (), generator=gen, device=dev).to(torch.int32)
        bucket = path_bucket_indices(cfg, leaf).contiguous()
        nonces = rnd(r, 2)
        nonces[torch.randint(0, 8, (r,), generator=gen, device=dev) == 0] = 0
        nonces[-1] = 0  # at least one never-written bucket on the path
        epoch = torch.tensor([5, 1], dtype=torch.int32, device=dev)[None, :].expand(r, 2)
        for shape, ep in (("op_decrypt", nonces), ("op_encrypt", epoch.contiguous())):
            written = int((ep != 0).any(dim=1).sum())
            c_args = (key, bucket, ep, pidx, pval)
            ki, kv = ck.cipher_rows_pallas(*c_args, rounds=rounds)
            qi, qv = ck.cipher_rows_pallas_plain(*c_args, rounds=rounds)
            torch.cuda.synchronize()
            s = dict(tree=tree, row_words=w, kernel="cipher_rows_pallas", shape=shape,
                     rows=r, never_written_rows=r - written,
                     max_abs_err=max(max_err(ki, qi), max_err(kv, qv)),
                     launch=gk.ring_launch_config("cipher_rows_pallas", r, z, zv),
                     ms=cuda_ms(lambda: ck.cipher_rows_pallas(*c_args, rounds=rounds), 50),
                     plain_ms=cuda_ms(lambda: ck.cipher_rows_pallas_plain(
                         *c_args, rounds=rounds), 5),
                     bytes=4 * (2 * r * w + 3 * r + 8),
                     ops=keystream_ops(written, w, rounds) + written * w)
            s["bytes_ms"] = s["bytes"] / HBM_BYTES_PER_S * 1e3
            s["ops_ms"] = s["ops"] / INT32_OPS_PER_S * 1e3
            s["bound_ms"] = max(s["bytes_ms"], s["ops_ms"])
            # one CTA a row: the persistent grid is capped by the rows
            if s["launch"]["grid"] != r or s["max_abs_err"] != 0:
                raise AssertionError(f"B2 at the op-major {tree} {shape} shape: {s}")
            shapes.append(s)
    return shapes


def _oracle_check(oracle, reqs, resp, now: int, where: str) -> None:
    """Replay one round through the port's plain-dict oracle, op by op in
    slot order (the op-major commit), with the engine's created ids
    forced; every response must equal the oracle's byte for byte."""
    from grapevine_tpu_torch.wire import constants as C

    for i, (q, r) in enumerate(zip(reqs, resp)):
        forced = (r.record.msg_id if q.request_type == C.REQUEST_TYPE_CREATE
                  and r.status_code == C.STATUS_CODE_SUCCESS else None)
        want = oracle.handle_query(q, now, forced_msg_id=forced)
        if r.pack() != want.pack():
            raise AssertionError(f"{where} op {i}: status {r.status_code}, the oracle's "
                                 f"{want.status_code}, or the records differ")


def run_op_phase(GrapevineConfig, GrapevineEngine, convert, gk, ck, card) -> dict:
    """Phase 17: the op-major engine (``commit="op"``: each op's three
    accesses committed before the next op). (a) At the production point,
    ``bucket_cipher_impl="pallas"``: for each of ``OP_ROUNDS`` an engine
    of that batch size serves that many rounds of mixed CRUD through
    ``handle_queries``, every response equal to the port's plain-dict
    ``ReferenceEngine`` (``forced_msg_id``), message and recipient counts
    too; B2 launches 6·B a round and nothing else; dispatches 3 to 10 of
    the B=8 engine run under ``set_sync_debug_mode("error")``; the last
    B=8 round is profiled; no stash overflow. (b) At 2^14, B=64, three
    rounds: op-major ``"pallas"``, ``"pallas_fused"`` and
    ``"pallas_fused_tiled"`` against op-major ``"jnp"`` after every round
    (responses, ``[B, 3]`` transcripts, state with the junk bucket
    masked), 6·B B2 a round for each kernel engine."""
    import numpy as np

    from grapevine_tpu_torch.testing.reference import ReferenceEngine

    t_phase = time.perf_counter()
    geo = dict(max_messages=2**20, max_recipients=2**12)
    users = [_key("opu", i) for i in range(48)]
    lines, launches_a = [], {}
    for b, n_rounds in OP_ROUNDS:
        cfg = GrapevineConfig(**geo, batch_size=b, commit="op", bucket_cipher_impl="pallas")
        gc.collect()
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        eng = GrapevineEngine(cfg, seed=SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        added = torch.cuda.memory_allocated() - m0
        e = eng.ecfg
        if (e.rec.top_cache_levels, e.mb.top_cache_levels, e.mb_choices,
                e.mb_table_buckets) != (0, 0, 1, 8192):
            raise AssertionError(f"phase 17a: commit='op' resolved to {e}")
        oracle = ReferenceEngine(config=cfg)
        rng = np.random.default_rng(SEED + b)
        created: list = []
        guard = SyncGuard(eng, 2, 10)
        if b == 8:
            guard.install()
        rounds, prof = [], None
        parts = dict(init_s=init_s, rounds_s=0.0, profile_s=0.0, oracle_s=0.0)
        _reset_launches(gk, ck)
        for k in range(n_rounds):
            reqs = mixed_requests(rng, users, created, k, n=b)
            now = NOW + k
            t0 = time.perf_counter()
            if b == 8 and k == n_rounds - 1:
                prof = profile_round(lambda: eng.handle_queries(reqs, now))
                resp = prof.pop("result")
                parts["profile_s"] += time.perf_counter() - t0
            else:
                resp = eng.handle_queries(reqs, now)
                rounds.append(time.perf_counter() - t0)
                parts["rounds_s"] += rounds[-1]
            t0 = time.perf_counter()
            _oracle_check(oracle, reqs, resp, now, f"phase 17a B={b} round {k}")
            note_created(reqs, resp, created)
            parts["oracle_s"] += time.perf_counter() - t0
        launches = _launches(gk, ck)
        if b == 8:
            guard.remove()
        require_launches(launches, {"cipher_rows_pallas": 6 * b * n_rounds},
                         f"phase 17a B={b}")
        for name, n in launches.items():
            launches_a[name] = launches_a.get(name, 0) + n
        if b == 8 and (guard.guarded != 8 or guard.fallback_reads):
            raise AssertionError(f"phase 17a: {guard.guarded} guarded dispatches, exact "
                                 f"reads in {guard.fallback_reads}")
        h = eng.health()
        if (eng.message_count(), eng.recipient_count()) != (oracle.message_count(),
                                                           oracle.recipient_count()):
            raise AssertionError(f"phase 17a B={b}: counts differ from the oracle's")
        if h["stash_overflow"] != 0:
            raise AssertionError(f"phase 17a B={b}: stash overflow {h['stash_overflow']}")
        steady = [x * 1e3 for x in rounds[1:]]
        line = dict(batch_size=b, commit="op", bucket_cipher_impl="pallas",
                    max_messages=geo["max_messages"], max_recipients=geo["max_recipients"],
                    rounds=n_rounds, init_s=init_s, first_round_ms=rounds[0] * 1e3,
                    round_ms=steady, median_round_ms=statistics.median(steady),
                    max_round_ms=max(steady),
                    ms_per_op=statistics.median(steady) / b,
                    engine_bytes_added=added,
                    mailbox_tree_bytes=e.mb.n_buckets_padded * e.mb.row_words * 4,
                    records_tree_bytes=e.rec.n_buckets_padded * e.rec.row_words * 4,
                    launches=launches, b2_per_round=launches["cipher_rows_pallas"] / n_rounds,
                    messages=h["messages"], recipients=h["recipients"],
                    stash_occupancy=h["stash_occupancy"], stash_overflow=0,
                    responses_equal_oracle=True, parts_s=parts, card=card)
        if b == 8:
            line.update(guarded_dispatches=guard.guarded, host_syncs=0,
                        profiled_round=dict(
                            wall_ms=prof["wall_ms"], device_ms=prof["device_ms"],
                            device_kernels=prof["device_kernels"],
                            device_busy_share=prof["device_busy_share"],
                            span_device_ms=prof["span_device_ms"],
                            top_kernels=prof["top_kernels"][:6]))
        lines.append(line)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    t_b = time.perf_counter()
    _reset_launches(gk, ck)
    xc = cross_check(GrapevineConfig, GrapevineEngine, convert,
                     ("pallas", "pallas_fused", "pallas_fused_tiled"), 1, OP_XC_ROUNDS,
                     commit="op")
    launches_b = _launches(gk, ck)
    # each kernel engine runs 64 slots a round (50-op rounds are padded)
    require_launches(launches_b, {"cipher_rows_pallas": 3 * 6 * 64 * OP_XC_ROUNDS},
                     "phase 17b")
    xc.update(launches=launches_b, s=time.perf_counter() - t_b, card=card)
    gc.collect()
    torch.cuda.empty_cache()
    return dict(a=lines, b=xc, launches={k: launches_a.get(k, 0) + launches_b.get(k, 0)
                                         for k in KERNELS},
                phase_s=time.perf_counter() - t_phase)


def emit_op_lines(op: dict) -> None:
    for line in op["a"]:
        emit({"op_major_prod": line})
    emit({"op_major_cross_check": op["b"], "phase_s": op["phase_s"]})


def op_phase_alone() -> int:
    """Phase 17 alone: the card line, the kernel build, B2 at the op-major
    shapes, then the op-major engine; 0 if every check held."""
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine import convert
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine
    from grapevine_tpu_torch.engine.state import EngineConfig
    from grapevine_tpu_torch.oblivious import cipher_kernels as ck
    from grapevine_tpu_torch.oblivious import gather_kernels as gk

    card = card_line()
    emit({"card": card})
    t0 = time.perf_counter()
    gk.build_library()
    gk.load_library()
    emit({"build_s": time.perf_counter() - t0})
    op_ecfg = EngineConfig.from_config(GrapevineConfig(
        max_messages=2**20, max_recipients=2**12, batch_size=8, commit="op",
        bucket_cipher_impl="pallas"))
    emit({"op_kernel_shapes": op_kernel_checks(op_ecfg, gk, ck), "card": card})
    gc.callbacks.append(GEN2)
    op = run_op_phase(GrapevineConfig, GrapevineEngine, convert, gk, ck, card)
    emit_op_lines(op)
    emit({"op_phase_s": time.perf_counter() - t0, "card": card})
    return 0


#: phase 18: the bucket-tree mesh (``parallel/mesh.py``) on virtual meshes
#: of one card (the device repeated), each beside a one-device twin
MESH_SHARDS = (2, 4)
MESH_ROUNDS = 7


def _record_transcripts(eng) -> list:
    """Keep every round's transcript tensor (on the device; compared after
    the run, so the dispatch reads nothing back)."""
    log: list = []
    program = eng._round_program

    def wrapped():
        fn = program()

        def run(*a, **k):
            out = fn(*a, **k)
            log.append(out[2])
            return out

        return run

    eng._round_program = wrapped
    return log


def mesh_twin_check(eng, twin, where: str, mask_junk: bool = True) -> None:
    """A sharded engine against a one-device engine, on the card: every
    leaf equal — each shard's heap rows against the twin's same rows, the
    scratch rows and (with ``mask_junk``) the padded junk bucket left out
    — and the generator. One device compare per leaf, no full copy."""
    from grapevine_tpu_torch.oram.path_oram import ShardedPlane, oram_leaves

    def same(x, y) -> bool:
        return torch.equal(x, y.to(x.device))

    for name in ("rec", "mb"):
        cfg = getattr(eng.ecfg, name)
        mine, theirs = oram_leaves(getattr(eng.state, name)), oram_leaves(getattr(twin.state, name))
        for f, x in mine.items():
            y = theirs[f]
            if isinstance(y, ShardedPlane):
                y = y.join(y.shards[0].device)
            if isinstance(x, ShardedPlane):
                k = y.shape[0] // cfg.n_buckets_padded
                end = y.shape[0] - (k if mask_junk else 0)
                for i, part in enumerate(x.local()):
                    lo = i * x.n_local * k
                    hi = min(lo + part.shape[0], end)
                    if not same(part[:hi - lo], y[lo:hi]):
                        raise AssertionError(f"{where}: {name}.{f} shard {i} differs")
            elif mask_junk and f in ("tree_idx", "tree_val", "nonces", "tree_leaf") and x.numel():
                k = x.shape[0] // cfg.n_buckets_padded
                if not same(x[:-k], y[:-k]):
                    raise AssertionError(f"{where}: {name}.{f} differs")
            elif not same(x, y):
                raise AssertionError(f"{where}: {name}.{f} differs")
    for k in ("freelist", "free_top", "recipients", "seq", "hash_key", "id_key"):
        if not same(getattr(eng.state, k), getattr(twin.state, k)):
            raise AssertionError(f"{where}: {k} differs")
    if not torch.equal(eng.state.rng.get_state(), twin.state.rng.get_state()):
        raise AssertionError(f"{where}: the generator differs from the twin's")


def _shard_bytes(eng) -> list:
    """Device bytes each shard of ``eng``'s mesh holds (its tree, leaf and
    nonce planes, scratch rows included)."""
    from grapevine_tpu_torch.oram.path_oram import ShardedPlane, oram_leaves

    out = [0] * eng._mesh.size
    for tree in (eng.state.rec, eng.state.mb):
        for x in oram_leaves(tree).values():
            if isinstance(x, ShardedPlane):
                for i, s in enumerate(x.shards):
                    out[i] += s.numel() * s.element_size()
    return out


class ShardTraffic:
    """Device bytes each shard's gathers and scatters move, tallied from
    the shapes of this run's calls, host arithmetic only (no device
    read): a gather of R rows of ``row`` bytes reads its R ids and R rows,
    writes them, masks them in place (a read and a write) and the reduce
    reads them once more, 5·R·row + 4·R; a scatter reads R ids, owner
    flags and values and writes R rows (the non-owned ones into the
    scratch row), 2·R·row + 5·R."""

    def __init__(self, round_mod, n: int):
        self.round_mod, self.n = round_mod, n
        self.bytes = [0] * n
        self.real = (round_mod._path_gather, round_mod._path_scatter_)

    def install(self) -> None:
        gather, scatter = self.real

        def counted_gather(tree, path_b, mesh=None):
            if mesh is not None:
                row = tree.shards[0][0].numel() * 4
                for i in range(self.n):
                    self.bytes[i] += path_b.shape[0] * (5 * row + 4)
            return gather(tree, path_b, mesh)

        def counted_scatter(tree, path_b, new_vals, owner, mesh=None):
            if mesh is not None:
                row = tree.shards[0][0].numel() * 4
                for i in range(self.n):
                    self.bytes[i] += path_b.shape[0] * (2 * row + 5)
            return scatter(tree, path_b, new_vals, owner, mesh)

        self.round_mod._path_gather = counted_gather
        self.round_mod._path_scatter_ = counted_scatter

    def remove(self) -> None:
        self.round_mod._path_gather, self.round_mod._path_scatter_ = self.real


def _mesh_pair(GrapevineConfig, GrapevineEngine, geo: dict, gk, ck, card, twin_line,
               twin, t_logs, t_trs, n: int, devices, where: str) -> dict:
    """One sharded engine of ``n`` shards on ``devices`` beside the twin
    that already ran: the same rounds, its 3rd to 6th dispatches under
    ``set_sync_debug_mode("error")``, responses, transcripts and state
    equal to the twin's; B2 6 a round and nothing else."""
    import functools

    from grapevine_tpu_torch.analysis.costmodel import engine_cost_ledger
    from grapevine_tpu_torch.oram import round as round_mod

    cfg = GrapevineConfig(**geo, bucket_cipher_impl="pallas", shards=n)
    logs: list = []
    eng, init_s, mem = _new_engine(functools.partial(GrapevineEngine, mesh_devices=devices),
                                   cfg, logs)
    trs = _record_transcripts(eng)
    guard = SyncGuard(eng, 2, 6)
    guard.install()
    traffic = ShardTraffic(round_mod, n)
    traffic.install()
    _reset_launches(gk, ck)
    try:
        (rounds, health, prof, *_), peak = _peak_run(
            lambda: run_slice(eng, MESH_ROUNDS, writes=True, profile_last=True))
    finally:
        traffic.remove()
        guard.remove()
    launches = _launches(gk, ck)
    require_launches(launches, {"cipher_rows_pallas": 6 * MESH_ROUNDS}, where)
    reads = [i for i in guard.fallback_reads if guard.first <= i < guard.last]
    if guard.guarded != 4 or reads:
        raise AssertionError(f"{where}: {guard.guarded} guarded dispatches, exact reads in "
                             f"dispatches {guard.fallback_reads}")
    if logs[0] != t_logs:
        raise AssertionError(f"{where}: the responses differ from the twin's")
    if len(trs) != len(t_trs) or not all(torch.equal(a.to(b.device), b)
                                         for a, b in zip(trs, t_trs)):
        raise AssertionError(f"{where}: the transcripts differ from the twin's")
    mesh_twin_check(eng, twin, where)
    ledger = engine_cost_ledger(eng.ecfg, shards=n)
    line = slice_stats(cfg, rounds, health, init_s, launches, card)
    line.update(
        shards=n, mesh=[str(d) for d in eng._mesh.devices],
        max_round_ms=max(line["round_ms"][1:]),
        round_device_ms=prof["device_ms"], round_device_kernels=prof["device_kernels"],
        round_device_busy_share=prof["device_busy_share"],
        span_device_ms={k: prof["span_device_ms"].get(k) for k in
                        ("oram_fetch", "oram_writeback", "oram_evict")},
        profile_top_kernels=prof["top_kernels"][:6],
        guarded_dispatches=guard.guarded, host_syncs=0, exact_reads=guard.fallback_reads,
        engine_bytes=mem, engine_bytes_over_twin=mem - twin_line["engine_bytes"],
        peak_bytes_over_resident=peak,
        peak_bytes_over_twin=peak - twin_line["peak_bytes_over_resident"],
        shard_resident_bytes=_shard_bytes(eng),
        shard_traffic_bytes_per_round=[x / MESH_ROUNDS for x in traffic.bytes],
        cost_model_per_shard_round_bytes=ledger.per_shard_steady_round_bytes,
        cost_model_one_device_round_bytes=engine_cost_ledger(eng.ecfg).steady_round_bytes,
        b2_per_round=launches["cipher_rows_pallas"] / MESH_ROUNDS,
        responses_equal_twin=True, transcripts_equal_twin=True, state_equal_twin=True,
        twin=twin_line)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return line


def run_mesh_e1(GrapevineConfig, GrapevineEngine, geo: dict, gk, ck, card, meshes) -> dict:
    """Phase 18a (18c with real cards): the production point, E=1
    ``"pallas"``: a one-device twin runs ``MESH_ROUNDS`` rounds of phase
    6's CRUD (B2 6 a round, the last round profiled), then for each
    ``(shards, devices)`` of ``meshes`` a sharded engine from the same
    seed and requests (``_mesh_pair``)."""
    t_phase = time.perf_counter()
    cfg1 = GrapevineConfig(**geo, bucket_cipher_impl="pallas")
    logs: list = []
    twin, _, twin_mem = _new_engine(GrapevineEngine, cfg1, logs)
    t_trs = _record_transcripts(twin)
    _reset_launches(gk, ck)
    (t_rounds, _, t_prof, *_), t_peak = _peak_run(
        lambda: run_slice(twin, MESH_ROUNDS, writes=True, profile_last=True))
    twin_launches = _launches(gk, ck)
    require_launches(twin_launches, {"cipher_rows_pallas": 6 * MESH_ROUNDS}, "phase 18 twin")
    t_ms = sorted(r["s"] * 1e3 for r in t_rounds[1:] if not r.get("profiled"))
    twin_line = dict(median_round_ms=statistics.median(t_ms), max_round_ms=max(t_ms),
                     round_device_ms=t_prof["device_ms"],
                     round_device_kernels=t_prof["device_kernels"],
                     round_device_busy_share=t_prof["device_busy_share"],
                     engine_bytes=twin_mem, peak_bytes_over_resident=t_peak,
                     launches=twin_launches)
    lines = [_mesh_pair(GrapevineConfig, GrapevineEngine, geo, gk, ck, card, twin_line, twin,
                        logs[0], t_trs, n, devs, f"phase 18 {n} shards on {devs[-1]}")
             for n, devs in meshes]
    del twin
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: twin_launches.get(k, 0) + sum(x["launches"].get(k, 0) for x in lines)
                for k in KERNELS}
    return dict(lines=lines, launches=launches, phase_s=time.perf_counter() - t_phase)


def run_mesh_e4(GrapevineConfig, GrapevineEngine, geo: dict, gk, ck, card,
                devices) -> dict:
    """Phase 18b: E=4 ``"pallas_fused"`` at the production point on 2
    shards of a virtual mesh (``mesh_devices``), durable (an fsync per
    record), beside a one-device twin, in lockstep: 2 calls of phase 10's
    stream (2 windows, each call closing with its flush), every status
    checked and every response equal to the twin's, the state equal to
    the twin's after each flush and after a sweep (junk masked: the twin's
    fused scatter writes it); a depth-1, one-device engine recovered from
    a copy of the state dir equals the sharded engine. The sharded engine
    launches B2 only: 3 a round, 2 a flush, 2 a sweep chunk."""
    import shutil
    import tempfile

    from grapevine_tpu_torch.config import DurabilityConfig
    from grapevine_tpu_torch.engine import expiry

    t_phase = time.perf_counter()
    n = len(devices)
    kw = dict(geo, bucket_cipher_impl="pallas_fused", evict_every=EVICT_EVERY)
    dkw = dict(checkpoint_every_rounds=1 << 20, journal_fsync_every=1)
    acc: dict = {"twin": {}, "mesh": {}, "recovery": {}}

    def counted(who, fn):
        _reset_launches(gk, ck)
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        for k, v in _launches(gk, ck).items():
            acc[who][k] = acc[who].get(k, 0) + v
        return out, time.perf_counter() - t

    with tempfile.TemporaryDirectory() as tmp:
        twin = GrapevineEngine(GrapevineConfig(**kw), seed=SEED)
        eng = GrapevineEngine(GrapevineConfig(**kw, shards=n), seed=SEED,
                              mesh_devices=devices,
                              durability=DurabilityConfig(state_dir=f"{tmp}/live", **dkw))
        stream = PipeStream(twin.ecfg.batch_size)
        calls = []
        for k in range(2):
            reqs, want = stream.call(k)
            tr, t_s = counted("twin", lambda: twin.handle_queries(reqs, NOW + k))
            er, e_s = counted("mesh", lambda: eng.handle_queries(reqs, NOW + k))
            _check_statuses(er, want, f"phase 18b call {k}")
            if [x.pack() for x in er] != [x.pack() for x in tr]:
                raise AssertionError(f"phase 18b call {k}: responses differ from the twin's")
            stream.note(reqs, er)
            mesh_twin_check(eng, twin, f"phase 18b after flush {k + 1}")
            calls.append(dict(twin_s=t_s, mesh_s=e_s))
        if (eng.flushes, twin.flushes) != (2, 2):
            raise AssertionError(f"phase 18b: {eng.flushes} / {twin.flushes} flushes")
        t_ev, t_sweep = counted("twin", lambda: twin.expire(SWEEP_NOW, SWEEP_PERIOD))
        e_ev, e_sweep = counted("mesh", lambda: eng.expire(SWEEP_NOW, SWEEP_PERIOD))
        if e_ev != t_ev or not e_ev:
            raise AssertionError(f"phase 18b sweep: {e_ev} evicted, the twin {t_ev}")
        mesh_twin_check(eng, twin, "phase 18b after the sweep")
        eng.close()
        shutil.copytree(f"{tmp}/live", f"{tmp}/copy")
        t0 = time.perf_counter()
        rec, _ = counted("recovery", lambda: GrapevineEngine(
            GrapevineConfig(**kw, pipeline_depth=1), seed=SEED,
            durability=DurabilityConfig(state_dir=f"{tmp}/copy", **dkw)))
        recovery_s = time.perf_counter() - t0
        mesh_twin_check(eng, rec, "phase 18b recovery at 1 shard")
        rec.close()
        # B2 a sweep: a decrypt and an encrypt a chunk; a chunk never
        # straddles a shard
        trees = (eng.ecfg.rec, eng.ecfg.mb)
        chunks = sum(2 * c.n_buckets_padded // min(expiry._chunk_rows(c),
                                                   c.n_buckets_padded // n) for c in trees)
        twin_chunks = sum(2 * c.n_buckets_padded // expiry._chunk_rows(c) for c in trees)
    rounds = 2 * PIPE_CHUNKS
    require_launches(acc["mesh"], {"cipher_rows_pallas": 3 * rounds + 2 * 2 + chunks},
                     "phase 18b sharded")
    require_launches(acc["twin"], {"gather_decrypt_rows": 3 * rounds,
                                   "scatter_encrypt_rows": 2 * 2,
                                   "cipher_rows_pallas": twin_chunks}, "phase 18b twin")
    line = dict(shards=n, evict_every=EVICT_EVERY, bucket_cipher_impl="pallas_fused",
                rounds=rounds, flushes=2, calls=calls, sweep_evicted=e_ev,
                sweep_s=e_sweep, twin_sweep_s=t_sweep, recovery_s=recovery_s,
                launches=acc["mesh"], twin_launches=acc["twin"],
                recovery_launches=acc["recovery"], responses_equal_twin=True,
                flushes_equal_twin=True, sweep_equal_twin=True,
                recovery_at_1_shard_equal=True, card=card)
    del eng, twin, rec
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: sum(acc[w].get(k, 0) for w in acc) for k in KERNELS}
    return dict(line=line, launches=launches, phase_s=time.perf_counter() - t_phase)


def run_mesh_phase(GrapevineConfig, GrapevineEngine, gk, ck, card) -> dict:
    """Phase 18: (a) virtual meshes of 2 then 4 shards on ``cuda:0``
    beside one twin; (b) the sharded E=4 facade, durable, its flushes,
    sweep and a recovery at one shard; (c) with two or more cards, (a)
    on a real mesh across them, else a line saying why it did not run."""
    t_phase = time.perf_counter()
    geo = dict(max_messages=2**20, max_recipients=2**12, batch_size=2048,
               vphases_impl="dense")
    cuda0 = torch.device("cuda", 0)
    a = run_mesh_e1(GrapevineConfig, GrapevineEngine, geo, gk, ck, card,
                    [(n, [cuda0] * n) for n in MESH_SHARDS])
    b = run_mesh_e4(GrapevineConfig, GrapevineEngine, geo, gk, ck, card, [cuda0] * 2)
    cards = torch.cuda.device_count()
    if cards >= 2:
        real = [(n, [torch.device("cuda", i) for i in range(n)])
                for n in MESH_SHARDS if n <= cards]
        c = run_mesh_e1(GrapevineConfig, GrapevineEngine, geo, gk, ck, card, real)
    else:
        c = dict(ran=False, launches={}, reason=f"{cards} CUDA card visible: a mesh "
                 "across cards needs two or more; phase 18a ran the same path on a "
                 "virtual mesh of one card")
    launches = {k: a["launches"].get(k, 0) + b["launches"].get(k, 0)
                + c["launches"].get(k, 0) for k in KERNELS}
    return dict(a=a, b=b, c=c, launches=launches, phase_s=time.perf_counter() - t_phase)


def emit_mesh_lines(mesh: dict) -> None:
    for line in mesh["a"]["lines"]:
        emit({"mesh_e1": line})
    emit({"mesh_e4": mesh["b"]["line"]})
    c = mesh["c"]
    if c.get("ran", True):
        for line in c["lines"]:
            emit({"mesh_cards": line})
    else:
        emit({"mesh_cards": {"ran": False, "reason": c["reason"]}})
    emit({"mesh_phase_s": mesh["phase_s"], "mesh_launches": mesh["launches"]})


def mesh_phase_alone() -> int:
    """Phase 18 alone: the card line, the kernel build, then the mesh
    phase; 0 if every check held."""
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine
    from grapevine_tpu_torch.oblivious import cipher_kernels as ck
    from grapevine_tpu_torch.oblivious import gather_kernels as gk

    card = card_line()
    emit({"card": card})
    t0 = time.perf_counter()
    gk.build_library()
    gk.load_library()
    emit({"build_s": time.perf_counter() - t0})
    gc.callbacks.append(GEN2)
    mesh = run_mesh_phase(GrapevineConfig, GrapevineEngine, gk, ck, card)
    emit_mesh_lines(mesh)
    emit({"mesh_phase_alone_s": time.perf_counter() - t0, "card": card})
    return 0


def emit_scan_lines(scan: dict) -> None:
    emit({"scan_e1": scan["a"]})
    emit({"scan_e4": scan["b"]})
    emit({"scan_b4096": scan["c"], "phase_s": scan["phase_s"]})
    emit({"load_ramp": scan["load"]})


def scan_phases_alone() -> int:
    """Phases 15-16 alone: the card line, the kernel build, then the scan
    twins and the load ramp, each line printed; 0 if every check held."""
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine import convert
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine
    from grapevine_tpu_torch.oblivious import cipher_kernels as ck
    from grapevine_tpu_torch.oblivious import gather_kernels as gk

    card = card_line()
    emit({"card": card})
    t0 = time.perf_counter()
    gk.build_library()
    gk.load_library()
    emit({"build_s": time.perf_counter() - t0})
    gc.callbacks.append(GEN2)
    geo = dict(max_messages=2**20, max_recipients=2**12, batch_size=2048)
    scan = run_scan_phase(GrapevineConfig, GrapevineEngine, convert, geo, gk, ck, card,
                          lambda twin: run_load_phase(twin, gk, ck, card))
    emit_scan_lines(scan)
    emit({"scan_phases_s": time.perf_counter() - t0, "card": card})
    return 0


def repeat_standby_runbook(n: int) -> int:
    """Phase 12b alone, ``n`` times: each run's outcome on a line of its
    own, then the count; 1 if any run failed."""
    from grapevine_tpu_torch.oblivious import gather_kernels as gk

    card = card_line()
    gk.build_library()  # once, before the processes that load it
    failed = 0
    for i in range(n):
        try:
            r = run_standby_runbook(card)
            emit({"standby_runbook_run": i, "ok": True, "catch_up_s": r["catch_up_s"],
                  "link_events": r["link_events"], "phase_s": r["phase_s"], "card": card})
        except Exception as exc:
            failed += 1
            emit({"standby_runbook_run": i, "ok": False, "error": str(exc)[-4000:],
                  "card": card})
    emit({"standby_runbook_runs": n, "failed": failed, "card": card})
    return 1 if failed else 0


def main() -> int:
    ap = argparse.ArgumentParser(description="Drive the port on one NVIDIA card and check it.")
    ap.add_argument("--standby-runbook", type=int, default=0, metavar="N",
                    help="run phase 12b alone N times instead of every phase")
    ap.add_argument("--scan-phases", action="store_true",
                    help="run phases 15-16 alone (after the kernel build)")
    ap.add_argument("--op-phase", action="store_true",
                    help="run phase 17 alone (after the kernel build)")
    ap.add_argument("--mesh-phase", action="store_true",
                    help="run phase 18 alone (after the kernel build)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    if args.standby_runbook:
        return repeat_standby_runbook(args.standby_runbook)
    if args.scan_phases:
        return scan_phases_alone()
    if args.op_phase:
        return op_phase_alone()
    if args.mesh_phase:
        return mesh_phase_alone()
    t_start = time.perf_counter()
    #: seconds each group of phases took, in order
    phase_s: dict = {}

    def split(name: str) -> None:
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())

    gc.callbacks.append(GEN2)
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine import convert, expiry
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine
    from grapevine_tpu_torch.engine.state import EngineConfig
    from grapevine_tpu_torch.oblivious import cipher_kernels as ck
    from grapevine_tpu_torch.oblivious import gather_kernels as gk
    from grapevine_tpu_torch.oram import path_oram, round as round_mod

    card = card_line()
    emit({"card": card})
    t0 = time.perf_counter()
    lib = gk.build_library()
    gk.load_library()
    log = gk.ptxas_log()
    emit({"build_s": time.perf_counter() - t0, "library": lib.name,
          "ptxas": ptxas_report(log)})

    geo = dict(max_messages=2**20, max_recipients=2**12, batch_size=2048,
               vphases_impl="dense")
    prod = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused_tiled")
    prod_ecfg = EngineConfig.from_config(prod)
    shapes = kernel_checks(prod_ecfg, gk, ck, path_oram, round_mod, expiry)
    op_ecfg = EngineConfig.from_config(GrapevineConfig(
        max_messages=2**20, max_recipients=2**12, batch_size=8, commit="op",
        bucket_cipher_impl="pallas"))
    shapes += op_kernel_checks(op_ecfg, gk, ck)
    sweep_chunks = {t: c.n_buckets_padded // expiry._chunk_rows(c)
                    for t, c in (("records", prod_ecfg.rec), ("mailbox", prod_ecfg.mb))}
    emit({"ring_launch": [
        {k: s[k] for k in ("kernel", "tree", "shape", "rows", "owned_rows", "launch")
         if k in s}
        for s in shapes if s["kernel"] in RING.values()], "card": card})

    split("kernels")

    # phase 4: the per-round slice (B4, B6)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = GrapevineEngine(prod, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _reset_launches(gk, ck)
    rounds, health, prof, model, gone = run_slice(eng, 7, writes=False, profile_last=True)
    launches = _launches(gk, ck)
    require_launches(launches, {"gather_decrypt_rows_tiled": 21,
                                "scatter_encrypt_rows_tiled": 21}, "per-round slice")
    slice_line = slice_stats(prod, rounds, health, init_s, launches, card)
    # phase 8 (E=1): the expiry sweep on this slice's engine (B2)
    exp1 = run_expiry_phase(eng, model, gone, gk, ck, card, "per-round slice")
    del eng
    torch.cuda.empty_cache()

    split("per_round_slice_and_sweep")

    # phase 5: the delayed-eviction slice (B3, B5)
    evict = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused",
                            evict_every=EVICT_EVERY)
    evict_line, evict_prof, evict_launches, eng, model, gone = run_evict_slice(
        GrapevineEngine, evict, gk, ck, card)
    # phase 8 (E=4): mid-window, the buffer not empty (B2)
    exp4 = run_expiry_phase(eng, model, gone, gk, ck, card, "delayed-eviction slice")
    del eng
    torch.cuda.empty_cache()

    split("evict_slice_and_sweep")

    # phase 6: the "pallas" path (B2)
    unfused = GrapevineConfig(**geo, bucket_cipher_impl="pallas")
    t0 = time.perf_counter()
    eng = GrapevineEngine(unfused, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _reset_launches(gk, ck)
    rounds, health, *_ = run_slice(eng, 5, writes=True, profile_last=False)
    pallas_launches = _launches(gk, ck)
    require_launches(pallas_launches, {"cipher_rows_pallas": 6 * 5}, "'pallas' path")
    pallas_line = slice_stats(unfused, rounds, health, init_s, pallas_launches, card)
    del eng
    torch.cuda.empty_cache()

    split("pallas_path")

    # phase 7: cross-checks at a small geometry
    xc1 = cross_check(GrapevineConfig, GrapevineEngine, convert,
                      ("pallas_fused_tiled",), 1, 5)
    xc4 = cross_check(GrapevineConfig, GrapevineEngine, convert,
                      ("pallas", "pallas_fused", "pallas_fused_tiled"), EVICT_EVERY,
                      3 * EVICT_EVERY)

    split("cross_checks")

    # phase 9: durability — journal-only recovery at the production
    # geometry, checkpoint + journal recovery at the small one
    dur = {"production": run_durability_prod(GrapevineEngine, evict, gk, ck, card),
           "small": [run_durability_small(GrapevineConfig, GrapevineEngine, impl, card)
                     for impl in ("pallas", "pallas_fused", "pallas_fused_tiled")]}

    split("durability")

    # phase 10: the pipelined facade, depth 1 against depth 2 — durable
    # at E=4 ("pallas_fused": B3, B5), then E=1 ("pallas_fused_tiled": B4, B6)
    pipe = [run_pipeline_phase(GrapevineConfig, GrapevineEngine, geo, "pallas_fused",
                               EVICT_EVERY, True, gk, ck, card),
            run_pipeline_phase(GrapevineConfig, GrapevineEngine, geo, "pallas_fused_tiled",
                               1, False, gk, ck, card)]
    pipe_launches = {k: sum(p["depth2"]["launches"][k] for p in pipe) for k in KERNELS}
    split("pipeline")

    # phase 11: the serving tier — sessions and the sweep thread (B3, B5,
    # B2), full rounds through the scheduler (B3, B5), the engine/frontend
    # tier (B4, B6)
    serve = run_serving_phase(GrapevineConfig, geo, gk, ck, card)
    serve_launches = {k: sum(serve[p]["launches"].get(k, 0) for p in "abc") for k in KERNELS}
    split("serving")

    # phase 12: the hot standby — ship, catch up, cut, promote, serve at the
    # production point (B3, B5, B2 on the standby's applies), the runbook
    # over processes (B4, B6), the checkpoint bootstrap (B3, B5, B2)
    standby = run_standby_phase(GrapevineConfig, GrapevineEngine, geo, gk, ck, card)
    sa, sc = standby["a"], standby["c"]
    standby_launches = {k: (sa["launches_live"]["primary"].get(k, 0)
                            + sa["launches_live"]["standby"].get(k, 0)
                            + sa["launches_promote"].get(k, 0)
                            + sa["serving"]["launches"].get(k, 0)
                            + sc["standby_launches"].get(k, 0)) for k in KERNELS}
    split("standby")

    # phase 13: every round observer on the serving tier — the production
    # point with the leak monitor, SLO, adaptive window and profiler gate
    # (B3, B5, and B2 on its expiry thread), the engine tier at 2^14 (B4,
    # B6), and the fleet aggregator over both
    obs = run_observability_phase(GrapevineConfig, geo, gk, ck, card, serve["b"])
    obs_launches = {k: obs["a"]["launches"].get(k, 0) + obs["b"]["launches"].get(k, 0)
                    for k in KERNELS}
    split("observability")

    # phase 14: the recursive position map and the radix sort at the
    # production point beside flat, "xla" twins — E=1 (B4, B6), E=4 (B3,
    # B5) and its sweep (B2)
    pm = run_posmap_phase(GrapevineConfig, GrapevineEngine, convert, geo, gk, ck, card)
    split("posmap")

    # phases 15-16: the scan vphases beside dense twins — E=1 (B4, B6),
    # E=4 (B3, B5), B=4096 (B4, B6) — and the load harness's ramp through
    # a scheduler on 15a's dense twin (B4, B6)
    scan = run_scan_phase(GrapevineConfig, GrapevineEngine, convert, geo, gk, ck, card,
                          lambda twin: run_load_phase(twin, gk, ck, card))
    split("scan_and_load")

    # phase 17: the op-major engine at the production point against the
    # port's oracle, and its kernel engines against "jnp" at 2^14 (B2)
    op = run_op_phase(GrapevineConfig, GrapevineEngine, convert, gk, ck, card)
    split("op_major")

    # phase 18: the bucket-tree mesh — virtual meshes of 2 and 4 shards on
    # one card beside a twin (B2 only), the sharded E=4 facade, durable,
    # beside its twin (B2; the twin B3, B5, B2), and a mesh across cards
    # where two or more are visible
    mesh = run_mesh_phase(GrapevineConfig, GrapevineEngine, gk, ck, card)
    split("mesh")

    launches_by_kernel = {
        "cipher_rows_pallas": (op["launches"]["cipher_rows_pallas"]
                               + pm["launches"]["cipher_rows_pallas"]
                               + scan["launches"]["cipher_rows_pallas"]
                               + scan["load"]["launches"].get("cipher_rows_pallas", 0)
                               + pallas_launches["cipher_rows_pallas"]
                               + exp1["launches"]["cipher_rows_pallas"]
                               + exp4["launches"]["cipher_rows_pallas"]
                               + serve_launches["cipher_rows_pallas"]
                               + standby_launches["cipher_rows_pallas"]
                               + obs_launches["cipher_rows_pallas"]),
        "gather_decrypt_rows": (pm["launches"]["gather_decrypt_rows"]
                                + scan["launches"]["gather_decrypt_rows"]
                                + scan["load"]["launches"].get("gather_decrypt_rows", 0)
                                + evict_launches["gather_decrypt_rows"]
                                + pipe_launches["gather_decrypt_rows"]
                                + serve_launches["gather_decrypt_rows"]
                                + standby_launches["gather_decrypt_rows"]
                                + obs_launches["gather_decrypt_rows"]),
        "gather_decrypt_rows_tiled": (pm["launches"]["gather_decrypt_rows_tiled"]
                                      + scan["launches"]["gather_decrypt_rows_tiled"]
                                      + scan["load"]["launches"].get("gather_decrypt_rows_tiled", 0)
                                      + launches["gather_decrypt_rows_tiled"]
                                      + pipe_launches["gather_decrypt_rows_tiled"]
                                      + serve_launches["gather_decrypt_rows_tiled"]
                                      + obs_launches["gather_decrypt_rows_tiled"]),
        "scatter_encrypt_rows": (pm["launches"]["scatter_encrypt_rows"]
                                 + scan["launches"]["scatter_encrypt_rows"]
                                 + scan["load"]["launches"].get("scatter_encrypt_rows", 0)
                                 + evict_launches["scatter_encrypt_rows"]
                                 + pipe_launches["scatter_encrypt_rows"]
                                 + serve_launches["scatter_encrypt_rows"]
                                 + standby_launches["scatter_encrypt_rows"]
                                 + obs_launches["scatter_encrypt_rows"]),
        "scatter_encrypt_rows_tiled": (pm["launches"]["scatter_encrypt_rows_tiled"]
                                       + scan["launches"]["scatter_encrypt_rows_tiled"]
                                       + scan["load"]["launches"].get("scatter_encrypt_rows_tiled", 0)
                                       + launches["scatter_encrypt_rows_tiled"]
                                       + pipe_launches["scatter_encrypt_rows_tiled"]
                                       + serve_launches["scatter_encrypt_rows_tiled"]
                                       + obs_launches["scatter_encrypt_rows_tiled"]),
    }
    for k in KERNELS:
        launches_by_kernel[k] += mesh["launches"].get(k, 0)
    emit(slice_line)
    emit({"profile": prof, "card": card})
    emit({"evict_slice": evict_line})
    emit({"evict_profile": evict_prof, "card": card})
    emit({"pallas_slice": pallas_line})
    emit({"cross_check": [xc1, xc4]})
    emit({"expiry": [exp1, exp4]})
    emit({"durability": dur})
    for p in pipe:
        emit({"pipeline": p, "card": card})
    emit({"serving_sessions": serve["a"]})
    emit({"serving_rounds": serve["b"]})
    emit({"serving_tier": serve["c"]})
    emit({"standby_prod": sa})
    emit({"standby_runbook": standby["b"]})
    emit({"standby_bootstrap": sc})
    emit({"observability_prod": obs["a"]})
    emit({"observability_tier_fleet": obs["b"], "phase_s": obs["phase_s"]})
    emit({"posmap_e1": pm["a"]})
    emit({"posmap_e4": pm["b"]})
    emit({"posmap_sweep": pm["c"], "phase_s": pm["phase_s"]})
    emit_scan_lines(scan)
    emit_op_lines(op)
    emit_mesh_lines(mesh)
    emit({"wall_s": time.perf_counter() - t_start, "phase_s": phase_s, "card": card})
    emit({"kernels": kernel_entries(shapes, launches_by_kernel, sweep_chunks,
                                    op["launches"]["cipher_rows_pallas"]), "card": card})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
