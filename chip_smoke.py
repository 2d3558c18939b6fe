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
   mesh across them; with one, a line saying it did not run and why;
19. the obliviousness analyzer (``grapevine_tpu_torch/analysis``) on the
   card: (a) fake captures on CUDA tensors at the production point — the
   ``"pallas_fused_tiled"`` E=1 round, the ``"pallas_fused"`` E=4 round
   and flush, the ``"pallas"`` E=1 round — and at 2^14, B=64 the slow
   admission branch, the sweep and the gate's ORAM sub-rounds, each
   taint-audited (no violation outside the allowlist) with its nodes,
   capture and audit seconds and allowlist hits, and its kernel nodes by
   name equal to the launches one eager call of that impl makes; (b) two
   real-mode captures of the ``"pallas_fused_tiled"`` round at the
   production point from adversarial secrets (every op on one recipient,
   against all distinct, under different keys) give one op census,
   output shapes included, and the replayed graph equals the eager round
   from the same state and draws on every word (junk masked) — the
   captures and the replay launch B4 and B6 through their custom ops;
   (c) the slow admission walk (``fast_ok=False``) at the production
   point under ``torch.cuda.set_sync_debug_mode("error")`` equals the
   fast branch where both are exact, with both walls and device times;
   (d) ``python -m grapevine_tpu_torch.analysis.check_oblivious --smoke``
   (both admission branches, every mutant, locklint and importlint) in a
   process where ``import jax`` fails, exit 0; and B2 at the op-major
   shape through its wrapper and through its custom op, timed;
20. the range analyzer and the cost model's traced half
   (``grapevine_tpu_torch/analysis``): (a) phase 19a's fake captures on
   CUDA tensors interval-audited — 0 findings outside the range
   allowlist, with nodes, capture and audit seconds, allowlist hits by
   entry, the kernel nodes whose address operands were certified and the
   ops the domain does not model; (b) ``check_ranges``' default sweep at
   geometry 30 (records 2^30 a tree, states faked on the card, 4
   processes): 0 findings, every entry reached, the six range mutants
   caught for their kinds, 2^36 refused by the guard, and the device
   memory the audits allocated (at most 1 MiB a process); (c) real captures of the
   ``"pallas_fused_tiled"`` and ``"pallas"`` E=1 rounds at the production
   point, replayed by an interpreter that reads every integer node's
   minimum and maximum: each inside its certified interval, the replay
   equal to the eager round on every word (junk masked), 3 B4 + 3 B6 and
   6 B2 launched through ``torch.ops.gv``; (d) the analytic ledger
   against the traced rows at the production point (round at E=1 and
   E=4, flush, sweep, the records flush on a 2-shard virtual mesh), and
   the ledger's bytes per kernel path beside phase 3's kernel ms; (e)
   ``check_ranges --smoke`` and ``check_cost_model --smoke`` where
   ``import jax`` fails, exit 0 (the nine cost mutants are (e)'s);
21. the census gates (``grapevine_tpu_torch/analysis``) at the production
   point, k=4: (a) real captures of the records and mailbox
   ``oram_round`` (``"pallas_fused_tiled"``) with each of four
   adversarial index sets closed over as constants — one census, output
   shapes included, no control node, each tree plane ``B·(path_len−4)``
   rows and the cache planes ``B·4``, one B4 and one B6 node a capture —
   and a fake capture at k=0 moving ``B·path_len``; (b) at E=4
   (``"pallas_fused"``) both trees' fetch rounds index-blind and
   read-only on the trees, one real flush scattering ``t`` rows a plane,
   and on a 2-shard virtual mesh of the card the records tree's per-shard
   shapes, the owner partition of a window's flush at run time and the
   unmasked-scatter mutant caught; (c) the records tree's position-map
   lookup at phase 14's knobs index-blind, the flat map's as the control;
   (d) the radix records round capturing no sort node against the xla
   one's, and the scan engine round's radix residue at the reference's
   wide-key sites; (e) ``check_telemetry_policy`` where ``import jax``
   fails, exit 0, and its namespace rules on the live registry of a
   production engine with every round observer attached, after two
   rounds (B4, B6);
22. the crash-recovery chaos harness
   (``grapevine_tpu_torch/testing/chaos_run.py``) on the card, every
   child process on the card, no CPU fallback: (c) first, a child with
   ``GRAPEVINE_RECORD_SIZE=2048`` runs phase 3's checks of B2-B6 at the
   production point with 2 KB record rows (2052 words; tolerance 0, junk
   masked; the ``ptxas`` report; each ring launch's shared memory), the
   row's words, each kernel's path (vector or word), ms a call and bound,
   then serves 4 rounds of ``"pallas_fused_tiled"`` at E=1 and 2 windows
   of ``"pallas_fused"`` at E=4, every response checked against the dict
   model; (a) the production point, E=4 ``"pallas_fused"``, k=4, depth 2,
   durable with an fsync a frame and no checkpoint, 12 events of 256-2048
   requests (a sweep at the 6th): one trial each killed at
   ``round.post_dispatch``, ``flush.pre_dispatch``, ``flush.post_dispatch``,
   ``journal.append.torn`` and by a timer within the schedule, each
   restarted until it completes; (b) at 2^14, B=64, E=2, depth 2,
   ``checkpoint_every`` 5: one trial for every fault site and a timer,
   the round and flush sites again on a 2-shard virtual mesh of the card,
   and the standby takeover (the replica in this process, the primary
   child killed at ``round.post_dispatch`` and ``flush.pre_dispatch``).
   Every incarnation's response hashes and the final state hash equal an
   uninterrupted depth-1 oracle child's on the card (junk masked for the
   sharded children: a mesh bypasses the fused kernels), the leak monitor
   says PASS, and every fault site is killed at least once. Each part's
   line: trials and incarnations, kills by site and where the timer kills
   landed, frames replayed and each incarnation's start-up and recovery
   seconds, hashes matched, leak verdicts, launches, the part's seconds;
23. the reference's test-only contracts at the production point (ChaCha8,
   k=4), each part one line with its checks, launches per kernel, rounds
   and seconds: (a) u64 lanes, on E=1 ``"pallas_fused_tiled"`` then E=4
   ``"pallas_fused"``: ``seq`` set to (2^32 - B/2, 0), one round of B
   creates at a post-2106 clock over 64 recipients (every mailbox
   straddles the wrap), then pops by zero-id DELETE in creation order,
   each equal to a dict model; in a fresh engine, one round stamped at
   2^32 - 50 and one at 2^32 + 20, swept at 2^32 + 50 with period 60
   (B2): the first round all expires, the second stays; (b) same-key
   hazards on each kernel impl at E=1, one engine at a time: the 33
   (ordering, fill) cases of the reference as 33 recipient groups in one
   hazard round after a setup round, the two-recipient case beside them,
   then a drain, every response and count equal to the port's oracle with
   forced ids; (c) the two-choice mailbox table: 75% of ``max_recipients``
   at the default load 0.5 (the early TOO_MANY_RECIPIENTS count), and a
   fill at load 1.0 until the early path fires, with the reference's
   consistency checks, slots per recipient for both; (d) the leak
   canaries through the records tree's ``oram_round`` on each kernel
   impl at B (no-dedup, no-remap, biased dummy, honest and leaky), then 8
   mixed CRUD rounds with their transcripts (uniformity and the R/U/D
   two-sample statistic with its op-type-bias canary); (e) R/U/D round
   walls on E=1 ``"pallas_fused_tiled"`` at the default depth: 30
   interleaved rounds a kind over 2B live records (DELETE of absent ids),
   the pairwise Mann-Whitney z, a canary with DELETE rounds slowed by one
   round's cost, and the launches of one profiled round of each kind,
   which must be equal; (f) 8 randomized soak campaigns on the card
   against the oracle (``testing/soak.py``, the reference's variants with
   ``"pallas"`` on each kernel impl in turn), then 30 s of the server
   stress workload through a ``GrapevineServer`` on the card, ChaCha8 on;
24. the round graph at the ``bus_1kb`` benchmark cell's geometry
   (``gvbench/configs/bus_1kb.json``'s engine: 2^23 records, B=2048): a
   graphed engine's 8 rounds of mixed CRUD (eager, capture, 6 replays),
   then an engine of the same seed run op by op over the same requests,
   the first's final state held on the host meanwhile: responses,
   transcripts, every state leaf and the generator's state bit-identical,
   fresh draws on every replay, B4 and B6 in the profiled replay's trace.

A launch check counts the wrappers' calls: a round run op by op, and a
round graph's capture, call each wrapper once a launch; a round replayed
from the graph launches its kernels from the graph, and the check leaves
it out, reading the engine's own count of replays
(``health()["round_graph"]``); the ``kernels`` line sums those replays.

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

    python3 chip_smoke.py --analysis-phase

runs phase 19 alone after the kernel build.

    python3 chip_smoke.py --range-phase

runs phase 20 alone after the kernel build.

    python3 chip_smoke.py --census-phase

runs phase 21 alone after the kernel build.

    python3 chip_smoke.py --chaos-phase

runs phase 22 alone after the kernel build.

    python3 chip_smoke.py --contracts-phase

runs phase 23 alone after the kernel build.

    python3 chip_smoke.py --graph-phase

runs phase 24 alone after the kernel build.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import itertools
import json
import math
import os
import random
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
#: kernel name → what its device kernel's name holds in a profiler trace
TRACE_NAMES = {"gather_decrypt_rows_tiled": "gather_tiled_kernel(",
               **{name: "ring_kernel<{}, {}, {}>".format(*inst) for inst, name in RING.items()}}


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
            path = gk.last_copy_path()
            torch.cuda.synchronize()
            launch = ({"launch": gk.ring_launch_config(name, r, z, zv)}
                      if name in RING.values() else {})
            shapes.append(dict(common, kernel=name, shape="round", rows=r, path=path,
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
                path = gk.last_copy_path()
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
                                   owned_rows=n_owned, max_abs_err=err, path=path,
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
            path = gk.last_copy_path()
            qi, qv = ck.cipher_rows_pallas_plain(*c_args, rounds=rounds)
            torch.cuda.synchronize()
            shapes.append(dict(
                common, kernel="cipher_rows_pallas", shape=shape, rows=rr,
                never_written_rows=rr - written, path=path,
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
        # the hand-written kernels the card ran, counted by name in the
        # trace: a replayed round's too, which the wrappers do not count
        traced_launches={name: sum(e.count for e in kernels if part in e.key)
                         for name, part in TRACE_NAMES.items()},
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


#: rounds replayed from an engine's round graph inside the launch checks
#: (``counted_rounds``); the ``kernels`` line reports them
GRAPH_REPLAYS = {"rounds": 0}


def graph_replays(eng) -> int:
    """Rounds ``eng`` has replayed from its round graph so far."""
    return eng.health()["round_graph"]["replayed"]


def counted_rounds(eng, rounds: int, replayed0: int = 0) -> int:
    """Of the last ``rounds`` rounds of ``eng``, which had replayed
    ``replayed0`` rounds before them, those whose kernels the wrappers'
    ``LAUNCHES`` count: each round run op by op, and the round graph's
    capture, which calls the wrappers once (the round that captures then
    replays). A replay launches the graph, not the wrappers: the replays
    are read from the engine's counter and added to ``GRAPH_REPLAYS``."""
    replayed = graph_replays(eng) - replayed0
    GRAPH_REPLAYS["rounds"] += replayed
    return rounds - replayed + (1 if replayed and not replayed0 else 0)


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
    require_launches(launches, {"gather_decrypt_rows": 3 * counted_rounds(eng, n_rounds),
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
        # the journal replays every round op by op; the live engine's
        # wrappers saw its eager rounds and the graph's capture
        n_rounds = 4 * EVICT_EVERY
        want = {k: v for k, v in live_launches.items() if v}
        require_launches(live_launches, dict(
            want, gather_decrypt_rows=3 * counted_rounds(eng, n_rounds)), "durable live run")
        require_launches(replay_launches, dict(want, gather_decrypt_rows=3 * n_rounds),
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
            expect = {k: v * counted_rounds(eng, rounds) for k, v in want.items()}
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
    replayed0 = graph_replays(eng)
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
    counted = counted_rounds(eng, rounds, replayed0)
    if own:  # phase 13a's expiry thread also launches B2: it checks its own
        require_launches(launches, {"gather_decrypt_rows": 3 * counted,
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
    return dict(rounds=rounds, counted_rounds=counted, flushes=flushes, batch_size=b,
                ops=b * SERVE_ROUNDS, pool=SERVE_POOL, lookahead_rounds=SERVE_LOOKAHEAD,
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
    counted = counted_rounds(engine.engine, rounds)
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
    require_launches(launches, {"gather_decrypt_rows_tiled": 3 * counted,
                                "scatter_encrypt_rows_tiled": 3 * counted}, where)
    out = dict(bucket_cipher_impl="pallas_fused_tiled", evict_every=1, clients=n,
               ops=n * TIER_OPS, rounds=rounds, counted_rounds=counted, init_s=init_s,
               serve_s=serve_s,
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
        require_launches(launches_a, {"gather_decrypt_rows": 3 * counted_rounds(eng, rounds_a),
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
    replayed0 = graph_replays(eng)
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
    require_launches(launches, {"gather_decrypt_rows": 3 * counted_rounds(eng, rounds, replayed0),
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
        # the standby applies every round op by op
        require_launches(live["primary"], dict(
            want_l, gather_decrypt_rows=3 * counted_rounds(primary, n_rounds)),
            "phase 12a primary")
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

        def scored(spans, device_span_s=None):
            observe(spans, device_span_s=device_span_s)
            # the span the monitor scores: the card's own clock where the
            # round has it, else the host-observed one
            device_ms.append((device_span_s if device_span_s is not None
                              else spans["device"][1]) * 1e3)

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
        require_launches(launches, {"gather_decrypt_rows": 3 * part["counted_rounds"],
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
    n_a = counted_rounds(eng, 7)
    require_launches(launches_a, {"gather_decrypt_rows_tiled": 3 * n_a,
                                  "scatter_encrypt_rows_tiled": 3 * n_a}, "phase 14a")
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

    def want(eng):
        n = counted_rounds(eng, n_rounds)
        return {"gather_decrypt_rows_tiled": 3 * n, "scatter_encrypt_rows_tiled": 3 * n}

    twin, _, twin_mem = _new_engine(GrapevineEngine, cfg_d, logs)
    _reset_launches(gk, ck)
    (t_rounds, _, t_prof, *_), t_peak = _peak_run(
        lambda: run_slice(twin, n_rounds, writes=True, profile_last=True))
    require_launches(_launches(gk, ck), want(twin), f"{where} twin")
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
    require_launches(launches, want(eng), where)
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
    d0, replayed0 = eng._dispatched, graph_replays(eng)
    sched = BatchScheduler(eng, clock=lambda: NOW + 60)
    _reset_launches(gk, ck)
    try:
        res = ScenarioRunner(sched, n_idents=64, settle_timeout_s=120.0).run(schedule)
    finally:
        sched.close()
    launches = _launches(gk, ck)
    rounds = eng._dispatched - d0
    counted = counted_rounds(eng, rounds, replayed0)
    require_launches(launches, {"gather_decrypt_rows_tiled": 3 * counted,
                                "scatter_encrypt_rows_tiled": 3 * counted}, "phase 16")
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
    """Keep every round's handle, each dispatched asking for its
    transcript (it rides the round's output copies); read each one's
    ``transcript`` once the run has resolved them."""
    log: list = []
    dispatch = eng._dispatch_round

    def dispatched(*a, **k):
        pending = dispatch(*a, **dict(k, transcript=True))
        log.append(pending)
        return pending

    eng._dispatch_round = dispatched
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

    import numpy as np

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
    trs = [p.transcript for p in trs]
    if len(trs) != len(t_trs) or not all(np.array_equal(a, b) for a, b in zip(trs, t_trs)):
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
    require_launches(twin_launches, {"cipher_rows_pallas": 6 * counted_rounds(twin, MESH_ROUNDS)},
                     "phase 18 twin")
    t_trs = [p.transcript for p in t_trs]
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
        twin_counted = counted_rounds(twin, 2 * PIPE_CHUNKS)
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
    require_launches(acc["twin"], {"gather_decrypt_rows": 3 * twin_counted,
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


#: phase 19: the obliviousness analyzer on the card
ANALYSIS_GEO = dict(max_messages=2**20, max_recipients=2**12, batch_size=2048,
                    vphases_impl="dense")
ANALYSIS_SMALL = dict(max_messages=2**14, max_recipients=2**10, batch_size=64,
                      vphases_impl="dense")
#: the production captures: (label, impl, evict_every, program, the
#: kernel nodes = the launches one eager call makes, as phases 4-6 require)
ANALYSIS_CAPTURES = (
    ("tiled_e1_round", "pallas_fused_tiled", 1, "round",
     {"gather_decrypt_rows_tiled": 3, "scatter_encrypt_rows_tiled": 3}),
    ("fused_e4_round", "pallas_fused", EVICT_EVERY, "round", {"gather_decrypt_rows": 3}),
    ("fused_e4_flush", "pallas_fused", EVICT_EVERY, "flush", {"scatter_encrypt_rows": 2}),
    ("pallas_e1_round", "pallas", 1, "round", {"cipher_rows_pallas": 6}),
)


def _no_jax(code: str) -> subprocess.Popen:
    """Start ``code`` in a process where ``import jax`` fails."""
    code = "import sys\nsys.modules['jax'] = None  # import jax raises ImportError\n" + code
    return subprocess.Popen([sys.executable, "-c", code],
                            cwd=os.path.dirname(os.path.abspath(__file__)),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _gate(module: str, *argv: str) -> subprocess.Popen:
    """Start ``python -m grapevine_tpu_torch.analysis.<module> <argv>``
    (on the card: no ``--device``) where ``import jax`` fails."""
    return _no_jax(f"import runpy\nsys.argv = [{module!r}, *{list(argv)!r}]\n"
                   f"runpy.run_module('grapevine_tpu_torch.analysis.{module}', "
                   "run_name='__main__')\n")


def _gate_result(proc: subprocess.Popen, module: str, want_caught: int, where: str) -> dict:
    """Wait for a gate started by :func:`_gate`: exit 0, its PASS line and
    ``want_caught`` mutants caught, or raise with its tail."""
    out, _ = proc.communicate(timeout=900)
    tail = out.strip().splitlines()[-14:]
    d = dict(rc=proc.returncode, mutants_caught=out.count("FAIL (expected)"),
             passed=any(ln.startswith(f"[{module}] PASS") for ln in tail))
    if proc.returncode != 0 or not d["passed"] or d["mutants_caught"] != want_caught:
        raise AssertionError(f"{where}: {module} without JAX failed:\n" + "\n".join(tail))
    return d


def _audit_line(rep, want=None) -> dict:
    """One capture's line; raises on a violation or, with ``want``, on
    kernel nodes other than the eager launches."""
    from grapevine_tpu_torch.analysis.fx_walk import kernel_nodes

    kn = dict(kernel_nodes(rep.capture.gm)) if rep.capture.gm is not None else {}
    line = dict(name=rep.name, nodes=rep.n_eqns, capture_s=rep.capture.seconds,
                audit_s=rep.audit_s, violations=[str(v) for v in rep.violations],
                allowlist_hits=sum(rep.allowed.values()), allowlist_sites=len(rep.allowed),
                kernel_nodes=kn)
    if rep.violations:
        raise AssertionError(f"phase 19a: {rep.summary()}")
    if want is not None and kn != want:
        raise AssertionError(f"phase 19a {rep.name}: kernel nodes {kn}, eager launches {want}")
    return line


def analysis_captures(GrapevineConfig) -> list:
    """Phase 19a: fake captures on CUDA tensors, each audited."""
    from grapevine_tpu_torch.analysis import check_oblivious as co
    from grapevine_tpu_torch.analysis.allowlist import ENGINE_ALLOWLIST as allow
    from grapevine_tpu_torch.engine.state import EngineConfig, init_engine

    lines = []
    for label, impl, ee, prog, want in ANALYSIS_CAPTURES:
        ecfg = EngineConfig.from_config(GrapevineConfig(
            **ANALYSIS_GEO, bucket_cipher_impl=impl, evict_every=ee))
        state = init_engine(ecfg, SEED, device="cuda")
        rep = (co.audit_engine_round(ecfg, allow, label, device="cuda", state=state)
               if prog == "round" else
               co.audit_engine_flush(ecfg, allow, label, device="cuda", state=state))
        lines.append(_audit_line(rep, want))
        del state, rep
        torch.cuda.empty_cache()
    small = EngineConfig.from_config(GrapevineConfig(
        **ANALYSIS_SMALL, bucket_cipher_impl="pallas_fused_tiled"))
    lines.append(_audit_line(
        co.audit_engine_round(small, allow, "small_tiled_e1", fast_ok=False, device="cuda"),
        ANALYSIS_CAPTURES[0][4]))
    lines.append(_audit_line(co.audit_expiry_sweep(small, allow, "small_tiled_e1",
                                                   device="cuda")))
    vp, srt, pmi, k, ee = co.DEFAULT_COMBOS[1]
    rec = pmi == "recursive"
    lines.append(_audit_line(co.audit_oram_round(allow, vp, srt, rec, k, ee, device="cuda")))
    lines.append(_audit_line(co.audit_lookup_remap(allow, vp, srt, rec, device="cuda")))
    lines.append(_audit_line(co.audit_oram_flush(allow, srt, rec, k, ee, device="cuda")))
    lines.append(_audit_line(co.audit_oram_flush(allow, srt, rec, k, ee, shards=2,
                                                 device="cuda", cipher_impl="pallas")))
    return lines


def _clone_tree(value):
    from grapevine_tpu_torch.analysis.fx_walk import flatten

    _, ts, rebuild = flatten(value, "")
    return rebuild([t.clone() for t in ts])


def _leaves_equal(ecfg, a, b, where: str) -> int:
    """Every output leaf of two round results equal (the trees' junk
    bucket, their last row, masked); returns the words compared."""
    from grapevine_tpu_torch.analysis.fx_walk import flatten

    labels, ta, _ = flatten(a, "out")
    _, tb, _ = flatten(b, "out")
    if len(ta) != len(tb):
        raise AssertionError(f"{where}: {len(ta)} leaves against {len(tb)}")
    words = 0
    for lb, x, y in zip(labels, ta, tb):
        if x.shape != y.shape or x.dtype != y.dtype:
            raise AssertionError(f"{where}: {lb} {tuple(x.shape)} against {tuple(y.shape)}")
        plane = lb.rsplit(".", 1)[-1]
        if plane in ("tree_idx", "tree_leaf"):
            z = ecfg.rec.bucket_slots
            x, y = x[:-z], y[:-z]
        elif plane in ("tree_val", "nonces"):
            x, y = x[:-1], y[:-1]
        if not torch.equal(x, y):
            raise AssertionError(f"{where}: {lb} differs")
        words += x.numel()
    return words


def _adversarial_batches(ecfg) -> list:
    """Two batches of B CREATEs: every op to one recipient, and every op
    to its own recipient."""
    from grapevine_tpu_torch.engine.state import KEY_WORDS, PAYLOAD_WORDS

    b, dev = ecfg.batch_size, torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)

    def rnd(*shape):
        return torch.randint(1, 1 << 31, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    out = []
    for distinct in (False, True):
        rcp = rnd(b, KEY_WORDS) if distinct else rnd(1, KEY_WORDS).expand(b, KEY_WORDS)
        out.append({"req_type": torch.full((b,), 1, dtype=torch.int32, device=dev),
                    "auth": rnd(b, KEY_WORDS), "msg_id": torch.zeros(b, 4, dtype=torch.int32,
                                                                    device=dev),
                    "recipient": rcp.contiguous(), "payload": rnd(b, PAYLOAD_WORDS),
                    "now": torch.tensor(NOW, dtype=torch.int32, device=dev),
                    "now_hi": torch.zeros((), dtype=torch.int32, device=dev)})
    return out


def analysis_census_replay(GrapevineConfig, gk, ck) -> dict:
    """Phase 19b: real-mode captures of the tiled round from two secret
    sets give one census; the replayed graph equals the eager round."""
    from grapevine_tpu_torch.analysis import check_oblivious as co
    from grapevine_tpu_torch.analysis.fx_walk import capture, census, kernel_nodes
    from grapevine_tpu_torch.engine import round_step
    from grapevine_tpu_torch.engine.state import EngineConfig, init_engine

    ecfg = EngineConfig.from_config(GrapevineConfig(
        **ANALYSIS_GEO, bucket_cipher_impl="pallas_fused_tiled"))

    def fn(st, ba, dr):
        return round_step.engine_round_step(ecfg, st, ba, draws=dr, fast_ok=True)

    states = [init_engine(ecfg, SEED + i, device="cuda") for i in (0, 1)]  # other keys
    batches = _adversarial_batches(ecfg)
    draws = [co.engine_draws(ecfg, st, "cuda") for st in states]
    _reset_launches(gk, ck)
    caps = [capture(fn, st, ba, dr, names=("state", "batch", "draws"),
                    tracing_mode="real", name=f"tiled_round/{v}")
            for st, ba, dr, v in zip(states, batches, draws, ("one_recipient", "distinct"))]
    torch.cuda.synchronize()
    capture_launches = _launches(gk, ck)
    censuses = [census(c.gm, shapes=True) for c in caps]
    if censuses[0] != censuses[1]:
        diff = (censuses[0] - censuses[1]) + (censuses[1] - censuses[0])
        raise AssertionError(f"phase 19b: the censuses differ: {dict(list(diff.items())[:8])}")
    want = ANALYSIS_CAPTURES[0][4]
    for c in caps:
        if dict(kernel_nodes(c.gm)) != want:
            raise AssertionError(f"phase 19b: kernel nodes {dict(kernel_nodes(c.gm))}")
    # the replay, then the eager round (it writes the trees in place)
    from grapevine_tpu_torch.analysis.fx_walk import flatten

    flat = [t for v, n in zip((states[0], batches[0], draws[0]), ("state", "batch", "draws"))
            for t in flatten(v, n)[1]]
    _reset_launches(gk, ck)
    t0 = time.perf_counter()
    replayed = caps[0].gm(*flat)
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    replay_launches = _launches(gk, ck)
    _reset_launches(gk, ck)
    eager = fn(states[0], batches[0], draws[0])
    torch.cuda.synchronize()
    eager_launches = _launches(gk, ck)
    _, eager_leaves, rebuild = flatten(eager, "out")
    words = _leaves_equal(ecfg, rebuild(list(replayed)), eager, "phase 19b replay")
    op_route = {k: capture_launches[k] + replay_launches[k] for k in KERNELS}
    require_launches(op_route, {"gather_decrypt_rows_tiled": 9,
                                "scatter_encrypt_rows_tiled": 9}, "phase 19b op route")
    require_launches(eager_launches, want, "phase 19b eager round")
    return dict(census_ops=sum(censuses[0].values()), census_keys=len(censuses[0]),
                nodes=[sum(1 for n in c.gm.graph.nodes if n.op == "call_function")
                       for c in caps],
                capture_s=[c.seconds for c in caps], replay_s=replay_s,
                words_equal=words, leaves=len(eager_leaves), op_route_launches=op_route,
                eager_launches=eager_launches)


def analysis_slow_walk(GrapevineConfig, gk, ck) -> dict:
    """Phase 19c: the on-device slow admission walk at the production
    point, under sync-debug "error", equals the fast branch."""
    from grapevine_tpu_torch.analysis import check_oblivious as co
    from grapevine_tpu_torch.engine import round_step
    from grapevine_tpu_torch.engine.state import EngineConfig, init_engine

    ecfg = EngineConfig.from_config(GrapevineConfig(
        **ANALYSIS_GEO, bucket_cipher_impl="pallas_fused_tiled"))
    state = init_engine(ecfg, SEED, device="cuda")
    batch = co.census_variants(ecfg, "cuda")["mixed"]
    draws = co.engine_draws(ecfg, state, "cuda")
    fast_ok = round_step.admission_fast_ok(ecfg, *torch.stack(
        [state.free_top, state.recipients]).tolist(), ecfg.batch_size)
    if not fast_ok:
        raise AssertionError("phase 19c: the fresh state must admit the fast branch")

    def run(fast: bool) -> tuple:
        st = _clone_tree(state)
        torch.cuda.synchronize()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        if not fast:
            torch.cuda.set_sync_debug_mode("error")
        try:
            out = round_step.engine_round_step(ecfg, st, batch, draws=draws, fast_ok=fast)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        e1.record()
        dispatch_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        return out, dict(dispatch_ms=dispatch_s * 1e3,
                         wall_ms=(time.perf_counter() - t0) * 1e3,
                         device_ms=e0.elapsed_time(e1))

    run(True)  # warm-up
    _reset_launches(gk, ck)
    fast_out, fast_t = run(True)
    slow_out, slow_t = run(False)
    launches = _launches(gk, ck)
    words = _leaves_equal(ecfg, slow_out, fast_out, "phase 19c slow walk")
    require_launches(launches, {"gather_decrypt_rows_tiled": 6,
                                "scatter_encrypt_rows_tiled": 6}, "phase 19c")
    return dict(fast=fast_t, slow=slow_t, words_equal=words, sync_debug="error",
                launches=launches)


def b2_routes(GrapevineConfig, gk, ck) -> dict:
    """B2 at the op-major records shape through its wrapper (direct) and
    through its custom op (the capture route): equal outputs; device ms
    (``cuda_ms``) and host µs a call."""
    from grapevine_tpu_torch.engine.state import EngineConfig
    from grapevine_tpu_torch.oram.path_oram import path_bucket_indices

    cfg = EngineConfig.from_config(GrapevineConfig(
        max_messages=2**20, max_recipients=2**12, batch_size=8, commit="op",
        bucket_cipher_impl="pallas")).rec
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 23)
    z, zv, r, rounds = cfg.bucket_slots, cfg.bucket_slots * cfg.value_words, cfg.path_len, \
        cfg.cipher_rounds

    def rnd(*shape):
        return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    leaf = torch.randint(0, cfg.leaves, (), generator=gen, device=dev).to(torch.int32)
    args = (rnd(8), path_bucket_indices(cfg, leaf).contiguous(), rnd(r, 2), rnd(r, z),
            rnd(r, zv))
    routes = {"direct": lambda: ck.cipher_rows_pallas(*args, rounds=rounds),
              "op": lambda: torch.ops.gv.cipher_rows_pallas(*args, rounds)}
    outs = {k: f() for k, f in routes.items()}
    err = max(max_err(a, b) for a, b in zip(outs["direct"], outs["op"]))
    line = dict(rows=r, row_words=z + zv, max_abs_err=err)
    for k, f in routes.items():
        line[f"{k}_ms"] = cuda_ms(f, 200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            f()
        line[f"{k}_host_us"] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    if err:
        raise AssertionError(f"phase 19: B2's two routes differ: {line}")
    return line


def run_analysis_phase(GrapevineConfig, gk, ck, card) -> dict:
    """Phase 19: (a) audited fake captures on the card, (b) census and
    replay of real-mode captures, (c) the slow admission walk, (d) the
    analyzer's smoke gate without JAX; B2's two routes."""
    t_phase = time.perf_counter()
    smoke = _gate("check_oblivious", "--smoke")
    try:
        return _analysis_parts(GrapevineConfig, gk, ck, card, smoke, t_phase)
    except BaseException:
        smoke.kill()
        smoke.wait()
        raise


def _analysis_parts(GrapevineConfig, gk, ck, card, smoke, t_phase) -> dict:
    t0 = time.perf_counter()
    a = analysis_captures(GrapevineConfig)
    a_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    b = analysis_census_replay(GrapevineConfig, gk, ck)
    b_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = analysis_slow_walk(GrapevineConfig, gk, ck)
    c_s = time.perf_counter() - t0
    launches = {k: b["op_route_launches"][k] + b["eager_launches"][k] + c["launches"][k]
                for k in KERNELS}
    routes = b2_routes(GrapevineConfig, gk, ck)
    d = _gate_result(smoke, "check_oblivious", 9, "phase 19d")
    d["wall_s"] = time.perf_counter() - t_phase
    return dict(a=a, b=b, c=c, d=d, routes=routes, launches=launches, card=card,
                split_s=dict(a=a_s, b=b_s, c=c_s), phase_s=time.perf_counter() - t_phase)


def emit_analysis_lines(an: dict) -> None:
    for line in an["a"]:
        emit({"analysis_capture": line})
    emit({"analysis_census_replay": an["b"]})
    emit({"analysis_slow_walk": an["c"], "card": an["card"]})
    emit({"analysis_smoke_no_jax": an["d"]})
    emit({"analysis_b2_routes": an["routes"], "card": an["card"]})
    emit({"analysis_phase_s": an["phase_s"], "split_s": an["split_s"],
          "analysis_launches": an["launches"]})


def analysis_phase_alone() -> int:
    """Phase 19 alone: the card line, the kernel build, then the analyzer
    phase; 0 if every check held."""
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.oblivious import cipher_kernels as ck
    from grapevine_tpu_torch.oblivious import gather_kernels as gk

    card = card_line()
    emit({"card": card})
    t0 = time.perf_counter()
    gk.build_library()
    gk.load_library()
    emit({"build_s": time.perf_counter() - t0})
    an = run_analysis_phase(GrapevineConfig, gk, ck, card)
    emit_analysis_lines(an)
    emit({"analysis_phase_alone_s": time.perf_counter() - t0, "card": card})
    return 0


#: phase 20: the range analyzer and the traced cost model on the card —
#: 20c's real captures, and the kernels they launch through their ops
WITNESS_ROUNDS = (("tiled_e1_round", "pallas_fused_tiled",
                   {"gather_decrypt_rows_tiled": 3, "scatter_encrypt_rows_tiled": 3}),
                  ("pallas_e1_round", "pallas", {"cipher_rows_pallas": 6}))

#: 20b: the default sweep at geometry 30 in 4 processes, states faked on
#: the card (nothing allocated), with its reachability, mutants and the
#: design point
_RANGE_GEOMETRY = """
import json, time
t0 = time.perf_counter()
from grapevine_tpu_torch.analysis import check_ranges as cr
from grapevine_tpu_torch.analysis.allowlist import RANGE_ALLOWLIST
from grapevine_tpu_torch.analysis.mutants import run_range_mutants
problems, hits, lines = cr.run_audit(cr.DEFAULT_COMBOS, cr.DEFAULT_GEOMETRY, device="cuda",
                                     cipher_impls=cr.DEFAULT_CIPHER_IMPLS, jobs=4)
mutants = {n: [k, h, sorted({f.kind for f in r.findings})]
           for n, (r, k, h) in run_range_mutants(RANGE_ALLOWLIST).items()}
dp, refusal = cr.certify_design_point(cr.DESIGN_POINT)
print(json.dumps(dict(problems=problems + dp, dead=cr.check_allowlist_reachability(hits),
                      entries=len(RANGE_ALLOWLIST), reached=len(hits), programs=len(lines),
                      nodes=sum(ln["nodes"] for ln in lines),
                      card_bytes=max(ln["card_bytes"] for ln in lines),
                      kernels=sorted({k for ln in lines for k in ln["kernels"]}),
                      mutants=mutants, refusal=refusal, s=time.perf_counter() - t0)))
"""


def _range_line(rep) -> dict:
    """One audited capture's line; raises on a finding."""
    if rep.findings:
        raise AssertionError(f"phase 20a: {rep.summary()}")
    un = sum(rep.unmodeled.values())
    return dict(name=rep.name, nodes=rep.n_eqns, capture_s=rep.capture.seconds,
                audit_s=rep.audit_s, findings=0, allowlist_hits=rep.allowed,
                kernels_certified=rep.kernels, unmodeled=rep.unmodeled,
                unmodeled_share=un / max(1, rep.n_eqns))


def range_captures(GrapevineConfig) -> list:
    """Phase 20a: phase 19a's fake captures on CUDA tensors, interval-audited."""
    from grapevine_tpu_torch.analysis import check_oblivious as co
    from grapevine_tpu_torch.analysis import check_ranges as cr
    from grapevine_tpu_torch.analysis.allowlist import RANGE_ALLOWLIST as allow
    from grapevine_tpu_torch.engine.state import EngineConfig, init_engine

    lines = []
    for label, impl, ee, prog, _ in ANALYSIS_CAPTURES:
        ecfg = EngineConfig.from_config(GrapevineConfig(
            **ANALYSIS_GEO, bucket_cipher_impl=impl, evict_every=ee))
        state = init_engine(ecfg, SEED, device="cuda")
        rep = (cr.audit_engine_round(ecfg, allow, label, device="cuda", inputs=(
                   state, co.batch_spec(ecfg, "cuda"), co.engine_draws(ecfg, state, "cuda")))
               if prog == "round" else
               cr.audit_engine_flush(ecfg, allow, label, device="cuda", state=state))
        lines.append(_range_line(rep))
        del state, rep
        torch.cuda.empty_cache()
    small = EngineConfig.from_config(GrapevineConfig(
        **ANALYSIS_SMALL, bucket_cipher_impl="pallas_fused_tiled"))
    state = init_engine(small, SEED, device="cuda")
    lines.append(_range_line(cr.audit_engine_round(
        small, allow, "small_tiled_e1", fast_ok=False, device="cuda",
        inputs=(state, co.batch_spec(small, "cuda"), co.engine_draws(small, state, "cuda")))))
    lines.append(_range_line(cr.audit_expiry_sweep(small, allow, "small_tiled_e1",
                                                   device="cuda", state=state,
                                                   one_chunk=False)))
    return lines


def range_witness(GrapevineConfig, gk, ck) -> list:
    """Phase 20c: real captures of the tiled and the ``"pallas"`` round at
    the production point; every integer node's observed values inside its
    certified interval, the replay equal to the eager round on every word
    (junk masked), the replay's launches through ``torch.ops.gv``."""
    from grapevine_tpu_torch.analysis import check_oblivious as co
    from grapevine_tpu_torch.analysis import rangelint
    from grapevine_tpu_torch.analysis.allowlist import RANGE_ALLOWLIST
    from grapevine_tpu_torch.analysis.fx_walk import capture, flatten
    from grapevine_tpu_torch.engine import round_step
    from grapevine_tpu_torch.engine.state import EngineConfig, init_engine

    lines = []
    for label, impl, want in WITNESS_ROUNDS:
        ecfg = EngineConfig.from_config(GrapevineConfig(**ANALYSIS_GEO,
                                                        bucket_cipher_impl=impl))

        def fn(st, ba, dr):
            return round_step.engine_round_step(ecfg, st, ba, draws=dr, fast_ok=True)

        state = init_engine(ecfg, SEED, device="cuda")
        batch = co.census_variants(ecfg, "cuda")["mixed"]
        draws = co.engine_draws(ecfg, state, "cuda")
        _reset_launches(gk, ck)
        cap = capture(fn, state, batch, draws, names=("state", "batch", "draws"),
                      tracing_mode="real", name=f"witness/{label}")
        torch.cuda.synchronize()
        capture_launches = _launches(gk, ck)
        t0 = time.perf_counter()
        rep = rangelint.audit_ranges(cap, round_step.RANGELINT_BOUNDS(ecfg), RANGE_ALLOWLIST)
        audit_s = time.perf_counter() - t0
        if rep.findings:
            raise AssertionError(f"phase 20c: {rep.summary()}")
        flat = [t for v, n in zip((state, batch, draws), ("state", "batch", "draws"))
                for t in flatten(v, n)[1]]
        _reset_launches(gk, ck)
        t0 = time.perf_counter()
        w = rangelint.witness(rep, *flat)
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
        replay_launches = _launches(gk, ck)
        require_launches(replay_launches, want, f"phase 20c {label} replay")
        if w["violations"]:
            raise AssertionError(f"phase 20c {label}: observed values outside their "
                                 f"certified intervals: {w['violations'][:8]}")
        _reset_launches(gk, ck)
        eager = fn(state, batch, draws)
        torch.cuda.synchronize()
        eager_launches = _launches(gk, ck)
        require_launches(eager_launches, want, f"phase 20c {label} eager round")
        _, _, rebuild = flatten(eager, "out")
        words = _leaves_equal(ecfg, rebuild(list(w["out"])), eager, f"phase 20c {label}")
        lines.append(dict(
            name=label, nodes=rep.n_eqns, capture_s=cap.seconds, audit_s=audit_s,
            replay_s=replay_s, checked=w["checked"], full_lane=w["full_lane"],
            violations=0, tightest_margin=w["margin"], words_equal=words,
            launches={k: capture_launches[k] + replay_launches[k] + eager_launches[k]
                      for k in KERNELS},
            replay_launches={k: n for k, n in replay_launches.items() if n}))
        del cap, rep, w, eager, state, flat
        torch.cuda.empty_cache()
    return lines


def _headline_ms(shapes, name: str):
    """Phase 3's measured ms for ``name`` on the path ``PER`` names (None
    when phase 3 did not run)."""
    if shapes is None:
        return None
    pick = {(s["tree"], s["shape"]): s for s in shapes if s["kernel"] == name}
    return sum(c * pick[(t, sh)]["ms"] for t, sh, c in PER[name][1])


def cost_traced(GrapevineConfig, shapes) -> dict:
    """Phase 20d: the analytic ledger against the traced rows at the
    production point (fake captures on the card), and the ledger's bytes
    per kernel path beside phase 3's measured ms of this run."""
    from grapevine_tpu_torch.analysis import costmodel as cm
    from grapevine_tpu_torch.engine.state import EngineConfig

    e1 = EngineConfig.from_config(GrapevineConfig(**ANALYSIS_GEO,
                                                  bucket_cipher_impl="pallas_fused_tiled"))
    e4 = EngineConfig.from_config(GrapevineConfig(**ANALYSIS_GEO, bucket_cipher_impl="pallas_fused",
                                                  evict_every=EVICT_EVERY))
    checks = (("round_e1", cm.cross_validate_engine_round, (e1,)),
              ("round_e4", cm.cross_validate_engine_round, (e4,)),
              ("flush_e4", cm.cross_validate_engine_flush, (e4,)),
              ("sweep_e1", cm.cross_validate_sweep, (e1,)),
              ("sharded_flush_records_e4", cm.cross_validate_sharded_flush, (e4.rec, 2)))
    agreed = {}
    for name, fn, args in checks:
        t0 = time.perf_counter()
        rows = fn(*args, device="cuda")  # raises CostModelMismatch
        agreed[name] = dict(classes=len(rows), rows=sum(g + s for g, s in rows.values()),
                            s=time.perf_counter() - t0)
    l1, l4 = cm.engine_cost_ledger(e1), cm.engine_cost_ledger(e4)
    paths = {
        "gather_decrypt_rows_tiled": ("E=1 fetch", l1.phases["fetch"].hbm_bytes),
        "scatter_encrypt_rows_tiled": ("E=1 write-back", l1.phases["writeback"].hbm_bytes),
        "gather_decrypt_rows": ("E=4 fetch", l4.phases["fetch"].hbm_bytes),
        "scatter_encrypt_rows": ("E=4 flush", l4.phases["flush"].hbm_bytes),
        "cipher_rows_pallas": ("E=1 fetch + write-back",
                               l1.phases["fetch"].hbm_bytes + l1.phases["writeback"].hbm_bytes),
    }
    per_kernel = {k: dict(path=p, ledger_bytes=b, measured_ms=_headline_ms(shapes, k))
                  for k, (p, b) in paths.items()}
    return dict(mismatches=0, agreed=agreed, per_kernel=per_kernel,
                sweep_ledger_bytes=l1.phases["sweep"].hbm_bytes)


def run_range_phase(GrapevineConfig, gk, ck, card, shapes=None) -> dict:
    """Phase 20: (a) interval audits of phase 19a's captures, (b) the
    geometry-30 sweep (a process of its own, beside), (c) the witness of
    real rounds, (d) the traced cost model, (e) both drivers' ``--smoke``
    without JAX (beside; (d)'s nine cost mutants are (e)'s)."""
    t_phase = time.perf_counter()
    geo30 = _no_jax(_RANGE_GEOMETRY)
    gates = {m: _gate(m, "--smoke") for m in ("check_ranges", "check_cost_model")}
    try:
        return _range_parts(GrapevineConfig, gk, ck, card, shapes, geo30, gates, t_phase)
    except BaseException:
        for proc in (geo30, *gates.values()):
            proc.kill()
            proc.wait()
        raise


def _range_parts(GrapevineConfig, gk, ck, card, shapes, geo30, gates, t_phase) -> dict:
    split = {}
    t0 = time.perf_counter()
    a = range_captures(GrapevineConfig)
    split["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c = range_witness(GrapevineConfig, gk, ck)
    split["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = cost_traced(GrapevineConfig, shapes)
    split["d"] = time.perf_counter() - t0
    e = {"check_ranges": _gate_result(gates["check_ranges"], "check_ranges", 6, "phase 20e"),
         "check_cost_model": _gate_result(gates["check_cost_model"], "check_cost_model", 9,
                                          "phase 20e")}
    d["cost_mutants_caught"] = e["check_cost_model"]["mutants_caught"]
    out, _ = geo30.communicate(timeout=900)
    if geo30.returncode != 0:
        raise AssertionError("phase 20b failed:\n" + out[-4000:])
    b = json.loads(out.strip().splitlines()[-1])
    wrong = [n for n, (k, hit, kinds) in b["mutants"].items() if not hit or k not in kinds]
    # nothing of a 2^30 tree may be allocated: at most a few KB of small
    # real tensors in a process
    if b["problems"] or b["dead"] or wrong or "certified bound" not in b["refusal"] \
            or b["card_bytes"] > 1 << 20:
        raise AssertionError(f"phase 20b: {b}")
    split["b_done_at"] = time.perf_counter() - t_phase
    launches = {k: sum(ln["launches"][k] for ln in c) for k in KERNELS}
    return dict(a=a, b=b, c=c, d=d, e=e, launches=launches, card=card, split_s=split,
                phase_s=time.perf_counter() - t_phase)


def emit_range_lines(rp: dict) -> None:
    for line in rp["a"]:
        emit({"range_capture": line})
    emit({"range_geometry": rp["b"]})
    for line in rp["c"]:
        emit({"range_witness": line, "card": rp["card"]})
    emit({"cost_traced": rp["d"], "card": rp["card"]})
    emit({"range_smoke_no_jax": rp["e"]})
    emit({"range_phase_s": rp["phase_s"], "split_s": rp["split_s"],
          "range_launches": rp["launches"]})


def range_phase_alone() -> int:
    """Phase 20 alone: the card line, the kernel build, then the range
    phase (20d's kernel ms are phase 3's, which does not run: null)."""
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.oblivious import cipher_kernels as ck
    from grapevine_tpu_torch.oblivious import gather_kernels as gk

    card = card_line()
    emit({"card": card})
    t0 = time.perf_counter()
    gk.build_library()
    gk.load_library()
    emit({"build_s": time.perf_counter() - t0})
    rp = run_range_phase(GrapevineConfig, gk, ck, card)
    emit_range_lines(rp)
    emit({"range_phase_alone_s": time.perf_counter() - t0, "card": card})
    return 0


#: phase 21: the census gates at the production point (k=4)
CENSUS_TILED = dict(ANALYSIS_GEO, bucket_cipher_impl="pallas_fused_tiled")
CENSUS_EVICT = dict(ANALYSIS_GEO, bucket_cipher_impl="pallas_fused", evict_every=EVICT_EVERY)


def _census_trees(ecfg, state) -> list:
    """(tree, ORAM config, ORAM state, indices a round) of both trees."""
    b = ecfg.batch_size
    return [("records", ecfg.rec, state.rec, b),
            ("mailbox", ecfg.mb, state.mb, b * ecfg.mb_choices)]


def _require_kernels(launches: dict, some: tuple, where: str) -> None:
    """Each kernel of ``some`` launched, and no other."""
    for name, n in launches.items():
        if (n > 0) != (name in some):
            raise AssertionError(f"{where}: {name} launched {n} times, want "
                                 f"{'some' if name in some else 'none'}")


def census_rounds(GrapevineConfig, gk, ck) -> dict:
    """Phase 21a: real captures of the records and mailbox ``oram_round``
    for each of the four index sets — one census, no control node, each
    tree plane ``B·(path_len−4)`` rows, the cache planes ``B·4`` — and a
    fake capture at k=0 moving ``B·path_len``."""
    from grapevine_tpu_torch.analysis import check_tree_cache_oblivious as ctc
    from grapevine_tpu_torch.analysis.costmodel import trace_oram_round
    from grapevine_tpu_torch.engine.state import EngineConfig, init_engine

    ecfg = EngineConfig.from_config(GrapevineConfig(**CENSUS_TILED))
    state = init_engine(ecfg, SEED, device="cuda")
    _reset_launches(gk, ck)
    lines = []
    for tree, cfg, st, n in _census_trees(ecfg, state):
        if cfg.top_cache_levels != min(4, cfg.height):
            raise AssertionError(f"phase 21a {tree}: k={cfg.top_cache_levels}")
        acc = ctc.round_accounting(cfg, n, "cuda", state=st, what=f"phase 21a {tree}")
        if "cache_idx" not in acc["rows"] or acc["kernel_nodes"] != {
                "gather_decrypt_rows_tiled": 1, "scatter_encrypt_rows_tiled": 1}:
            raise AssertionError(f"phase 21a {tree}: {acc['rows']} {acc['kernel_nodes']}")
        k0 = dataclasses.replace(cfg, top_cache_levels=0)
        cap0 = trace_oram_round(k0, n, "cuda")
        rows0 = ctc.capture_rows(cap0, ctc.tree_planes(k0), root="arg0")
        full = n * cfg.path_len
        if any(not r or {x for _, x in r} != {full} for r in rows0.values()):
            raise AssertionError(f"phase 21a {tree} k=0: {rows0}, want {full} rows a plane")
        lines.append(dict(tree=tree, b=n, path_len=cfg.path_len, k=cfg.top_cache_levels,
                          want_rows=acc["want"],
                          rows=acc["rows"], nodes=acc["info"]["nodes"],
                          census_ops=acc["info"]["census_size"],
                          capture_s=acc["info"]["capture_s"], kernel_nodes=acc["kernel_nodes"],
                          k0_rows={p: sorted({x for _, x in r}) for p, r in rows0.items()},
                          k0_capture_s=cap0.seconds))
    torch.cuda.synchronize()
    launches = _launches(gk, ck)
    # each real capture runs the round: one B4 and one B6 launch
    require_launches(launches, {"gather_decrypt_rows_tiled": 8,
                                "scatter_encrypt_rows_tiled": 8}, "phase 21a")
    return dict(lines=lines, launches=launches)


def census_evict(GrapevineConfig, gk, ck) -> dict:
    """Phase 21b: at E=4 (``"pallas_fused"``) each tree's fetch round is
    index-blind and read-only on the trees and one real flush scatters
    ``t`` rows a plane; on a 2-shard virtual mesh of the card the records
    tree's per-shard shapes hold, the owner partition holds at run time
    and the unmasked-scatter mutant is caught."""
    from grapevine_tpu_torch.analysis import check_tree_cache_oblivious as ctc
    from grapevine_tpu_torch.engine.state import EngineConfig, init_engine
    from grapevine_tpu_torch.parallel.mesh import make_mesh

    ecfg = EngineConfig.from_config(GrapevineConfig(**CENSUS_EVICT))
    state = init_engine(ecfg, SEED, device="cuda")
    _reset_launches(gk, ck)
    lines = []
    for tree, cfg, st, n in _census_trees(ecfg, state):
        acc = ctc.evict_accounting(cfg, n, "cuda", state=st, flush_state=st,
                                   what=f"phase 21b {tree}")
        lines.append(dict(tree=tree, b=n, window=cfg.evict_window, fetch=acc["fetch"],
                          flush=acc["flush"], t=acc["want_flush_rows"],
                          nodes=acc["info"]["nodes"], flush_nodes=acc["info"]["flush_nodes"],
                          capture_s=acc["info"]["capture_s"],
                          flush_capture_s=acc["info"]["flush_capture_s"]))
    torch.cuda.synchronize()
    launches = _launches(gk, ck)
    # a real fetch capture launches B3 once; a real flush B5 once
    require_launches(launches, {"gather_decrypt_rows": 8, "scatter_encrypt_rows": 2},
                     "phase 21b")
    b, cfg = ecfg.batch_size, ecfg.rec
    mesh = make_mesh(["cuda", "cuda"])
    del st
    _reset_launches(gk, ck)
    t0 = time.perf_counter()
    sh = ctc.sharded_accounting(cfg, b, mesh, "cuda", state=ctc.clone_state(state.rec),
                                what="phase 21b")
    part = ctc.owner_partition(cfg, b, mesh, "cuda", state=ctc.clone_state(state.rec))
    try:
        ctc.owner_partition(cfg, b, mesh, "cuda", state=state.rec, _unmasked_scatter=True)
    except AssertionError as exc:
        if "owner partition violated" not in str(exc):
            raise
        caught = str(exc)[:160]
    else:
        raise AssertionError("phase 21b: the unmasked-scatter mutant passed the owner "
                             "partition check")
    torch.cuda.synchronize()
    sharded_launches = _launches(gk, ck)
    # the sharded path decrypts and encrypts through B2; its one-device
    # twin runs B3 and B5
    _require_kernels(sharded_launches, ("cipher_rows_pallas", "gather_decrypt_rows",
                                        "scatter_encrypt_rows"), "phase 21b sharded")
    sharded = dict(shards=sh["shards"], fetch=sh["fetch"], flush=sh["flush"],
                   t=sh["want_flush_rows"], nodes=sh["info"]["nodes"],
                   capture_s=sh["info"]["capture_s"], **part, mutants_caught=1,
                   mutant=caught, s=time.perf_counter() - t0)
    total = {k: launches[k] + sharded_launches[k] for k in KERNELS}
    return dict(lines=lines, sharded=sharded, launches=total)


def census_posmap(GrapevineConfig, gk, ck) -> dict:
    """Phase 21c: the records tree's position-map lookup at phase 14's
    knobs (recursive map, radix) is index-blind, with the flat map's
    lookup as the positive control."""
    from grapevine_tpu_torch.analysis import check_posmap_oblivious as cpo
    from grapevine_tpu_torch.engine.state import EngineConfig, init_engine

    out = {}
    _reset_launches(gk, ck)
    for name, knobs in (("flat", dict(sort_impl="radix")), ("recursive", POSMAP_KNOBS)):
        ecfg = EngineConfig.from_config(GrapevineConfig(**CENSUS_TILED, **knobs))
        state = init_engine(ecfg, SEED, device="cuda")
        out[name] = cpo.schedule_census(ecfg.rec, ecfg.batch_size, "dense", "radix", "cuda",
                                        f"phase 21c {name}", pm_state=state.rec.posmap)
        del state
        torch.cuda.empty_cache()
    cpo.positive_control(out)
    torch.cuda.synchronize()
    return dict(lines=out, launches=_launches(gk, ck))


def census_sorts(GrapevineConfig) -> dict:
    """Phase 21d: fake captures at the production point — the radix
    records round holds no sort node, the xla one some; the scan engine
    round's radix residue is the reference's wide-key sites."""
    from grapevine_tpu_torch.analysis import check_sort_radix as csr
    from grapevine_tpu_torch.analysis.costmodel import trace_engine_round
    from grapevine_tpu_torch.analysis.fx_walk import sort_census
    from grapevine_tpu_torch.engine.state import EngineConfig

    ecfg = EngineConfig.from_config(GrapevineConfig(**CENSUS_TILED))
    t0 = time.perf_counter()
    oram = {impl: sum(sort_census(csr.capture_oram_round(ecfg.rec, ecfg.batch_size, impl,
                                                         "cuda").gm).values())
            for impl in ("radix", "xla")}
    if oram["radix"] != 0 or oram["xla"] == 0:
        raise AssertionError(f"phase 21d: records round sorts {oram}")
    caps = {impl: trace_engine_round(EngineConfig.from_config(GrapevineConfig(
        **dict(CENSUS_TILED, vphases_impl="scan"), sort_impl=impl)), "cuda")
        for impl in ("radix", "xla")}
    engine = csr.engine_sort_residue(caps["radix"].gm, caps["xla"].gm)
    return dict(oram_round=oram, engine_round=engine,
                capture_s={k: c.seconds for k, c in caps.items()}, s=time.perf_counter() - t0)


def census_telemetry(GrapevineConfig, GrapevineEngine, gk, ck, gate) -> dict:
    """Phase 21e: the telemetry gate where ``import jax`` fails (exit 0),
    then its namespace rules on the live registry of a production engine
    that served two rounds with every round observer attached."""
    from grapevine_tpu_torch.analysis import check_telemetry_policy as ctp
    from grapevine_tpu_torch.obs import attach_round_observability

    eng = GrapevineEngine(GrapevineConfig(**CENSUS_TILED), seed=SEED)
    attach_round_observability(eng, eng.metrics.registry)
    _reset_launches(gk, ck)
    run_slice(eng, 2, writes=False, profile_last=False)
    launches = _launches(gk, ck)
    # three B4 and three B6 an engine round (the slice's two, and any the
    # observers add)
    b4, b6 = launches["gather_decrypt_rows_tiled"], launches["scatter_encrypt_rows_tiled"]
    _require_kernels(launches, ("gather_decrypt_rows_tiled", "scatter_encrypt_rows_tiled"),
                     "phase 21e engine")
    if b4 != b6 or b4 < 6 or b4 % 3:
        raise AssertionError(f"phase 21e engine: {b4} B4 and {b6} B6 launches")
    live = ctp.audit_live_registry(eng.metrics.registry)
    scan = ctp.scan_call_sites()
    if scan:
        raise AssertionError(f"phase 21e: {scan}")
    eng.close()
    d = _gate_result(gate, "check_telemetry_policy", 0, "phase 21e")
    return dict(gate=d, live=dict(metrics=live["metrics"], series=live["series"],
                                  namespaces=live["namespaces"]),
                scan_violations=0, launches=launches)


def run_census_phase(GrapevineConfig, GrapevineEngine, gk, ck, card) -> dict:
    """Phase 21: (a) the tree-top cache's census and rows, (b) delayed
    eviction and the sharded flush, (c) the position map, (d) the radix
    audit, (e) the telemetry gate (its process beside the rest)."""
    t_phase = time.perf_counter()
    gate = _gate("check_telemetry_policy")
    try:
        return _census_parts(GrapevineConfig, GrapevineEngine, gk, ck, card, gate, t_phase)
    except BaseException:
        gate.kill()
        gate.wait()
        raise


def _census_parts(GrapevineConfig, GrapevineEngine, gk, ck, card, gate, t_phase) -> dict:
    split, parts = {}, {}
    for key, fn in (("a", lambda: census_rounds(GrapevineConfig, gk, ck)),
                    ("b", lambda: census_evict(GrapevineConfig, gk, ck)),
                    ("c", lambda: census_posmap(GrapevineConfig, gk, ck)),
                    ("d", lambda: census_sorts(GrapevineConfig)),
                    ("e", lambda: census_telemetry(GrapevineConfig, GrapevineEngine, gk, ck,
                                                   gate))):
        t0 = time.perf_counter()
        parts[key] = fn()
        split[key] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    launches = {k: sum(parts[p].get("launches", {}).get(k, 0) for p in parts) for k in KERNELS}
    return dict(**parts, launches=launches, card=card, split_s=split,
                phase_s=time.perf_counter() - t_phase)


def emit_census_lines(cz: dict) -> None:
    card = cz["card"]
    emit({"census_rounds": cz["a"]["lines"], "card": card})
    emit({"census_evict": cz["b"]["lines"], "card": card})
    emit({"census_sharded": cz["b"]["sharded"], "card": card})
    emit({"census_posmap": cz["c"]["lines"], "card": card})
    emit({"census_sorts": {k: v for k, v in cz["d"].items()}, "card": card})
    emit({"census_telemetry": {k: v for k, v in cz["e"].items() if k != "launches"},
          "card": card})
    emit({"census_phase_s": cz["phase_s"], "split_s": cz["split_s"],
          "census_launches": cz["launches"]})


def census_phase_alone() -> int:
    """Phase 21 alone: the card line, the kernel build, then the census
    phase."""
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
    cz = run_census_phase(GrapevineConfig, GrapevineEngine, gk, ck, card)
    emit_census_lines(cz)
    emit({"census_phase_alone_s": time.perf_counter() - t0, "card": card})
    return 0


#: phase 22: the crash-recovery chaos harness on the card. (a) the
#: production point, durable, no checkpoint (as phase 9a at 2^20)
CHAOS_PROD = ["--geometry", "prod", "--bucket-cipher-impl", "pallas_fused",
              "--tree-top-cache-levels", "4", "--evict-every", str(EVICT_EVERY),
              "--pipeline-depth", "2", "--checkpoint-every", str(1 << 20),
              "--events", "12", "--reqs", "256", "2048", "--users", "1024",
              "--seed", "22", "--jobs", "5"]
CHAOS_PROD_MODES = ("round.post_dispatch", "flush.pre_dispatch", "flush.post_dispatch",
                    "journal.append.torn", "timer")
#: (b) phase 9b's geometry at E=2 with checkpoints, so every site fires
CHAOS_SMALL = ["--geometry", "small", "--bucket-cipher-impl", "pallas_fused",
               "--evict-every", "2", "--pipeline-depth", "2", "--checkpoint-every", "5",
               "--events", "16", "--reqs", "16", "64", "--users", "256", "--seed", "23",
               "--jobs", "12"]
CHAOS_SHARDED_MODES = ("round.pre_dispatch", "round.post_dispatch", "flush.pre_dispatch",
                       "flush.post_dispatch")
CHAOS_STANDBY_MODES = ("round.post_dispatch", "flush.pre_dispatch")


def chaos_campaign(chaos, argv: list, modes, orc=None, where: str = "") -> tuple[list, dict]:
    """One campaign of ``chaos_run`` on the card; raises with every
    failure line. Returns the trial reports and the oracle."""
    args = chaos.parse_args(["--device", "cuda", *argv])
    reports: list = []
    failures = chaos.run_trials(0, args, modes=list(modes), reports=reports, orc=orc)
    if failures:
        raise AssertionError(f"phase 22{where}: " + "\n".join(failures))
    orc_rep, reps = reports[0]["oracle"], reports[1:]
    for r in reps:
        if r["mode"] != "timer" and r["kills"] < 1:
            raise AssertionError(f"phase 22{where}: the {r['mode']} trial was never killed")
    return reps, orc_rep


def chaos_line(reps: list, orc: dict, seconds: float) -> dict:
    """A part's line: trials, incarnations, kills by site, timer landings,
    frames replayed and each incarnation's start-up and recovery seconds,
    hashes matched, leak verdicts and the children's launches."""
    incs = [i for r in reps for i in r["incarnations"]]
    kills: dict = {}
    for r in reps:
        kills[r["mode"]] = kills.get(r["mode"], 0) + r["kills"]
    launches: dict = {}
    for i in incs:
        for k, v in i.get("launches", {}).items():
            launches[k] = launches.get(k, 0) + v
    return dict(
        trials=len(reps), incarnations=len(incs), kills_by_site=kills,
        timer_kills=[r["timer"] for r in reps if r["mode"] == "timer"],
        replayed=[i.get("replayed") for i in incs],
        startup_s=[i["startup_s"] for i in incs if not i.get("promoted")],
        recovery_s=[i.get("recovery_s") for i in incs],
        promotions=[r["promote"] for r in reps if "promote" in r],
        hashes_matched=sum(r["matched"] for r in reps),
        hashes_recorded=sum(r["recorded"] for r in reps),
        final_states_equal=len(reps), leakmon=["PASS"] * len(reps),
        child_launches=launches,
        oracle={k: orc.get(k) for k in ("startup_s", "build_s", "wall_s", "total_s")},
        trial_s=[r["s"] for r in reps], phase_s=seconds)


def record2048_child() -> int:
    """Phase 22c, in a process started with ``GRAPEVINE_RECORD_SIZE=2048``:
    B2-B6 against their plain versions at 2 KB record rows, then the
    E=1 tiled slice and the E=4 fused slice against the dict model. Prints
    one JSON line."""
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine import expiry
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine
    from grapevine_tpu_torch.engine.state import EngineConfig
    from grapevine_tpu_torch.oblivious import cipher_kernels as ck
    from grapevine_tpu_torch.oblivious import gather_kernels as gk
    from grapevine_tpu_torch.oram import path_oram, round as round_mod
    from grapevine_tpu_torch.wire import constants as C

    if C.RECORD_SIZE != 2048:
        raise AssertionError(f"record size {C.RECORD_SIZE}, want 2048")
    card = card_line()
    t0 = time.perf_counter()
    gk.load_library()
    ptxas = ptxas_report(gk.ptxas_log())
    geo = dict(max_messages=2**20, max_recipients=2**12, batch_size=2048,
               vphases_impl="dense")
    ecfg = EngineConfig.from_config(GrapevineConfig(**geo,
                                                    bucket_cipher_impl="pallas_fused_tiled"))
    shapes = kernel_checks(ecfg, gk, ck, path_oram, round_mod, expiry)
    widths = {t: (c.bucket_slots, c.bucket_slots * c.value_words)
              for t, c in (("records", ecfg.rec), ("mailbox", ecfg.mb))}
    # the opt-in shared memory a block may have (227 KB on Hopper)
    smem_cap = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin",
                       227 * 1024)
    rows = []
    for s in shapes:
        smem = s.get("launch", {}).get("smem_bytes")
        if smem is not None and smem > smem_cap:
            raise AssertionError(f"{s['kernel']} at the {s['tree']} {s['shape']} shape "
                                 f"needs {smem} bytes of shared memory, the card {smem_cap}")
        rows.append(dict(kernel=s["kernel"], tree=s["tree"], shape=s["shape"],
                         row_words=s["row_words"], rows=s["rows"],
                         path=s["path"], max_abs_err=s["max_abs_err"],
                         ms=s["ms"], plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
                         bound_by="bytes" if s["bytes_ms"] >= s["ops_ms"] else "operations",
                         smem_bytes=smem))
    check_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    tiled = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused_tiled")
    eng = GrapevineEngine(tiled, seed=SEED)
    _reset_launches(gk, ck)
    rounds, *_ = run_slice(eng, 4, writes=True, profile_last=False)
    tiled_launches = _launches(gk, ck)
    n_tiled = counted_rounds(eng, 4)
    require_launches(tiled_launches, {"gather_decrypt_rows_tiled": 3 * n_tiled,
                                      "scatter_encrypt_rows_tiled": 3 * n_tiled},
                     "22c tiled slice")
    tiled_ms = [r["s"] * 1e3 for r in rounds]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    evict = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused", evict_every=EVICT_EVERY)
    evict_line, _, evict_launches, eng, *_ = run_evict_slice(GrapevineEngine, evict, gk, ck,
                                                             card, windows=2)
    del eng
    served = {k: tiled_launches[k] + evict_launches[k] for k in KERNELS}
    emit({"record2048": dict(
        record_size=C.RECORD_SIZE, payload_size=C.PAYLOAD_SIZE,
        row_words={t: sum(w) for t, w in widths.items()}, ptxas=ptxas, kernels=rows,
        tiled_e1=dict(rounds=len(rounds), round_ms=tiled_ms, launches=tiled_launches),
        fused_e4=dict(rounds=evict_line["rounds_total"], flushes=evict_line["flushes"],
                      median_fetch_round_ms=evict_line["median_fetch_round_ms"],
                      flush_ms=evict_line["flush_ms"], launches=evict_launches),
        responses_checked=True, launches=served, check_s=check_s,
        serve_s=time.perf_counter() - t1, card=card)})
    return 0


def run_chaos_phase(gk, ck, card) -> dict:
    """Phase 22: (c) B2-B6 and two slices at 2 KB records in a child of
    their own, (a) the chaos campaign at the production point, (b) every
    fault site, the sharded campaign and the standby takeover at 2^14.
    The launches are this process's (the standby replica) plus those the
    children's completed incarnations and 22c's slices report."""
    from grapevine_tpu_torch.testing import chaos_run as chaos
    from grapevine_tpu_torch.testing.faults import ALL_POINTS

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    gk.build_library()  # the children load it; none of them builds
    out: dict = {}

    t0 = time.perf_counter()
    env = dict(os.environ, GRAPEVINE_RECORD_SIZE="2048")
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--record2048-child"],
                         env=env, capture_output=True, text=True, timeout=900,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith('{"record2048"')]
    if res.returncode != 0 or not lines:
        raise AssertionError(f"phase 22c: the 2 KB child exited {res.returncode}:\n"
                             f"{res.stderr[-4000:]}")
    out["c"] = json.loads(lines[-1])["record2048"]
    out["c"]["phase_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    reps, orc = chaos_campaign(chaos, CHAOS_PROD, CHAOS_PROD_MODES, where="a")
    out["a"] = chaos_line(reps, orc, time.perf_counter() - t0)
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    _reset_launches(gk, ck)
    # one oracle, then the three campaigns at once: 16 restart chains and
    # the standby trials. The oracle ignores the shard count; asked for
    # the sharded campaign it also hashes the final state with the junk
    # bucket masked, which the sharded children are held to
    orc_b = chaos.run_oracle(chaos.parse_args(["--device", "cuda", *CHAOS_SMALL,
                                               "--shards", "2"]))
    with ThreadPoolExecutor(max_workers=3) as pool:
        runs = [pool.submit(chaos_campaign, chaos, argv, modes, orc_b, where)
                for argv, modes, where in (
                    (CHAOS_SMALL, list(ALL_POINTS) + ["timer"], "b"),
                    (CHAOS_SMALL + ["--shards", "2", "--seed", "24"], CHAOS_SHARDED_MODES,
                     "b sharded"),
                    (CHAOS_SMALL + ["--standby", "--seed", "25"], CHAOS_STANDBY_MODES,
                     "b standby"))]
        (reps, orc), (sharded, _), (standby, _) = [r.result() for r in runs]
    parent = _launches(gk, ck)
    killed = {r["mode"] for r in reps + sharded + standby if r["kills"]}
    missing = set(ALL_POINTS) - killed
    if missing:
        raise AssertionError(f"phase 22b: fault sites never killed on the card: {missing}")
    out["b"] = dict(chaos_line(reps, orc, 0.0), sharded=chaos_line(sharded, orc, 0.0),
                    standby=chaos_line(standby, orc, 0.0), parent_launches=parent,
                    phase_s=time.perf_counter() - t0)
    launches = {k: (out["c"]["launches"].get(k, 0) + parent.get(k, 0)
                    + sum(p["child_launches"].get(k, 0)
                          for p in (out["a"], out["b"], out["b"]["sharded"],
                                    out["b"]["standby"])))
                for k in KERNELS}
    return dict(out, launches=launches, card=card, phase_s=time.perf_counter() - t_phase)


def emit_chaos_lines(ch: dict) -> None:
    card = ch["card"]
    emit({"chaos_record2048": ch["c"], "card": card})
    emit({"chaos_prod": ch["a"], "card": card})
    emit({"chaos_small": {k: v for k, v in ch["b"].items() if k not in ("sharded", "standby")},
          "card": card})
    emit({"chaos_sharded": ch["b"]["sharded"], "card": card})
    emit({"chaos_standby": ch["b"]["standby"], "card": card})
    emit({"chaos_phase_s": ch["phase_s"], "chaos_launches": ch["launches"], "card": card})


def chaos_phase_alone() -> int:
    """Phase 22 alone: the card line, the kernel build, then the chaos
    phase."""
    from grapevine_tpu_torch.oblivious import cipher_kernels as ck
    from grapevine_tpu_torch.oblivious import gather_kernels as gk

    card = card_line()
    emit({"card": card})
    t0 = time.perf_counter()
    gk.build_library()
    gk.load_library()
    emit({"build_s": time.perf_counter() - t0})
    ch = run_chaos_phase(gk, ck, card)
    emit_chaos_lines(ch)
    emit({"chaos_phase_alone_s": time.perf_counter() - t0, "card": card})
    return 0


#: phase 23: the reference's test-only contracts, at the production point
CONTRACT_GEO = dict(max_messages=2**20, max_recipients=2**12, batch_size=2048,
                    vphases_impl="dense")
#: a post-2106 clock (u32 seconds wrap at 2^32)
FUTURE = (1 << 32) + 12_345
#: 23a: the recipients a round of B creates is spread over
U64_RECIPIENTS = 64
#: 23d: mixed CRUD rounds with transcripts
CANARY_ENGINE_ROUNDS = 8
#: 23e: timed rounds a kind, the honest cut and the canary's (the rank
#: statistic saturates at sqrt(3 N^2 / (2N + 1)) ~ 6.65 for N = 30)
TIMING_ROUNDS = 30
TIMING_HONEST_Z = 4.5
TIMING_CANARY_Z = 5.5
#: 23f: soak campaigns, and the stress workload's seconds
SOAK_CAMPAIGNS = 8
STRESS_S = 30.0


class Admissions:
    """The admission branch of each round ``eng`` dispatches (True: the
    fast branch), recorded around the facade's own decision."""

    def __init__(self, eng):
        self.fast: list[bool] = []
        decide = eng._admission

        def recording(creates: int) -> bool:
            ok = decide(creates)
            self.fast.append(bool(ok))
            return ok

        eng._admission = recording

    def summary(self) -> dict:
        return {"rounds": len(self.fast), "fast": sum(self.fast),
                "slow_rounds": [i for i, f in enumerate(self.fast) if not f]}


def _free(dev) -> None:
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def _need(launches: dict, some: tuple, where: str, dev) -> None:
    """On the card, each kernel of ``some`` launched and no other."""
    if torch.device(dev).type == "cuda":
        _require_kernels(launches, some, where)


#: the kernels each impl's rounds launch (E=1; E=4 ``"pallas_fused"`` the same)
IMPL_KERNELS = {"pallas": ("cipher_rows_pallas",),
                "pallas_fused": ("gather_decrypt_rows", "scatter_encrypt_rows"),
                "pallas_fused_tiled": ("gather_decrypt_rows_tiled",
                                       "scatter_encrypt_rows_tiled")}


def contracts_u64(GrapevineConfig, GrapevineEngine, geo: dict, gk, ck, dev) -> dict:
    """23a: the u64 lanes at the production point (``tests/test_u64_lanes.py``),
    on E=1 ``"pallas_fused_tiled"`` then E=4 ``"pallas_fused"``."""
    import numpy as np

    from grapevine_tpu_torch.engine import expiry
    from grapevine_tpu_torch.u32 import from_numpy, to_numpy
    from grapevine_tpu_torch.wire import constants as C

    CREATE, READ, DELETE = C.REQUEST_TYPE_CREATE, C.REQUEST_TYPE_READ, C.REQUEST_TYPE_DELETE
    OK, NF = C.STATUS_CODE_SUCCESS, C.STATUS_CODE_NOT_FOUND
    t_part = time.perf_counter()
    b, nr = geo["batch_size"], U64_RECIPIENTS
    per = b // nr
    sender = _key("u64s", 0)
    rcps = [_key("u64r", r) for r in range(nr)]
    passes = []
    checks = 0
    for impl, e in (("pallas_fused_tiled", 1), ("pallas_fused", EVICT_EVERY)):
        cfg = GrapevineConfig(**geo, bucket_cipher_impl=impl, evict_every=e)
        _free(dev)
        _reset_launches(gk, ck)
        eng = GrapevineEngine(cfg, seed=SEED, device=dev)
        adm = Admissions(eng)
        seq0 = (1 << 32) - b // 2
        eng.state = eng.state._replace(
            seq=from_numpy(np.asarray([seq0, 0], np.uint32), eng.device))
        t0 = time.perf_counter()
        pays = [_payload(23, i) for i in range(b)]
        resp = eng.handle_queries([_req(CREATE, sender, rcps[i % nr], payload=pays[i])
                                   for i in range(b)], FUTURE)
        check_responses(resp, [(OK, None)] * b, f"23a {impl} creates")
        if {r.record.timestamp for r in resp} != {FUTURE}:
            raise AssertionError(f"23a {impl}: a create's timestamp is not {FUTURE}")
        seq = to_numpy(eng.state.seq).tolist()
        if seq != [(seq0 + b) & 0xFFFFFFFF, 1]:
            raise AssertionError(f"23a {impl}: seq {seq} after the wrap")
        # recipient r's messages in creation (slot) order: r, r + nr, ...;
        # the first half of the slots got seq hi 0, the second hi 1
        queue = {r: [(resp[i].record.msg_id, pays[i]) for i in range(r, b, nr)]
                 for r in range(nr)}
        checks += b
        for k in range(per):
            pops = eng.handle_queries([_req(DELETE, rcps[r]) for r in range(nr)],
                                      FUTURE + 1 + k)
            check_responses(pops, [(OK, (queue[r][k][0], sender, rcps[r], queue[r][k][1]))
                                   for r in range(nr)], f"23a {impl} pop round {k}")
            if {p.record.timestamp for p in pops} != {FUTURE}:
                raise AssertionError(f"23a {impl} pop round {k}: a stored timestamp changed")
            checks += nr
        empty = eng.handle_queries([_req(DELETE, rcps[r]) for r in range(nr)], FUTURE + 99)
        check_responses(empty, [(NF, None)] * nr, f"23a {impl} empty pop")
        if eng.message_count() != 0:
            raise AssertionError(f"23a {impl}: {eng.message_count()} messages after the pops")
        checks += nr
        wrap_s = time.perf_counter() - t0
        wrap_launches = _launches(gk, ck)
        _need(wrap_launches, IMPL_KERNELS[impl], f"23a {impl} wrap", dev)
        del eng
        _free(dev)

        # expiry across 2^32 in a fresh engine: one round at 2^32 - 50, one
        # at 2^32 + 20, the sweep at 2^32 + 50 with period 60
        t0 = time.perf_counter()
        eng = GrapevineEngine(cfg, seed=SEED + 1, device=dev)
        adm2 = Admissions(eng)
        half = b // 2
        stamps = ((1 << 32) - 50, (1 << 32) + 20)
        rounds = []
        for j, ts in enumerate(stamps):
            reqs = [_req(CREATE, sender, rcps[i % nr], payload=_payload(24 + j, i))
                    for i in range(half)]
            got = eng.handle_queries(reqs, ts)
            check_responses(got, [(OK, None)] * half, f"23a {impl} stamp {ts}")
            rounds.append([(r.record.msg_id, q.record.recipient, q.record.payload)
                           for r, q in zip(got, reqs)])
        _reset_launches(gk, ck)
        evicted = eng.expire((1 << 32) + 50, period=60)
        sweep_launches = _launches(gk, ck)
        if evicted != half:
            raise AssertionError(f"23a {impl}: the sweep evicted {evicted}, expected {half}")
        b2 = 2 * sum(c.n_buckets_padded // expiry._chunk_rows(c)
                     for c in (eng.ecfg.rec, eng.ecfg.mb))
        if torch.device(dev).type == "cuda":
            require_launches(sweep_launches, {"cipher_rows_pallas": b2}, f"23a {impl} sweep")
        reads = eng.handle_queries([_req(READ, sender, mid=m) for m, _, _ in rounds[0] + rounds[1]],
                                   (1 << 32) + 51)
        check_responses(reads, [(NF, None)] * half
                        + [(OK, (m, sender, r, p)) for m, r, p in rounds[1]],
                        f"23a {impl} read-back")
        if eng.message_count() != half:
            raise AssertionError(f"23a {impl}: {eng.message_count()} messages after the sweep")
        checks += 2 * half + 1
        passes.append(dict(
            impl=impl, evict_every=e, seq_start=[seq0, 0], seq_after=seq,
            creates=b, pop_rounds=per, wrap_s=wrap_s, wrap_launches=wrap_launches,
            wrap_admission=adm.summary(), evicted=evicted, kept=half,
            sweep_launches=sweep_launches, expiry_s=time.perf_counter() - t0,
            expiry_admission=adm2.summary()))
        del eng
    _free(dev)
    return dict(passes=passes, checks=checks, rounds=sum(
        p["wrap_admission"]["rounds"] + p["expiry_admission"]["rounds"] for p in passes),
        launches=_sum_launches([p["wrap_launches"] for p in passes]
                               + [p["sweep_launches"] for p in passes]),
        s=time.perf_counter() - t_part)


def _sum_launches(parts: list) -> dict:
    return {k: sum(p.get(k, 0) for p in parts) for k in KERNELS}


def contracts_same_key(GrapevineConfig, GrapevineEngine, geo: dict, gk, ck, dev) -> dict:
    """23b: the 33 same-key (ordering, fill) cases and the two-recipient
    case of ``tests/test_same_key_ordering.py`` as recipient groups of one
    hazard round, then a drain, each kernel impl at E=1 against the port's
    oracle with forced ids."""
    from grapevine_tpu_torch.testing.reference import ReferenceEngine
    from grapevine_tpu_torch.testing.soak import HAZARD_PERMS, KERNEL_IMPLS, req, run_pair
    from grapevine_tpu_torch.wire import constants as C

    CREATE, READ, DELETE = C.REQUEST_TYPE_CREATE, C.REQUEST_TYPE_READ, C.REQUEST_TYPE_DELETE
    t_part = time.perf_counter()
    s = _key("sks", 0)
    groups = [(_key("skx", len(HAZARD_PERMS) * pre + i), pre, perm)
              for pre in (0, 1, 2) for i, perm in enumerate(HAZARD_PERMS)]
    x, y = _key("sky", 0), _key("sky", 1)
    every = [g[0] for g in groups] + [x, y]
    drains = 2 + max(len(p) for p in HAZARD_PERMS) + 1

    def op(kind, rcp, tag):
        if kind == "create":
            return req(CREATE, s, recipient=rcp, tag=tag)
        return req(READ if kind == "zread" else DELETE, rcp)

    out = []
    for impl in KERNEL_IMPLS:
        _free(dev)
        _reset_launches(gk, ck)
        t0 = time.perf_counter()
        cfg = GrapevineConfig(**geo, bucket_cipher_impl=impl)
        eng = GrapevineEngine(cfg, seed=11, device=dev)
        adm = Admissions(eng)
        oracle = ReferenceEngine(config=cfg, rng=random.Random(42))
        n = {"responses": 0, "rounds": 0}

        def pair(reqs, t):
            got = run_pair(eng, oracle, reqs, t, f"23b {impl} round {n['rounds']}")
            n["responses"] += len(reqs)
            n["rounds"] += 1
            return got

        t = NOW
        pair([req(CREATE, s, recipient=g, tag=100 + i)
              for g, pre, _ in groups for i in range(pre)], t)
        hazard = [op(kind, g, 10 + i) for g, _, perm in groups for i, kind in enumerate(perm)]
        hazard += [req(READ, x), req(DELETE, y), req(CREATE, s, recipient=y, tag=1),
                   req(CREATE, s, recipient=x, tag=2)]
        got = pair(hazard, t + 1)
        created = sum(r.request_type == CREATE and d.status_code == C.STATUS_CODE_SUCCESS
                      for r, d in zip(hazard, got))
        for k in range(drains):
            pair([req(READ, g) for g in every], t + 2 + k)
            pair([req(DELETE, g) for g in every], t + 2 + k)
        if eng.message_count() != 0:
            raise AssertionError(f"23b {impl}: {eng.message_count()} messages after the drain")
        launches = _launches(gk, ck)
        _need(launches, IMPL_KERNELS[impl], f"23b {impl}", dev)
        out.append(dict(impl=impl, groups=len(groups) + 2, hazard_ops=len(hazard),
                        hazard_creates_ok=created, responses_equal=n["responses"],
                        rounds=n["rounds"], admission=adm.summary(), launches=launches,
                        s=time.perf_counter() - t0))
        del eng
    _free(dev)
    return dict(impls=out, checks=sum(o["responses_equal"] for o in out),
                rounds=sum(o["rounds"] for o in out),
                launches=_sum_launches([o["launches"] for o in out]),
                s=time.perf_counter() - t_part)


def contracts_mailbox(GrapevineConfig, GrapevineEngine, geo: dict, gk, ck, dev) -> dict:
    """23c: the two-choice mailbox table (``tests/test_mailbox_load.py``) at
    the production point, E=1 ``"pallas_fused_tiled"``."""
    from grapevine_tpu_torch.wire import constants as C

    CREATE, READ = C.REQUEST_TYPE_CREATE, C.REQUEST_TYPE_READ
    OK, NF, TMR = (C.STATUS_CODE_SUCCESS, C.STATUS_CODE_NOT_FOUND,
                   C.STATUS_CODE_TOO_MANY_RECIPIENTS)
    t_part = time.perf_counter()
    b, cap = geo["batch_size"], geo["max_recipients"]
    sender = _key("mbs", 0)
    out: dict = {}
    _reset_launches(gk, ck)
    rounds = 0
    checks = 0

    def fill(eng, lo: int, hi: int, tag: str, now: int) -> dict:
        """Creates from ``sender`` to recipients ``lo..hi-1``, one each."""
        reqs = [_req(CREATE, sender, _key(tag, i), payload=_payload(7, i))
                for i in range(lo, hi)]
        got = eng.handle_queries(reqs, now)
        return {i: (r.status_code, r.record.msg_id, q.record.payload)
                for i, r, q in zip(range(lo, hi), got, reqs)}

    # (a) the default load 0.5: 75% of max_recipients in 2 rounds
    _free(dev)
    t0 = time.perf_counter()
    cfg = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused_tiled")
    eng = GrapevineEngine(cfg, seed=SEED, device=dev)
    adm = Admissions(eng)
    n = 3 * cap // 4
    st: dict = {}
    for lo, hi in ((0, n // 2), (n // 2, n)):
        st.update(fill(eng, lo, hi, "mbd", NOW))
    codes = [v[0] for v in st.values()]
    if not set(codes) <= {OK, TMR}:
        raise AssertionError(f"23c default load: statuses {sorted(set(codes))}")
    ok = codes.count(OK)
    if not eng.recipient_count() == eng.message_count() == ok:
        raise AssertionError("23c default load: recipients, messages and successes differ")
    checks += len(codes) + 1
    rounds += len(adm.fast)
    out["default_load"] = dict(
        mailbox_load=cfg.resolved_mailbox_load, recipients=n, rounds=len(adm.fast),
        early_too_many_recipients=codes.count(TMR),
        slots_per_recipient=eng.ecfg.mb_table_buckets * eng.ecfg.mb_slots / cap,
        table=[eng.ecfg.mb_table_buckets, eng.ecfg.mb_slots], admission=adm.summary(),
        s=time.perf_counter() - t0)
    del eng
    _free(dev)

    # (b) load 1.0: rounds of B distinct recipients until the early path fires
    t0 = time.perf_counter()
    cfg1 = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused_tiled", mailbox_load=1.0)
    eng = GrapevineEngine(cfg1, seed=SEED, device=dev)
    adm = Admissions(eng)
    st = {}
    while TMR not in (v[0] for v in st.values()) and len(st) < cap:
        st.update(fill(eng, len(st), min(len(st) + b, cap), "mbf", NOW))
    codes = [v[0] for v in st.values()]
    if not set(codes) <= {OK, TMR} or TMR not in codes:
        raise AssertionError(f"23c load 1.0: statuses {sorted(set(codes))}")
    good = [i for i, v in st.items() if v[0] == OK]
    early = [i for i, v in st.items() if v[0] == TMR]
    if not eng.recipient_count() == eng.message_count() == len(good):
        raise AssertionError("23c load 1.0: recipients, messages and successes differ")
    fill_rounds = len(adm.fast)
    # every success drains; every early failure left no trace
    every = sorted(st)
    for lo in range(0, len(every), b):
        part = every[lo:lo + b]
        got = eng.handle_queries([_req(READ, _key("mbf", i)) for i in part], NOW + 1)
        check_responses(got, [(OK, (st[i][1], sender, _key("mbf", i), st[i][2]))
                              if st[i][0] == OK else (NF, None) for i in part],
                        "23c load 1.0 read-back")
    checks += 2 * len(codes) + 1
    rounds += len(adm.fast)
    out["load_1"] = dict(
        mailbox_load=cfg1.resolved_mailbox_load, recipients_tried=len(st),
        fill_rounds=fill_rounds, successes=len(good), early_too_many_recipients=len(early),
        first_early=early[0], read_back=len(every),
        slots_per_recipient=eng.ecfg.mb_table_buckets * eng.ecfg.mb_slots / cap,
        table=[eng.ecfg.mb_table_buckets, eng.ecfg.mb_slots], admission=adm.summary(),
        s=time.perf_counter() - t0)
    del eng
    _free(dev)
    launches = _launches(gk, ck)
    _need(launches, IMPL_KERNELS["pallas_fused_tiled"], "23c", dev)
    return dict(out, checks=checks, rounds=rounds, launches=launches,
                s=time.perf_counter() - t_part)


def contracts_canaries(GrapevineConfig, GrapevineEngine, geo: dict, gk, ck, dev) -> dict:
    """23d: the leak canaries (``tests/test_leak_canary.py``) through the
    records tree's production ``oram_round`` on each kernel impl at B, then
    mixed CRUD engine rounds with their transcripts."""
    import numpy as np

    from grapevine_tpu_torch.engine.state import EngineConfig
    from grapevine_tpu_torch.oram.path_oram import OramState, init_oram, random_below
    from grapevine_tpu_torch.oram.round import oram_round
    from grapevine_tpu_torch.testing import leakcheck as lc
    from grapevine_tpu_torch.testing.soak import KERNEL_IMPLS
    from grapevine_tpu_torch.u32 import to_numpy
    from grapevine_tpu_torch.wire import constants as C

    t_part = time.perf_counter()
    b = geo["batch_size"]
    out: dict = {"impls": []}
    rounds = 0

    def passthrough(vals0, present0):
        return {}, vals0, present0

    def insert(vals0, present0):
        return {}, torch.ones_like(vals0), torch.ones_like(present0)

    for impl in KERNEL_IMPLS:
        _free(dev)
        _reset_launches(gk, ck)
        t0 = time.perf_counter()
        rcfg = EngineConfig.from_config(GrapevineConfig(**geo, bucket_cipher_impl=impl)).rec
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED)

        def uniform():
            return random_below(gen, rcfg.leaves, (b,), dev)

        st0 = init_oram(rcfg, gen, dev)
        st0, _, _ = oram_round(rcfg, st0, torch.arange(b, dtype=torch.int32, device=dev),
                               uniform(), uniform(), insert)
        n = {"rounds": 1}

        def step(state, idxs, nl, dl):
            state, _, leaves = oram_round(rcfg, state, idxs, nl, dl, passthrough)
            n["rounds"] += 1
            return state, to_numpy(leaves)

        def start():
            return OramState(*(t.clone() for t in st0))

        # no-dedup: B ops on one key; honest dummies are uniform, leaky ones
        # fetch the key's real leaf
        idxs = torch.zeros(b, dtype=torch.int32, device=dev)
        nl, dl = uniform(), uniform()
        keys = np.zeros(b, np.int64)
        honest = lc.samekey_leaf_collisions(keys, step(start(), idxs, nl, dl)[1])
        leaky = lc.samekey_leaf_collisions(
            keys, step(start(), idxs, nl, st0.posmap[:1].expand(b).contiguous())[1])
        pairs = b * (b - 1) // 2
        lam = pairs / rcfg.leaves
        if abs(honest - lam) > 6 * math.sqrt(lam) or leaky != pairs:
            raise AssertionError(f"23d {impl} no-dedup: honest {honest} (expected {lam:.2f}), "
                                 f"leaky {leaky} of {pairs}")

        # no-remap: key 3 in slot 0, padding elsewhere, 12 rounds
        idxs = torch.full((b,), rcfg.dummy_index, dtype=torch.int32, device=dev)
        idxs[0] = 3

        def remap_run(leaky_run: bool):
            state, seq = start(), []
            for _ in range(12):
                nl = state.posmap[idxs.long()].clone() if leaky_run else uniform()
                state, leaves = step(state, idxs, nl, uniform())
                seq.append(int(leaves[0]))
            return lc.cross_round_repeat_rate(np.asarray(seq))

        rep_honest, rep_leaky = remap_run(False), remap_run(True)
        if not (rep_honest < 0.2 and rep_leaky == 1.0):
            raise AssertionError(f"23d {impl} no-remap: honest {rep_honest}, leaky {rep_leaky}")

        # biased dummy: 24 all-padding rounds
        idxs = torch.full((b,), rcfg.dummy_index, dtype=torch.int32, device=dev)

        def biased_run(leaky_run: bool):
            state, pool = start(), []
            for _ in range(24):
                dl = torch.zeros(b, dtype=torch.int32, device=dev) if leaky_run else uniform()
                state, leaves = step(state, idxs, uniform(), dl)
                pool.append(leaves)
            return lc.uniformity_z(np.concatenate(pool), rcfg.leaves)

        z_honest, z_leaky = biased_run(False), biased_run(True)
        if not (abs(z_honest) < 6 and z_leaky > 50):
            raise AssertionError(f"23d {impl} biased dummy: z honest {z_honest}, "
                                 f"leaky {z_leaky}")
        del st0
        launches = _launches(gk, ck)
        _need(launches, IMPL_KERNELS[impl], f"23d {impl}", dev)
        rounds += n["rounds"]
        out["impls"].append(dict(
            impl=impl, tree=dict(height=rcfg.height, leaves=rcfg.leaves,
                                 cipher_rounds=rcfg.cipher_rounds,
                                 top_cache_levels=rcfg.top_cache_levels),
            no_dedup=dict(honest=honest, expected=lam, leaky=leaky, pairs=pairs),
            no_remap=dict(honest=rep_honest, leaky=rep_leaky),
            biased_dummy=dict(z_honest=z_honest, z_leaky=z_leaky),
            oram_rounds=n["rounds"], launches=launches, s=time.perf_counter() - t0))

    # mixed CRUD engine rounds with transcripts
    _free(dev)
    _reset_launches(gk, ck)
    t0 = time.perf_counter()
    cfg = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused_tiled")
    eng = GrapevineEngine(cfg, seed=SEED, device=dev)
    adm = Admissions(eng)
    rng = random.Random(9)
    CREATE, READ, UPDATE, DELETE = (C.REQUEST_TYPE_CREATE, C.REQUEST_TYPE_READ,
                                    C.REQUEST_TYPE_UPDATE, C.REQUEST_TYPE_DELETE)
    nrc = max(8, b // 8)
    sender = _key("cns", 0)
    rcp = [_key("cnr", i) for i in range(nrc)]
    setup = [_req(CREATE, sender, rcp[i % nrc], payload=_payload(9, i)) for i in range(b)]
    got = eng.handle_queries(setup, NOW)
    check_responses(got, [(C.STATUS_CODE_SUCCESS, None)] * b, "23d setup")
    live = [(r.record.msg_id, q.record.recipient) for r, q in zip(got, setup)]
    d = eng.ecfg.mb_choices
    mb_cols = list(range(d)) + list(range(d + 1, 2 * d + 1))
    mb_pool, rec_pool = [], []
    by_kind: dict = {READ: [], UPDATE: [], DELETE: []}
    q = b // 4
    for t in range(CANARY_ENGINE_ROUNDS):
        rng.shuffle(live)
        targets, live = live[:3 * q], live[3 * q:]
        kinds = [READ] * q + [UPDATE] * q + [DELETE] * q
        reqs = [_req(k, sender, r, mid=m, payload=_payload(10, t))
                for k, (m, r) in zip(kinds, targets)]
        reqs += [_req(CREATE, sender, rcp[rng.randrange(nrc)], payload=_payload(11, i))
                 for i in range(b - 3 * q)]
        order = list(range(b))
        rng.shuffle(order)
        reqs = [reqs[i] for i in order]
        resps, tr = eng.handle_queries_with_transcript(reqs, NOW + 1 + t)
        tr = np.asarray(tr)
        for j, (rq, rs) in enumerate(zip(reqs, resps)):
            if rs.status_code != C.STATUS_CODE_SUCCESS:
                raise AssertionError(f"23d mixed round {t} slot {j}: status {rs.status_code}")
            if rq.request_type == CREATE:
                live.append((rs.record.msg_id, rq.record.recipient))
            elif rq.request_type != DELETE:
                live.append((rq.record.msg_id, rq.record.recipient))
            if rq.request_type in by_kind:
                by_kind[rq.request_type].append(int(tr[j, d]))
        mb_pool.append(tr[:, mb_cols].ravel())
        rec_pool.append(tr[:, d])
    ecfg = eng.ecfg
    z_mb = lc.uniformity_z(np.concatenate(mb_pool), ecfg.mb.leaves, bins=8)
    z_rec = lc.uniformity_z(np.concatenate(rec_pool), ecfg.rec.leaves, bins=8)
    pools = {k: np.asarray(v) for k, v in by_kind.items()}
    n_leaves = ecfg.rec.leaves
    z_rud = {f"{a}_{c}": lc.twosample_z(pools[x], pools[y], n_leaves, bins=8)
             for (a, x), (c, y) in itertools.combinations(
                 (("read", READ), ("update", UPDATE), ("delete", DELETE)), 2)}
    z_bias = lc.twosample_z(pools[READ], pools[DELETE] % (n_leaves // 8), n_leaves, bins=8)
    if not (abs(z_mb) < 6 and abs(z_rec) < 6 and all(abs(z) < 6 for z in z_rud.values())
            and z_bias > 20):
        raise AssertionError(f"23d mixed rounds: z mailbox {z_mb}, records {z_rec}, "
                             f"R/U/D {z_rud}, op-type bias {z_bias}")
    launches = _launches(gk, ck)
    _need(launches, IMPL_KERNELS["pallas_fused_tiled"], "23d mixed rounds", dev)
    del eng
    _free(dev)
    out["engine"] = dict(rounds=1 + CANARY_ENGINE_ROUNDS, uniformity_z_mailbox=z_mb,
                         uniformity_z_records=z_rec, rud_twosample_z=z_rud,
                         op_type_bias_z=z_bias,
                         samples=dict(zip(("read", "update", "delete"),
                                          (len(v) for v in by_kind.values()))),
                         admission=adm.summary(), launches=launches,
                         s=time.perf_counter() - t0)
    rounds += 1 + CANARY_ENGINE_ROUNDS
    # six detector checks an impl, six over the mixed rounds, and every
    # response of the setup and mixed rounds
    return dict(out, checks=6 * len(KERNEL_IMPLS) + 6 + (1 + CANARY_ENGINE_ROUNDS) * b,
                rounds=rounds,
                launches=_sum_launches([o["launches"] for o in out["impls"]]
                                       + [launches]),
                s=time.perf_counter() - t_part)


def contracts_timing(GrapevineConfig, GrapevineEngine, geo: dict, gk, ck, dev) -> dict:
    """23e: READ, UPDATE and DELETE round walls (``tests/test_timing_uniformity.py``)
    on E=1 ``"pallas_fused_tiled"`` at the default pipeline depth."""
    import numpy as np

    from grapevine_tpu_torch.testing.leakcheck import timing_twosample_z
    from grapevine_tpu_torch.wire import constants as C

    CREATE, READ, UPDATE, DELETE = (C.REQUEST_TYPE_CREATE, C.REQUEST_TYPE_READ,
                                    C.REQUEST_TYPE_UPDATE, C.REQUEST_TYPE_DELETE)
    OK, NF = C.STATUS_CODE_SUCCESS, C.STATUS_CODE_NOT_FOUND
    t_part = time.perf_counter()
    b = geo["batch_size"]
    cuda = torch.device(dev).type == "cuda"
    _free(dev)
    cfg = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused_tiled")
    eng = GrapevineEngine(cfg, seed=3, device=dev)
    adm = Admissions(eng)
    sender = _key("tms", 0)
    nrc = max(4, b // 16)
    rcp = [_key("tmr", i) for i in range(nrc)]
    ids, rcps = [], []
    for j in range(2):  # 2B records
        reqs = [_req(CREATE, sender, rcp[i % nrc], payload=_payload(12, j * b + i))
                for i in range(b)]
        got = eng.handle_queries(reqs, NOW)
        check_responses(got, [(OK, None)] * b, f"23e populate {j}")
        ids += [r.record.msg_id for r in got]
        rcps += [q.record.recipient for q in reqs]
    rng = random.Random(23)
    absent = set()
    while len(absent) < b:
        m = rng.randbytes(16)
        if m not in ids and m != bytes(16):
            absent.add(m)
    reqs = {
        "read": [_req(READ, sender, mid=ids[i]) for i in range(b)],
        "update": [_req(UPDATE, sender, rcps[b + i], mid=ids[b + i], payload=_payload(13, i))
                   for i in range(b)],
        "delete": [_req(DELETE, sender, rcps[0], mid=m) for m in sorted(absent)],
    }
    want = {"read": OK, "update": OK, "delete": NF}
    kinds = ("read", "update", "delete")
    n_before = eng.message_count()

    checked = [0]

    def run(kind: str):
        got = eng.handle_queries(reqs[kind], NOW)
        if {r.status_code for r in got} != {want[kind]}:
            raise AssertionError(f"23e {kind}: statuses {sorted({r.status_code for r in got})}")
        checked[0] += len(got)
        return got

    for k in kinds:  # warm-up: one round of each kind
        run(k)

    def measure(slow_delete_s: float = 0.0) -> dict:
        gc.collect()
        times: dict = {k: [] for k in kinds}
        gen2: dict = {k: [] for k in kinds}
        for _ in range(TIMING_ROUNDS):
            for k in kinds:
                g0 = gc.get_stats()[2]["collections"]
                t0 = time.perf_counter()
                run(k)
                if k == "delete" and slow_delete_s:
                    time.sleep(slow_delete_s)  # the canary: an op-keyed slowdown
                times[k].append(time.perf_counter() - t0)
                gen2[k].append(gc.get_stats()[2]["collections"] - g0)
        return {k: np.asarray(v) for k, v in times.items()}, gen2

    first = len(adm.fast)
    times, gen2 = measure()
    z = {"read_update": timing_twosample_z(times["read"], times["update"]),
         "read_delete": timing_twosample_z(times["read"], times["delete"]),
         "update_delete": timing_twosample_z(times["update"], times["delete"])}
    per_round = float(np.median(np.concatenate(list(times.values()))))
    c_times, _ = measure(slow_delete_s=per_round)
    z_canary = timing_twosample_z(c_times["read"], c_times["delete"])
    timed_fast = adm.fast[first:]
    if not all(timed_fast):
        raise AssertionError("23e: a timed round took the slow admission walk")
    if eng.message_count() != n_before:
        raise AssertionError("23e: the stored records changed")

    # one profiled round of each kind: its launches and its kernels
    prof = {}
    for k in kinds:
        _reset_launches(gk, ck)
        if cuda:
            p = profile_round(lambda: run(k))
            prof[k] = dict(launches=_launches(gk, ck), traced_launches=p["traced_launches"],
                           device_kernels=p["device_kernels"],
                           device_ms=p["device_ms"], wall_ms=p["wall_ms"])
        else:
            run(k)
            prof[k] = dict(launches=_launches(gk, ck))
    if cuda:
        # the profiled rounds replay the round graph: the trace counts
        # their kernels, the wrappers none
        _require_kernels(prof["read"]["traced_launches"], IMPL_KERNELS["pallas_fused_tiled"],
                         "23e")
    for k in ("update", "delete"):
        for field in ("launches", "traced_launches", "device_kernels"):
            if prof[k].get(field) != prof["read"].get(field):
                raise AssertionError(f"23e: the profiled {k} round's {field} "
                                     f"{prof[k].get(field)} differ from read's "
                                     f"{prof['read'].get(field)}")
    fails = [f"{p} |z| {v:.2f}" for p, v in z.items() if abs(v) >= TIMING_HONEST_Z]
    if fails or abs(z_canary) <= TIMING_CANARY_Z:
        raise AssertionError(f"23e: honest {z}, canary {z_canary}")

    def stats(a):
        ms = np.sort(a) * 1e3
        return dict(median_ms=float(np.median(ms)), p90_ms=float(np.quantile(ms, 0.9)),
                    max_ms=float(ms[-1]), min_ms=float(ms[0]))

    line = dict(
        pipeline_depth=eng.pipeline_depth, rounds_a_kind=TIMING_ROUNDS, records=n_before,
        honest_z=z, canary_z=z_canary, canary_sleep_ms=per_round * 1e3,
        by_kind={k: dict(stats(times[k]), gc_gen2_rounds=sum(1 for g in gen2[k] if g))
                 for k in kinds},
        canary_by_kind={k: stats(c_times[k]) for k in kinds},
        profiled=prof, admission=dict(adm.summary(), timed_all_fast=True),
        launches=_sum_launches([p["launches"] for p in prof.values()]))
    rounds = len(adm.fast)
    del eng
    _free(dev)
    # the four z cuts, launches and kernels of two kinds against read's,
    # the stored count, and every response's status
    return dict(line, checks=4 + 2 * 2 + 1 + checked[0], rounds=rounds,
                s=time.perf_counter() - t_part)


def contracts_soaks(GrapevineConfig, gk, ck, dev, stress_s: float = STRESS_S) -> dict:
    """23f: randomized soak campaigns against the port's oracle on the card,
    then the stress workload through a ``GrapevineServer`` on the card."""
    from grapevine_tpu_torch.server.service import GrapevineServer
    from grapevine_tpu_torch.testing import soak

    t_part = time.perf_counter()
    _free(dev)
    _reset_launches(gk, ck)
    camps = []
    for i in range(SOAK_CAMPAIGNS):
        cfg = soak.variant_config(i)
        t0 = time.perf_counter()
        got = soak.campaign(cfg, seed=1000 + i, device=dev)
        camps.append(dict(got, impl=cfg.bucket_cipher_impl, cipher=cfg.bucket_cipher_rounds,
                          batch_size=cfg.batch_size, density=cfg.tree_density,
                          s=time.perf_counter() - t0))
    soak_launches = _launches(gk, ck)
    _free(dev)

    _reset_launches(gk, ck)
    t0 = time.perf_counter()
    cfg = GrapevineConfig(bucket_cipher_rounds=8, bucket_cipher_impl="pallas_fused_tiled",
                          max_messages=1 << 10, max_recipients=64, batch_size=8,
                          stash_size=128)
    srv = GrapevineServer(config=cfg, seed=1, device=dev)
    try:
        port = srv.start("insecure-grapevine://127.0.0.1:0")
        tallies = soak.stress(f"insecure-grapevine://127.0.0.1:{port}", stress_s)
        h = srv.health()
    finally:
        srv.stop()
    if not (h["stash_overflow"] == 0 and h["auth_failures"] >= tallies["bad_sig"] > 0
            and 0 <= h["messages"] <= cfg.max_messages and h["real_ops"] > 0):
        raise AssertionError(f"23f stress: health {h}, tallies {tallies}")
    stress_launches = _launches(gk, ck)
    _need(stress_launches, IMPL_KERNELS["pallas_fused_tiled"], "23f stress", dev)
    stress = dict(seconds=stress_s, threads=soak.STRESS_THREADS, client_tallies=tallies,
                  real_ops=h["real_ops"], rounds=h["rounds"],
                  batch_occupancy=h["batch_occupancy"], auth_failures=h["auth_failures"],
                  messages=h["messages"], launches=stress_launches,
                  s=time.perf_counter() - t0)
    _free(dev)
    return dict(campaigns=camps,
                soak_ops=sum(c["ops"] for c in camps), soak_rounds=sum(c["rounds"] for c in camps),
                soak_launches=soak_launches, stress=stress,
                checks=sum(c["ops"] for c in camps) + tallies["ops"] + tallies["bad_sig"],
                rounds=sum(c["rounds"] for c in camps) + h["rounds"],
                launches=_sum_launches([soak_launches, stress_launches]),
                s=time.perf_counter() - t_part)


def run_contracts_phase(GrapevineConfig, GrapevineEngine, gk, ck, card) -> dict:
    """Phase 23: the reference's test-only contracts (A20) at
    ``CONTRACT_GEO`` on the card."""
    t_phase = time.perf_counter()
    dev, geo = "cuda", CONTRACT_GEO
    parts = {
        "a": contracts_u64(GrapevineConfig, GrapevineEngine, geo, gk, ck, dev),
        "b": contracts_same_key(GrapevineConfig, GrapevineEngine, geo, gk, ck, dev),
        "c": contracts_mailbox(GrapevineConfig, GrapevineEngine, geo, gk, ck, dev),
        "d": contracts_canaries(GrapevineConfig, GrapevineEngine, geo, gk, ck, dev),
        "e": contracts_timing(GrapevineConfig, GrapevineEngine, geo, gk, ck, dev),
        "f": contracts_soaks(GrapevineConfig, gk, ck, dev),
    }
    launches = _sum_launches([p["launches"] for p in parts.values()])
    missing = [k for k in KERNELS if not launches[k]]
    if missing:
        raise AssertionError(f"phase 23: kernels never launched: {missing}")
    return dict(parts, launches=launches, card=card, phase_s=time.perf_counter() - t_phase)


CONTRACT_LINES = {"a": "contracts_u64", "b": "contracts_same_key", "c": "contracts_mailbox",
                  "d": "contracts_canaries", "e": "contracts_timing", "f": "contracts_soaks"}


def emit_contracts_lines(ct: dict) -> None:
    for part, name in CONTRACT_LINES.items():
        emit({name: ct[part], "card": ct["card"]})
    emit({"contracts_phase_s": ct["phase_s"], "contracts_launches": ct["launches"],
          "card": ct["card"]})


def contracts_phase_alone() -> int:
    """Phase 23 alone: the card line, the kernel build, then the contracts
    phase."""
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
    ct = run_contracts_phase(GrapevineConfig, GrapevineEngine, gk, ck, card)
    emit_contracts_lines(ct)
    emit({"contracts_phase_alone_s": time.perf_counter() - t0, "card": card})
    return 0


#: phase 24: the cell configuration whose engine the graphed engine and its
#: eager twin are built from, and the rounds each runs
GRAPH_CELL_CONFIG = "gvbench/configs/bus_1kb.json"
GRAPH_ROUNDS = 8


def _state_tensors(state, prefix: str = ""):
    """``(name, tensor)`` over an engine state's tensors, the nested named
    tuples flattened; the generators left out."""
    for name, value in zip(state._fields, state):
        if hasattr(value, "_fields"):
            yield from _state_tensors(value, f"{prefix}{name}.")
        elif isinstance(value, torch.Tensor):
            yield prefix + name, value


def _equal_to_host(dev: torch.Tensor, host: torch.Tensor, chunk: int = 1 << 28) -> bool:
    """A device tensor bit-equal to a host copy, compared ``chunk``
    elements at a time (a tree has room on the host once, not twice)."""
    if dev.shape != host.shape or dev.dtype != host.dtype:
        return False
    a, h = dev.reshape(-1), host.reshape(-1)
    return all(torch.equal(a[i:i + chunk].cpu(), h[i:i + chunk])
               for i in range(0, a.numel(), chunk))


def run_graph_phase(GrapevineConfig, GrapevineEngine, gk, ck, card) -> dict:
    """Phase 24: the round graph at a benchmark cell's geometry
    (``GRAPH_CELL_CONFIG``'s engine: 2^23 records, 2^17 recipients,
    B=2048, ``"pallas_fused_tiled"``, depth 2). A graphed engine runs
    GRAPH_ROUNDS rounds of mixed CRUD through
    ``handle_queries_with_transcript`` (the first eager, the second
    captures, the rest replay); its final state goes to the host and the
    engine is freed (two such engines do not fit on the card); then an
    engine of the same seed that runs every round op by op runs the same
    requests. Every round's responses and transcript, every state leaf
    (junk included) and the generator's state are bit-identical; each
    replay's transcript differs from the round's before (fresh draws); the
    wrappers launch 3 B4 and 3 B6 a round run op by op or captured, and
    the profiled last replay runs them as well, counted by name in the
    trace."""
    import numpy as np

    t_phase = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, GRAPH_CELL_CONFIG)) as fh:
        cfg = GrapevineConfig(**json.load(fh)["engine"])
    b = cfg.batch_size
    rng = np.random.default_rng(SEED)
    users = [_key("gph", i) for i in range(512)]
    created: list = []
    rounds: list = []  # each round's requests, made as the graphed run goes
    runs: dict = {}
    saved: dict = {}
    for kind in ("graphed", "eager"):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = GrapevineEngine(cfg, seed=SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        if kind == "eager":
            eng._eager_reason = lambda fast_ok: "warmup" if fast_ok else "slow_branch"
        _reset_launches(gk, ck)
        got, ms = [], []
        for rnd in range(GRAPH_ROUNDS):
            if kind == "graphed":
                rounds.append(mixed_requests(rng, users, created, rnd, n=b))
            reqs = rounds[rnd]

            def one():
                return eng.handle_queries_with_transcript(reqs, NOW + rnd)

            t0 = time.perf_counter()
            if rnd == GRAPH_ROUNDS - 1:
                prof = profile_round(one)
                resp, tr = prof.pop("result")
            else:
                resp, tr = one()
            ms.append((time.perf_counter() - t0) * 1e3)
            if kind == "graphed":
                note_created(reqs, resp, created)
            got.append(([r.pack() for r in resp], np.asarray(tr)))
        launches = _launches(gk, ck)
        counts = eng.health()["round_graph"]
        n = counted_rounds(eng, GRAPH_ROUNDS)
        require_launches(launches, {"gather_decrypt_rows_tiled": 3 * n,
                                    "scatter_encrypt_rows_tiled": 3 * n}, f"phase 24 {kind}")
        traced = prof["traced_launches"]
        require_launches(traced, {"gather_decrypt_rows_tiled": 3,
                                  "scatter_encrypt_rows_tiled": 3},
                         f"phase 24 {kind} profiled round, by name in the trace")
        want = (GRAPH_ROUNDS - 1, 1) if kind == "graphed" else (0, GRAPH_ROUNDS)
        if (counts["replayed"], counts["eager"]["warmup"]) != want:
            raise AssertionError(f"phase 24 {kind}: round graph counts {counts}")
        runs[kind] = dict(init_s=init_s, round_ms=ms, counts=counts, launches=launches,
                          profiled_round=dict(wall_ms=prof["wall_ms"],
                                              device_ms=prof["device_ms"],
                                              device_kernels=prof["device_kernels"],
                                              traced_launches=traced),
                          peak_bytes=torch.cuda.max_memory_allocated())
        if kind == "graphed":
            for rnd in range(2, GRAPH_ROUNDS):
                if np.array_equal(got[rnd][1], got[rnd - 1][1]):
                    raise AssertionError(f"phase 24: replay {rnd} drew round {rnd - 1}'s "
                                         f"transcript again")
            t0 = time.perf_counter()
            saved = {name: t.cpu() for name, t in _state_tensors(eng.state)}
            saved_rng = eng.state.rng.get_state()
            runs[kind]["to_host_s"] = time.perf_counter() - t0
            graphed_got = got
            del eng
            continue
        for rnd, ((ra, ta), (rb, tb)) in enumerate(zip(graphed_got, got)):
            if ra != rb:
                raise AssertionError(f"phase 24 round {rnd}: the responses differ")
            if not np.array_equal(ta, tb):
                raise AssertionError(f"phase 24 round {rnd}: the transcripts differ")
        t0 = time.perf_counter()
        leaves = dict(_state_tensors(eng.state))
        if set(leaves) != set(saved):
            raise AssertionError(f"phase 24: state leaves {sorted(set(leaves) ^ set(saved))}")
        for name, t in leaves.items():
            if not _equal_to_host(t, saved[name]):
                raise AssertionError(f"phase 24: the state differs at {name}")
        if not torch.equal(eng.state.rng.get_state(), saved_rng):
            raise AssertionError("phase 24: the generator's state differs")
        compared = sum(t.numel() for t in saved.values())
        runs[kind]["compare_s"] = time.perf_counter() - t0
        del eng, leaves
    saved.clear()
    gc.collect()
    torch.cuda.empty_cache()
    return dict(config=GRAPH_CELL_CONFIG, batch_size=b, rounds=GRAPH_ROUNDS, **runs,
                responses_equal=True, transcripts_equal=True, state_words_equal=compared,
                generator_equal=True, fresh_draws=True, card=card,
                phase_s=time.perf_counter() - t_phase)


def graph_phase_alone() -> int:
    """Phase 24 alone: the card line, the kernel build, then the round
    graph phase."""
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
    emit({"round_graph_cell": run_graph_phase(GrapevineConfig, GrapevineEngine, gk, ck, card)})
    emit({"graph_phase_alone_s": time.perf_counter() - t0, "card": card})
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
    ap.add_argument("--analysis-phase", action="store_true",
                    help="run phase 19 alone (after the kernel build)")
    ap.add_argument("--range-phase", action="store_true",
                    help="run phase 20 alone (after the kernel build)")
    ap.add_argument("--census-phase", action="store_true",
                    help="run phase 21 alone (after the kernel build)")
    ap.add_argument("--chaos-phase", action="store_true",
                    help="run phase 22 alone (after the kernel build)")
    ap.add_argument("--contracts-phase", action="store_true",
                    help="run phase 23 alone (after the kernel build)")
    ap.add_argument("--graph-phase", action="store_true",
                    help="run phase 24 alone (after the kernel build)")
    ap.add_argument("--record2048-child", action="store_true",
                    help=argparse.SUPPRESS)
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
    if args.analysis_phase:
        return analysis_phase_alone()
    if args.range_phase:
        return range_phase_alone()
    if args.census_phase:
        return census_phase_alone()
    if args.chaos_phase:
        return chaos_phase_alone()
    if args.contracts_phase:
        return contracts_phase_alone()
    if args.graph_phase:
        return graph_phase_alone()
    if args.record2048_child:
        return record2048_child()
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
    n4 = counted_rounds(eng, 7)
    require_launches(launches, {"gather_decrypt_rows_tiled": 3 * n4,
                                "scatter_encrypt_rows_tiled": 3 * n4}, "per-round slice")
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
    require_launches(pallas_launches, {"cipher_rows_pallas": 6 * counted_rounds(eng, 5)},
                     "'pallas' path")
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

    # phase 19: the obliviousness analyzer — audited captures on the card
    # (kernel nodes = launches), census and replay of real captures (B4,
    # B6 through their custom ops), the on-device slow admission walk
    # (B4, B6), the smoke gate without JAX
    an = run_analysis_phase(GrapevineConfig, gk, ck, card)
    split("analysis")

    # phase 20: the range analyzer and the traced cost model — interval
    # audits on the card, geometry 30 faked, the witness of real rounds (B4,
    # B6 / B2 through their custom ops), the ledger against the traced rows
    rp = run_range_phase(GrapevineConfig, gk, ck, card, shapes)
    split("range")

    # phase 21: the census gates at the production point — real captures
    # of both trees' rounds per index set (B4, B6 through their ops), E=4
    # fetch rounds and flushes (B3, B5), the sharded flush on a virtual
    # mesh with its mutant (B2; the twin B3, B5), the position map, the
    # radix audit, the telemetry gate and a live registry (B4, B6)
    cz = run_census_phase(GrapevineConfig, GrapevineEngine, gk, ck, card)
    split("census")

    # phase 22: the chaos harness — B2-B6 and two slices at 2 KB records
    # (B2-B6), kill, recover and compare at the production point (B3, B5,
    # B2 in the children) and at 2^14 (B3, B5, B2; the standby replica in
    # this process)
    ch = run_chaos_phase(gk, ck, card)
    split("chaos")

    # phase 23: the reference's test-only contracts — u64 lanes (B4, B6;
    # B3, B5; B2 in the sweeps), same-key hazards on each impl (B2; B3, B5;
    # B4, B6), the mailbox table (B4, B6), the leak canaries on each impl
    # and mixed rounds (B2-B6), R/U/D timing (B4, B6), the soaks (B2-B6)
    ct = run_contracts_phase(GrapevineConfig, GrapevineEngine, gk, ck, card)
    split("contracts")

    # phase 24: the round graph at a benchmark cell's geometry against an
    # eager twin (B4, B6)
    rg = run_graph_phase(GrapevineConfig, GrapevineEngine, gk, ck, card)
    split("round_graph")

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
        launches_by_kernel[k] += (mesh["launches"].get(k, 0) + an["launches"][k]
                                  + rp["launches"][k] + cz["launches"][k]
                                  + ch["launches"][k] + ct["launches"][k]
                                  + rg["graphed"]["launches"].get(k, 0)
                                  + rg["eager"]["launches"].get(k, 0))
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
    emit_analysis_lines(an)
    emit_range_lines(rp)
    emit_census_lines(cz)
    emit_chaos_lines(ch)
    emit_contracts_lines(ct)
    emit({"round_graph_cell": rg})
    emit({"wall_s": time.perf_counter() - t_start, "phase_s": phase_s, "card": card})
    # the launches are the wrappers' calls; the rounds replayed from a
    # round graph launched their kernels from the graph
    emit({"kernels": kernel_entries(shapes, launches_by_kernel, sweep_chunks,
                                    op["launches"]["cipher_rows_pallas"]),
          "graph_replayed_rounds": GRAPH_REPLAYS["rounds"], "card": card})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
