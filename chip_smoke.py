"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. the card's name and power limit, from ``nvidia-smi``;
2. build the Hopper kernels from ``grapevine_tpu_torch/csrc`` (nvcc);
3. every kernel of the main path against its plain PyTorch version on
   the card, at the records-tree and mailbox-tree row shapes of the
   production point (tolerance 0: integer outputs, the scatter's junk
   bucket masked), with its time, the plain version's time and the
   card's bound for the same work;
4. the slice: ``GrapevineEngine`` at 2^20 messages, 2^12 recipients,
   B=2048, ``bucket_cipher_impl="pallas_fused_tiled"`` serves a few
   rounds of CRUD through ``handle_queries``; every response is checked
   against a plain dict model; the kernels' launch counters are zeroed
   just before and read just after, and each must be > 0; the last
   round runs under ``torch.profiler`` (where the round's time goes);
5. a cross-check at 2^14 messages, B=64: the kernel engine and the
   ``"jnp"`` (plain PyTorch) engine, same seed and requests, must give
   equal responses, transcripts and state (junk bucket masked).

Each earlier line of output is one JSON object; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
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
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
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


def kernel_checks(ecfg, gk, path_oram, round_mod):
    """Phase 3: each kernel against its plain version at both tree shapes
    of one engine round (the records round B and the mailbox rounds A/C)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    b = ecfg.batch_size
    rounds = ecfg.rec.cipher_rounds
    shapes = []
    for tree, cfg, nops, calls in (("records", ecfg.rec, b, 1),
                                    ("mailbox", ecfg.mb, b * ecfg.mb_choices, 2)):
        z, zv = cfg.bucket_slots, cfg.bucket_slots * cfg.value_words
        n, kc = cfg.n_buckets_padded, cfg.top_cache_levels

        def rnd(*shape):
            return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                                 device=dev, dtype=torch.int32)

        key = rnd(8)
        tree_idx, tree_val = rnd(n * z), rnd(n, zv)
        # about one bucket in eight never written (nonce (0, 0)): the
        # gather's epoch-0 identity branch is held against the plain
        # version at these shapes too
        nonces = rnd(n, 2)
        nonces[torch.randint(0, 8, (n,), generator=gen, device=dev) == 0] = 0
        leaves = torch.randint(0, cfg.leaves, (nops,), generator=gen,
                               device=dev).to(torch.int32)
        path_b = path_oram.path_bucket_indices(cfg, leaves)  # the round's paths
        bmap = round_mod._bucket_owner_map(cfg, path_b.reshape(-1))
        cols = torch.arange(nops, device=dev, dtype=torch.int32)[:, None]
        owner = (bmap[path_b.long()] == cols)[:, kc:].reshape(-1).contiguous()
        flat_b = path_b[:, kc:].reshape(-1).contiguous()
        r = flat_b.shape[0]
        new_pidx, new_pval = rnd(r, z), rnd(r, zv)
        epoch = torch.tensor([5, 1], dtype=torch.int32, device=dev)
        g_args = (key, tree_idx, tree_val, nonces, flat_b)
        uniq_b = torch.unique(flat_b)
        uniq = int(uniq_b.numel())
        uniq_written = int((nonces[uniq_b.long()] != 0).any(dim=1).sum())
        unwritten = int((nonces[flat_b.long()] == 0).all(dim=1).sum())
        if unwritten == 0:
            raise AssertionError(f"no never-written bucket on the {tree} paths")

        # gather: kernel vs plain, then times
        ki, kv = gk.gather_decrypt_rows_tiled(*g_args, z=z, rounds=rounds)
        pi, pv = gk.gather_decrypt_rows_plain(*g_args, z=z, rounds=rounds)
        torch.cuda.synchronize()
        g_err = max(int((ki.long() - pi.long()).abs().max()),
                    int((kv.long() - pv.long()).abs().max()))
        del ki, kv, pi, pv
        g_ms = cuda_ms(lambda: gk.gather_decrypt_rows_tiled(*g_args, z=z, rounds=rounds), 20)
        g_plain = cuda_ms(lambda: gk.gather_decrypt_rows_plain(*g_args, z=z, rounds=rounds), 3)

        # scatter: kernel and plain on twin copies of the trees
        s_k = [tree_idx.clone(), tree_val.clone(), nonces.clone()]
        gk.scatter_encrypt_rows_tiled(key, *s_k, flat_b, owner, epoch, new_pidx,
                                      new_pval, z=z, rounds=rounds)
        gk.scatter_encrypt_rows_plain(key, tree_idx, tree_val, nonces, flat_b,
                                      owner, epoch, new_pidx, new_pval, z=z,
                                      rounds=rounds)
        torch.cuda.synchronize()
        s_err = max(
            int((s_k[0][:-z].long() - tree_idx[:-z].long()).abs().max()),
            int((s_k[1][:-1].long() - tree_val[:-1].long()).abs().max()),
            int((s_k[2][:-1].long() - nonces[:-1].long()).abs().max()),
        )
        s_args = (key, *s_k, flat_b, owner, epoch, new_pidx, new_pval)
        s_ms = cuda_ms(lambda: gk.scatter_encrypt_rows_tiled(*s_args, z=z, rounds=rounds), 20)
        s_plain = cuda_ms(lambda: gk.scatter_encrypt_rows_plain(*s_args, z=z, rounds=rounds), 3)
        del s_k, s_args

        # bounds from what this run's data needs: the gather reads each
        # distinct fetched row (idx + val + nonce) once and writes R rows;
        # the scatter reads the owned plaintext rows and writes them and
        # their nonces (+ the ids and owner bits). Keystreams: one per
        # distinct gathered row that was ever written (nonce not (0, 0)),
        # one per owned written row; one XOR per output word.
        w = z + zv
        n_owned = int(owner.sum())
        g_bytes = 4 * (uniq * (w + 2) + r + r * w + 8)
        s_bytes = 4 * (n_owned * w + r + n_owned * (w + 2) + 10) + r
        g_ops = keystream_ops(uniq_written, w, rounds) + r * w
        s_ops = keystream_ops(n_owned, w, rounds) + n_owned * w
        shapes.append(dict(
            tree=tree, rows=r, row_words=w, calls_per_round=calls,
            unique_rows=uniq, unique_written_rows=uniq_written,
            never_written_rows=unwritten,
            owned_rows=n_owned,
            gather=dict(ms=g_ms, plain_ms=g_plain, max_abs_err=g_err,
                        bytes=g_bytes, ops=g_ops),
            scatter=dict(ms=s_ms, plain_ms=s_plain, max_abs_err=s_err,
                         bytes=s_bytes, ops=s_ops),
        ))
        del key, tree_idx, tree_val, nonces, new_pidx, new_pval, uniq_b
        torch.cuda.empty_cache()
    return shapes


def kernel_entries(shapes, launches):
    """One entry per kernel; times and bounds are per engine round (one
    records call + two mailbox calls at the shapes measured)."""
    meta = {
        "gather": ("gather_decrypt_rows_tiled",
                   "grapevine_tpu/oblivious/pallas_gather.py:203"),
        "scatter": ("scatter_encrypt_rows_tiled",
                    "grapevine_tpu/oblivious/pallas_gather.py:360"),
    }
    out = []
    for kind, (name, replaces) in meta.items():
        ms = plain = bytes_ms = ops_ms = 0.0
        err = 0
        per_shape = []
        for s in shapes:
            k, c = s[kind], s["calls_per_round"]
            b_ms = k["bytes"] / HBM_BYTES_PER_S * 1e3
            o_ms = k["ops"] / INT32_OPS_PER_S * 1e3
            ms += c * k["ms"]
            plain += c * k["plain_ms"]
            bytes_ms += c * b_ms
            ops_ms += c * o_ms
            err = max(err, k["max_abs_err"])
            per_shape.append(dict(tree=s["tree"], rows=s["rows"],
                                  row_words=s["row_words"], calls_per_round=c,
                                  unique_rows=s["unique_rows"],
                                  unique_written_rows=s["unique_written_rows"],
                                  never_written_rows=s["never_written_rows"],
                                  owned_rows=s["owned_rows"],
                                  ms=k["ms"], plain_ms=k["plain_ms"],
                                  bound_ms=max(b_ms, o_ms),
                                  bytes_ms=b_ms, ops_ms=o_ms,
                                  max_abs_err=k["max_abs_err"]))
        out.append(dict(
            name=name, route="cuda",
            source="grapevine_tpu_torch/csrc/gather_kernels.cu",
            replaces=replaces, launches=launches[name], max_abs_err=err,
            ms=ms, plain_ms=plain, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None, per_engine_round=True, shapes=per_shape,
        ))
    return out


def _key(tag: str, i: int) -> bytes:
    return (tag.encode() + i.to_bytes(4, "little")).ljust(32, b"\x5a")


def _payload(tag: int, i: int) -> bytes:
    import grapevine_tpu_torch.wire.constants as C

    return (tag.to_bytes(2, "little") + i.to_bytes(4, "little")).ljust(
        C.PAYLOAD_SIZE, bytes([tag & 0xFF]))


def run_slice(eng):
    """Phase 4: CRUD rounds through handle_queries, each response checked
    against a dict model of what was written. Returns per-round stats."""
    from grapevine_tpu_torch.wire import constants as C
    from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

    b = eng.ecfg.batch_size
    # recipients 0..nrec-1, b/nrec messages each; message A of recipient r
    # is created in slot r, message B in slot r + nrec (A is older). A
    # light mailbox-table load keeps every in-round claim admitted.
    nrec = b // 8
    sender = [_key("snd", i) for i in range(b)]
    recip = [_key("rcp", i % nrec) for i in range(b)]
    stranger = _key("zzz", 0)
    zero = bytes(16)
    model: dict[bytes, dict] = {}  # msg_id → {"sender", "recipient", "payload"}
    ids: list[bytes] = []
    rounds: list[dict] = []

    def req(t, auth, rcp=bytes(32), mid=zero, payload=None):
        return QueryRequest(request_type=t, auth_identity=auth, record=RequestRecord(
            msg_id=mid, recipient=rcp,
            payload=payload if payload is not None else bytes(C.PAYLOAD_SIZE)))

    def run(reqs, expect, now):
        t0 = time.perf_counter()
        resp = eng.handle_queries(reqs, now)
        dt = time.perf_counter() - t0
        rounds.append(dict(ops=len(reqs), s=dt))
        for i, (r, (status, mid)) in enumerate(zip(resp, expect)):
            if r.status_code != status:
                raise AssertionError(f"round {len(rounds)} op {i}: status "
                                     f"{r.status_code}, expected {status}")
            if status == C.STATUS_CODE_SUCCESS and mid is not None:
                m = model[mid]
                if (r.record.msg_id, r.record.sender, r.record.recipient,
                        r.record.payload) != (mid, m["sender"], m["recipient"],
                                              m["payload"]):
                    raise AssertionError(f"round {len(rounds)} op {i}: record "
                                         "differs from the model")
        return resp

    q = nrec // 4  # a quarter of the recipients
    A = list(range(nrec))  # slot of message A of recipient r
    Bm = list(range(nrec, 2 * nrec))  # slot of message B of recipient r

    # round 1: B creates, b/nrec messages for each recipient
    pays = [_payload(1, i) for i in range(b)]
    resp = run([req(C.REQUEST_TYPE_CREATE, sender[i], recip[i], payload=pays[i])
                for i in range(b)], [(C.STATUS_CODE_SUCCESS, None)] * b, NOW)
    for i, r in enumerate(resp):
        ids.append(r.record.msg_id)
        model[r.record.msg_id] = dict(sender=sender[i], recipient=recip[i], payload=pays[i])
    if len(set(ids)) != b or zero in ids:
        raise AssertionError("created msg_ids are not distinct and nonzero")

    # round 2: per quarter of recipients — read A, update A, delete A,
    # zero-id read (→ A, the oldest); plus zero-id reads by strangers
    g = [list(range(k * q, (k + 1) * q)) for k in range(4)]
    reqs, exp = [], []
    for r in g[0]:
        reqs.append(req(C.REQUEST_TYPE_READ, sender[A[r]], mid=ids[A[r]]))
        exp.append((C.STATUS_CODE_SUCCESS, ids[A[r]]))
    upd = {}
    for r in g[1]:
        upd[r] = _payload(2, r)
        reqs.append(req(C.REQUEST_TYPE_UPDATE, sender[A[r]], recip[A[r]],
                        ids[A[r]], upd[r]))
        exp.append((C.STATUS_CODE_SUCCESS, None))
    for r in g[2]:
        reqs.append(req(C.REQUEST_TYPE_DELETE, recip[A[r]], recip[A[r]], ids[A[r]]))
        exp.append((C.STATUS_CODE_SUCCESS, ids[A[r]]))
    for r in g[3]:
        reqs.append(req(C.REQUEST_TYPE_READ, recip[A[r]], recip[A[r]]))
        exp.append((C.STATUS_CODE_SUCCESS, ids[A[r]]))
    while len(reqs) < b:
        reqs.append(req(C.REQUEST_TYPE_READ, _key("nob", len(reqs))))
        exp.append((C.STATUS_CODE_NOT_FOUND, None))
    run(reqs, exp, NOW + 1)
    for r in g[1]:
        model[ids[A[r]]]["payload"] = upd[r]
    for r in g[2]:
        del model[ids[A[r]]]

    # round 3: read A back (original / updated / deleted → NOT_FOUND),
    # zero-id delete (pops A), read every B by its sender
    reqs, exp = [], []
    for r in g[0] + g[1]:
        reqs.append(req(C.REQUEST_TYPE_READ, recip[A[r]], mid=ids[A[r]]))
        exp.append((C.STATUS_CODE_SUCCESS, ids[A[r]]))
    for r in g[2]:
        reqs.append(req(C.REQUEST_TYPE_READ, recip[A[r]], mid=ids[A[r]]))
        exp.append((C.STATUS_CODE_NOT_FOUND, None))
    for r in g[3]:
        reqs.append(req(C.REQUEST_TYPE_DELETE, recip[A[r]], recip[A[r]]))
        exp.append((C.STATUS_CODE_SUCCESS, ids[A[r]]))
    for r in range(nrec):
        reqs.append(req(C.REQUEST_TYPE_READ, sender[Bm[r]], mid=ids[Bm[r]]))
        exp.append((C.STATUS_CODE_SUCCESS, ids[Bm[r]]))
    run(reqs, exp, NOW + 2)
    for r in g[3]:
        del model[ids[A[r]]]

    # round 4 (half full: padded): zero-id reads now select B where A is
    # gone; strangers are refused; a wrong recipient on update is refused
    reqs, exp = [], []
    for r in g[2] + g[3]:
        reqs.append(req(C.REQUEST_TYPE_READ, recip[Bm[r]], recip[Bm[r]]))
        exp.append((C.STATUS_CODE_SUCCESS, ids[Bm[r]]))
    for r in g[0]:
        reqs.append(req(C.REQUEST_TYPE_READ, stranger, mid=ids[A[r]]))
        exp.append((C.STATUS_CODE_NOT_FOUND, None))
    for r in g[1]:
        reqs.append(req(C.REQUEST_TYPE_UPDATE, sender[Bm[r]], stranger, ids[Bm[r]],
                        _payload(3, r)))
        exp.append((C.STATUS_CODE_INVALID_RECIPIENT, None))
    run(reqs, exp, NOW + 3)

    # rounds 5-7: full rounds of reads by id over every live message; the
    # last one under the profiler (kept out of the round statistics)
    live = list(model)
    for k in range(3):
        reqs, exp = [], []
        for j in range(b):
            mid = live[(j + k * 7) % len(live)]
            reqs.append(req(C.REQUEST_TYPE_READ, model[mid]["recipient"], mid=mid))
            exp.append((C.STATUS_CODE_SUCCESS, mid))
        if k < 2:
            run(reqs, exp, NOW + 4 + k)
        else:
            prof = profile_round(lambda: run(reqs, exp, NOW + 4 + k))
            rounds.pop()

    if eng.message_count() != len(model):
        raise AssertionError(f"engine holds {eng.message_count()} messages, "
                             f"model {len(model)}")
    h = eng.health()
    if h["stash_overflow"] != 0:
        raise AssertionError(f"stash overflow {h['stash_overflow']}")
    return rounds, h, prof


#: the round's record_function spans (the reference's device_phase names)
SPANS = ("round_a_mailbox", "round_b_records", "round_c_mailbox", "oram_fetch",
         "oram_apply", "oram_evict", "oram_writeback", "respond")


def profile_round(fn) -> dict:
    """Run ``fn`` (one engine round) under torch.profiler: device time per
    span (the record_function ranges) and per kernel, and the device's
    busy share of the round's wall time (kernel time summed; one stream,
    so kernels do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    spans = {e.key: e.device_time_total / 1e3 for e in ev if e.key in SPANS}
    kernels = sorted((e for e in ev if e.key not in SPANS),
                     key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return dict(
        wall_ms=wall_ms, device_ms=device_ms,
        device_busy_share=device_ms / wall_ms,
        device_kernels=sum(e.count for e in kernels),
        span_device_ms=spans,
        top_kernels=[dict(name=e.key[:90], ms=e.self_device_time_total / 1e3,
                          count=e.count) for e in kernels[:12]],
    )


def cross_check(GrapevineConfig, GrapevineEngine, convert, device="cuda"):
    """Phase 5: kernel engine ≡ plain ("jnp") engine on the card."""
    import numpy as np

    from grapevine_tpu_torch.wire import constants as C
    from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

    engines = {
        impl: GrapevineEngine(GrapevineConfig(
            max_messages=2**14, max_recipients=2**10, batch_size=64,
            bucket_cipher_impl=impl, vphases_impl="dense"), seed=SEED, device=device)
        for impl in ("pallas_fused_tiled", "jnp")
    }
    rng = np.random.default_rng(SEED)
    users = [_key("usr", i) for i in range(24)]
    created: list = []
    for rnd in range(5):
        reqs = []
        for i in range(64 if rnd % 2 == 0 else 50):
            a, r = users[rng.integers(24)], users[rng.integers(24)]
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
            reqs.append(QueryRequest(request_type=t, auth_identity=a,
                                     record=RequestRecord(
                                         msg_id=mid, recipient=r,
                                         payload=_payload(rnd, i))))
        outs = {impl: e.handle_queries_with_transcript(reqs, NOW + rnd)
                for impl, e in engines.items()}
        (rk, tk), (rj, tj) = outs["pallas_fused_tiled"], outs["jnp"]
        if [x.pack() for x in rk] != [x.pack() for x in rj]:
            raise AssertionError(f"cross-check round {rnd}: responses differ")
        if not np.array_equal(tk, tj):
            raise AssertionError(f"cross-check round {rnd}: transcripts differ")
        diff = convert.first_difference(
            convert.to_numpy(engines["pallas_fused_tiled"].state),
            convert.to_numpy(engines["jnp"].state), mask_junk=True)
        if diff is not None:
            raise AssertionError(f"cross-check round {rnd}: state differs at {diff}")
        for q, r in zip(reqs, rk):
            if q.request_type == C.REQUEST_TYPE_CREATE and r.status_code == 1:
                created.append((r.record.msg_id, q.auth_identity, q.record.recipient))
    return dict(rounds=5, messages=engines["jnp"].message_count(), equal=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine import convert
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine
    from grapevine_tpu_torch.engine.state import EngineConfig
    from grapevine_tpu_torch.oblivious import gather_kernels as gk
    from grapevine_tpu_torch.oram import path_oram, round as round_mod

    card = card_line()
    emit({"card": card})
    t0 = time.perf_counter()
    lib = gk.build_library(verbose=True)
    gk._load()
    emit({"build_s": time.perf_counter() - t0, "library": lib.name})

    prod = GrapevineConfig(max_messages=2**20, max_recipients=2**12,
                           batch_size=2048, bucket_cipher_impl="pallas_fused_tiled",
                           vphases_impl="dense")
    shapes = kernel_checks(EngineConfig.from_config(prod), gk, path_oram, round_mod)
    for s in shapes:
        for kind in ("gather", "scatter"):
            if s[kind]["max_abs_err"] != 0:
                raise AssertionError(f"{kind} kernel differs from its plain "
                                     f"version at the {s['tree']} shape")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = GrapevineEngine(prod, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gk.reset_launches()
    rounds, health, prof = run_slice(eng)
    launches = dict(gk.LAUNCHES)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    driven = len(rounds) + 1  # the timed rounds + the profiled one
    round_ms = [r["s"] * 1e3 for r in rounds]
    steady = sorted(round_ms[1:])
    slice_line = dict(
        slice=dict(max_messages=prod.max_messages,
                   max_recipients=prod.max_recipients,
                   batch_size=prod.batch_size,
                   bucket_cipher_impl=prod.bucket_cipher_impl),
        init_s=init_s, rounds=len(rounds), ops=sum(r["ops"] for r in rounds),
        ops_per_s=sum(r["ops"] for r in rounds[1:]) / sum(r["s"] for r in rounds[1:]),
        first_round_ms=round_ms[0], round_ms=round_ms,
        median_round_ms=statistics.median(steady),
        p99_round_ms=steady[min(len(steady) - 1, int(0.99 * len(steady)))],
        mem_allocated_bytes=torch.cuda.memory_allocated(),
        max_mem_allocated_bytes=torch.cuda.max_memory_allocated(),
        rounds_driven=driven, launches=launches,
        launches_per_round={k: v / driven for k, v in launches.items()},
        messages=health["messages"], recipients=health["recipients"],
        stash_occupancy=health["stash_occupancy"], card=card,
    )
    del eng
    torch.cuda.empty_cache()

    xc = cross_check(GrapevineConfig, GrapevineEngine, convert)
    emit({"kernels": kernel_entries(shapes, launches), "card": card})
    emit(slice_line)
    emit({"profile": prof, "card": card})
    emit({"cross_check": xc})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
