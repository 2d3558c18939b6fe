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
   row cipher (B2 the ring up to 8 rows a step);
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
   ``evict_every=4`` over three windows.

Before each slice every launch count is set to 0, and read just after.
Each earlier line of output is one JSON object; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device the script
exits non-zero before printing any result.
"""

from __future__ import annotations

import gc
import json
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


def kernel_checks(ecfg, gk, ck, path_oram, round_mod):
    """Phase 3: each kernel against its plain version, per shape. Round
    shapes: the records round B and the mailbox rounds A/C of one engine
    round; flush shapes: one records and one mailbox flush of a whole
    ``EVICT_EVERY`` window, targets deduplicated as ``oram_flush`` does."""
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
        # B2 decrypts the same rows, gathered first, under their nonces
        c_rows = [("round", pi, pv, flat_b, nonces[flat_b.long()].contiguous())]
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
            ki, kv = ck.cipher_rows_pallas(*c_args, rounds=rounds)
            qi, qv = ck.cipher_rows_pallas_plain(*c_args, rounds=rounds)
            torch.cuda.synchronize()
            shapes.append(dict(
                common, kernel="cipher_rows_pallas", shape=shape, rows=rr,
                never_written_rows=rr - written,
                max_abs_err=max(max_err(ki, qi), max_err(kv, qv)),
                launch=gk.ring_launch_config("cipher_rows_pallas", rr, z, zv),
                ms=cuda_ms(lambda: ck.cipher_rows_pallas(*c_args, rounds=rounds), 20),
                plain_ms=cuda_ms(lambda: ck.cipher_rows_pallas_plain(
                    *c_args, rounds=rounds), 3),
                bytes=4 * (2 * rr * w + 3 * rr + 8),
                ops=keystream_ops(written, w, rounds) + written * w))
            del ki, kv, qi, qv
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


def kernel_entries(shapes, launches):
    """One entry per kernel: its headline time, plain time and bound sum
    the calls ``PER`` names; ``shapes`` keeps every per-call measurement."""
    out = []
    for name, (source, replaces) in KERNELS.items():
        per, calls = PER[name]
        mine = [s for s in shapes if s["kernel"] == name]
        pick = {(s["tree"], s["shape"]): s for s in mine}
        ms = sum(c * pick[(t, sh)]["ms"] for t, sh, c in calls)
        plain = sum(c * pick[(t, sh)]["plain_ms"] for t, sh, c in calls)
        bytes_ms = sum(c * pick[(t, sh)]["bytes_ms"] for t, sh, c in calls)
        ops_ms = sum(c * pick[(t, sh)]["ops_ms"] for t, sh, c in calls)
        out.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name],
            max_abs_err=max(s["max_abs_err"] for s in mine),
            ms=ms, plain_ms=plain, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=None, per=per,
            shapes=[{k: v for k, v in s.items() if k not in ("kernel", "bytes", "ops")}
                    for s in mine],
        ))
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
    per-round stats, the health after the run, and the profile of the
    last round if ``profile_last``."""
    import numpy as np

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
    # collect the earlier phases' garbage (a profiler trace holds many
    # cyclic objects) before the timed rounds, or an oldest-generation
    # pass inside one of them pays for it
    gc.collect()
    tracked = len(gc.get_objects())
    OK, NF = C.STATUS_CODE_SUCCESS, C.STATUS_CODE_NOT_FOUND

    def req(t, auth, rcp=bytes(32), mid=zero, payload=None):
        return QueryRequest(request_type=t, auth_identity=auth, record=RequestRecord(
            msg_id=mid, recipient=rcp,
            payload=payload if payload is not None else bytes(C.PAYLOAD_SIZE)))

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
        for i, (r, (status, want)) in enumerate(zip(resp, expect)):
            if r.status_code != status:
                raise AssertionError(f"round {len(rounds)} op {i}: status "
                                     f"{r.status_code}, expected {status}")
            got = (r.record.msg_id, r.record.sender, r.record.recipient,
                   r.record.payload)
            if want is not None and got != want:
                raise AssertionError(f"round {len(rounds)} op {i}: record "
                                     "differs from the model")
        return resp

    q = nrec // 4  # a quarter of the recipients
    A = list(range(nrec))  # slot of message A of recipient r
    Bm = list(range(nrec, 2 * nrec))  # slot of message B of recipient r

    # round 1: B creates, b/nrec messages for each recipient
    pays = [_payload(1, i) for i in range(b)]
    resp = run([req(C.REQUEST_TYPE_CREATE, sender[i], recip[i], payload=pays[i])
                for i in range(b)], [(OK, None)] * b, NOW)
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
        exp.append((OK, rec(ids[A[r]])))
    upd = {}
    for r in g[1]:
        upd[r] = _payload(2, r)
        reqs.append(req(C.REQUEST_TYPE_UPDATE, sender[A[r]], recip[A[r]],
                        ids[A[r]], upd[r]))
        exp.append((OK, None))
    for r in g[2]:
        reqs.append(req(C.REQUEST_TYPE_DELETE, recip[A[r]], recip[A[r]], ids[A[r]]))
        exp.append((OK, rec(ids[A[r]])))
    for r in g[3]:
        reqs.append(req(C.REQUEST_TYPE_READ, recip[A[r]], recip[A[r]]))
        exp.append((OK, rec(ids[A[r]])))
    while len(reqs) < b:
        reqs.append(req(C.REQUEST_TYPE_READ, _key("nob", len(reqs))))
        exp.append((NF, None))
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
        exp.append((OK, rec(ids[A[r]])))
    for r in g[2]:
        reqs.append(req(C.REQUEST_TYPE_READ, recip[A[r]], mid=ids[A[r]]))
        exp.append((NF, None))
    for r in g[3]:
        reqs.append(req(C.REQUEST_TYPE_DELETE, recip[A[r]], recip[A[r]]))
        exp.append((OK, rec(ids[A[r]])))
    for r in range(nrec):
        reqs.append(req(C.REQUEST_TYPE_READ, sender[Bm[r]], mid=ids[Bm[r]]))
        exp.append((OK, rec(ids[Bm[r]])))
    run(reqs, exp, NOW + 2)
    for r in g[3]:
        del model[ids[A[r]]]

    # round 4 (half full: padded): zero-id reads now select B where A is
    # gone; strangers are refused; a wrong recipient on update is refused
    reqs, exp = [], []
    for r in g[2] + g[3]:
        reqs.append(req(C.REQUEST_TYPE_READ, recip[Bm[r]], recip[Bm[r]]))
        exp.append((OK, rec(ids[Bm[r]])))
    for r in g[0]:
        reqs.append(req(C.REQUEST_TYPE_READ, stranger, mid=ids[A[r]]))
        exp.append((NF, None))
    for r in g[1]:
        reqs.append(req(C.REQUEST_TYPE_UPDATE, sender[Bm[r]], stranger, ids[Bm[r]],
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
                reqs.append(req(C.REQUEST_TYPE_CREATE, sender[j], recip[r], payload=pay))
                exp.append((OK, None))
                post.append((j, sender[j], recip[r], pay))
            elif kind == 1:  # update by its sender
                mid = upd_ids[j // 8]
                pay = _payload(48 + k, j)
                m = model[mid]
                reqs.append(req(C.REQUEST_TYPE_UPDATE, m["sender"], m["recipient"],
                                mid, pay))
                exp.append((OK, None))
                m["payload"] = pay
            elif kind == 2:  # delete by its recipient
                mid = del_ids[j // 8]
                m = model[mid]
                reqs.append(req(C.REQUEST_TYPE_DELETE, m["recipient"], m["recipient"], mid))
                exp.append((OK, rec(mid)))
                del model[mid]
            else:  # read by id by its recipient
                mid = read_ids[(j * 7 + k) % len(read_ids)]
                reqs.append(req(C.REQUEST_TYPE_READ, model[mid]["recipient"], mid=mid))
                exp.append((OK, rec(mid)))
        if profile_last and k == n_rounds - 1:
            prof = profile_round(lambda: run(reqs, exp, NOW + k))
            resp = prof.pop("result")
            rounds[-1]["profiled"] = True
            gc.collect()
        else:
            resp = run(reqs, exp, NOW + k)
        for j, snd, rcp, pay in post:
            model[resp[j].record.msg_id] = dict(sender=snd, recipient=rcp, payload=pay)

    if eng.message_count() != len(model):
        raise AssertionError(f"engine holds {eng.message_count()} messages, "
                             f"model {len(model)}")
    h = eng.health()
    if h["stash_overflow"] != 0:
        raise AssertionError(f"stash overflow {h['stash_overflow']}")
    rounds[0]["gc_tracked_objects_at_start"] = tracked
    return rounds, h, prof


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
SPANS = ("round_a_mailbox", "round_b_records", "round_c_mailbox", "oram_fetch",
         "oram_apply", "oram_evict", "oram_writeback", "respond", "engine_flush",
         "oram_flush")


def profile_round(fn) -> dict:
    """Run ``fn`` (one engine round, and its flush if the window closes)
    under torch.profiler: device time per span (the record_function
    ranges) and per kernel, and the device's busy share of the wall time
    (kernel time summed; one stream, so kernels do not overlap). The
    result of ``fn`` is returned under ``"result"``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        result = fn()
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


def run_evict_slice(GrapevineEngine, cfg, gk, ck, card) -> tuple[dict, dict, dict]:
    """Phase 5: 4 windows of mixed CRUD at ``evict_every=EVICT_EVERY``;
    fetch rounds and flushes timed apart (each flush between two
    synchronizations, taken out of its round's wall time)."""
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
    n_rounds = 4 * EVICT_EVERY
    _reset_launches(gk, ck)
    rounds, health, prof = run_slice(eng, n_rounds, writes=True, profile_last=True)
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
    del eng, flush
    torch.cuda.empty_cache()
    return line, prof, launches


def cross_check(GrapevineConfig, GrapevineEngine, convert, impls, evict_every: int,
                n_rounds: int, device="cuda"):
    """Phase 7: each kernel engine ≡ the plain ("jnp") engine on the card,
    after every round: responses, transcripts, state (junk masked)."""
    import numpy as np

    from grapevine_tpu_torch.wire import constants as C
    from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

    engines = {
        impl: GrapevineEngine(GrapevineConfig(
            max_messages=2**14, max_recipients=2**10, batch_size=64,
            bucket_cipher_impl=impl, vphases_impl="dense", evict_every=evict_every),
            seed=SEED, device=device)
        for impl in ("jnp", *impls)
    }
    rng = np.random.default_rng(SEED)
    users = [_key("usr", i) for i in range(24)]
    created: list = []
    for rnd in range(n_rounds):
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
        for q, r in zip(reqs, rj):
            if q.request_type == C.REQUEST_TYPE_CREATE and r.status_code == 1:
                created.append((r.record.msg_id, q.auth_identity, q.record.recipient))
    flushes = {impl: getattr(e, "flushes", 0) for impl, e in engines.items()}
    if evict_every > 1 and set(flushes.values()) != {n_rounds // evict_every}:
        raise AssertionError(f"cross-check flush counts {flushes}")
    return dict(impls=list(impls), evict_every=evict_every, rounds=n_rounds,
                flushes=flushes["jnp"], messages=engines["jnp"].message_count(),
                equal=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    gc.callbacks.append(GEN2)
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine import convert
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
    shapes = kernel_checks(EngineConfig.from_config(prod), gk, ck, path_oram, round_mod)
    emit({"ring_launch": [
        {k: s[k] for k in ("kernel", "tree", "shape", "rows", "owned_rows", "launch")
         if k in s}
        for s in shapes if s["kernel"] in RING.values()], "card": card})

    # phase 4: the per-round slice (B4, B6)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = GrapevineEngine(prod, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _reset_launches(gk, ck)
    rounds, health, prof = run_slice(eng, 7, writes=False, profile_last=True)
    launches = _launches(gk, ck)
    require_launches(launches, {"gather_decrypt_rows_tiled": 21,
                                "scatter_encrypt_rows_tiled": 21}, "per-round slice")
    slice_line = slice_stats(prod, rounds, health, init_s, launches, card)
    del eng
    torch.cuda.empty_cache()

    # phase 5: the delayed-eviction slice (B3, B5)
    evict = GrapevineConfig(**geo, bucket_cipher_impl="pallas_fused",
                            evict_every=EVICT_EVERY)
    evict_line, evict_prof, evict_launches = run_evict_slice(
        GrapevineEngine, evict, gk, ck, card)

    # phase 6: the "pallas" path (B2)
    unfused = GrapevineConfig(**geo, bucket_cipher_impl="pallas")
    t0 = time.perf_counter()
    eng = GrapevineEngine(unfused, seed=SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    _reset_launches(gk, ck)
    rounds, health, _ = run_slice(eng, 5, writes=True, profile_last=False)
    pallas_launches = _launches(gk, ck)
    require_launches(pallas_launches, {"cipher_rows_pallas": 6 * 5}, "'pallas' path")
    pallas_line = slice_stats(unfused, rounds, health, init_s, pallas_launches, card)
    del eng
    torch.cuda.empty_cache()

    # phase 7: cross-checks at a small geometry
    xc1 = cross_check(GrapevineConfig, GrapevineEngine, convert,
                      ("pallas_fused_tiled",), 1, 5)
    xc4 = cross_check(GrapevineConfig, GrapevineEngine, convert,
                      ("pallas", "pallas_fused", "pallas_fused_tiled"), EVICT_EVERY,
                      3 * EVICT_EVERY)

    launches_by_kernel = {
        "cipher_rows_pallas": pallas_launches["cipher_rows_pallas"],
        "gather_decrypt_rows": evict_launches["gather_decrypt_rows"],
        "gather_decrypt_rows_tiled": launches["gather_decrypt_rows_tiled"],
        "scatter_encrypt_rows": evict_launches["scatter_encrypt_rows"],
        "scatter_encrypt_rows_tiled": launches["scatter_encrypt_rows_tiled"],
    }
    emit(slice_line)
    emit({"profile": prof, "card": card})
    emit({"evict_slice": evict_line})
    emit({"evict_profile": evict_prof, "card": card})
    emit({"pallas_slice": pallas_line})
    emit({"cross_check": [xc1, xc4]})
    emit({"wall_s": time.perf_counter() - t_start, "card": card})
    emit({"kernels": kernel_entries(shapes, launches_by_kernel), "card": card})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
