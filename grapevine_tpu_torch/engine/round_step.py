"""Phase-major batched engine step (port of
``grapevine_tpu/engine/round_step.py:engine_round_step`` and
``engine_flush_step``): three vectorized ORAM rounds per batch — mailbox
round A, records round B, mailbox round C — with the slot-order semantics
of the reference (its module docstring documents them), and under
delayed eviction one flush of both trees every ``evict_every`` rounds.

The round's random draws (fresh remap leaves, dummy-fetch leaves, id
nonces) come from :func:`round_draws` on the state's generator; under a
recursive position map the internal ORAMs' leaves come from
:func:`pm_draws` on the state's side generator, so the main stream draws
what it draws under the flat map. ``engine_round_step(..., draws=)``
accepts them from the caller instead, which is how the tests feed both
packages the same numbers.
:func:`transcript_key_groups` is the host-side mirror of the round's key
selection the leak monitor groups the transcript by (``obs/leakmon.py``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..oblivious.primitives import is_zero_words, rank_of, scatter_drop, u64_add_u32
from ..oblivious.prp import prp2_decrypt
from ..oram.path_oram import random_below, random_u32
from ..oram.round import oram_flush, oram_round
from ..wire import constants as C
from .responses import assemble_responses
from .state import EngineConfig, EngineState, mb_bucket_hash
from .vphases import phase_a_batch, phase_b_batch, phase_c_batch

I32 = torch.int32


class PosmapDraws(NamedTuple):
    """One round's internal-ORAM leaves under a recursive position map
    (the reference's ``round_step.py:224-240``): remap and dummy leaves
    for rounds A/B/C, each below its internal tree's leaf count."""

    new_a: torch.Tensor  # int32[B*D] < mb inner leaves
    dummy_a: torch.Tensor
    new_b: torch.Tensor  # int32[B] < rec inner leaves
    dummy_b: torch.Tensor
    new_c: torch.Tensor  # int32[B*D]
    dummy_c: torch.Tensor


class RoundDraws(NamedTuple):
    """One round's private random draws (the reference's
    ``round_step.py:210-222``): remap leaves ``nl_*`` and dummy-fetch
    leaves ``dl_*`` for rounds A/B/C, and ``id_rand`` int32[B, 3];
    ``pm`` the internal leaves (recursive map only; None draws them from
    the state's side generator)."""

    nl_a: torch.Tensor  # int32[B*D] < mb.leaves
    nl_b: torch.Tensor  # int32[B] < rec.leaves
    nl_c: torch.Tensor  # int32[B*D]
    dl_a: torch.Tensor
    dl_b: torch.Tensor
    dl_c: torch.Tensor
    id_rand: torch.Tensor  # int32[B, 3] u32 words
    pm: PosmapDraws | None = None


def round_draws(ecfg: EngineConfig, gen: torch.Generator, b: int, device) -> RoundDraws:
    """Draw one round's randomness from ``gen`` (uniform leaves, uniform
    u32 id words)."""
    d = ecfg.mb_choices
    mbl, recl = ecfg.mb.leaves, ecfg.rec.leaves
    nl_a = random_below(gen, mbl, (b * d,), device)
    nl_b = random_below(gen, recl, (b,), device)
    nl_c = random_below(gen, mbl, (b * d,), device)
    dl_a = random_below(gen, mbl, (b * d,), device)
    dl_b = random_below(gen, recl, (b,), device)
    dl_c = random_below(gen, mbl, (b * d,), device)
    return RoundDraws(nl_a, nl_b, nl_c, dl_a, dl_b, dl_c,
                      random_u32(gen, (b, 3), device))


def pm_draws(ecfg: EngineConfig, gen: torch.Generator, b: int, device) -> PosmapDraws:
    """Draw one round's internal leaves from the side generator ``gen``."""
    d = ecfg.mb_choices
    mbl = ecfg.mb.posmap.inner_leaves
    recl = ecfg.rec.posmap.inner_leaves
    return PosmapDraws(*(random_below(gen, n, (m,), device) for n, m in (
        (mbl, b * d), (mbl, b * d), (recl, b), (recl, b), (mbl, b * d), (mbl, b * d))))


def admission_fast_ok(ecfg: EngineConfig, free_top: int, recipients: int, b: int) -> bool:
    """The reference's admission predicate on exact host values: the
    vectorized branch needs B free blocks and room for B new recipients
    (``grapevine_tpu/engine/vphases.py:629-631``)."""
    return free_top >= b and recipients + b <= ecfg.max_recipients


def transcript_key_groups(batch: dict, mb_choices: int):
    """Host-side mirror of this step's key selection, for the leak
    monitor (obs/leakmon.py; the reference's ``round_step.py:127``).

    ``batch`` is the round's numpy u32 batch columns (``pack_batch``).
    Returns ``((mb_keys, mb_stable), (rec_keys, rec_stable))`` aligned
    to the transcript columns ``[a_0..a_{D-1}, b, c_0..c_{D-1}]``:

    - ``mb_keys`` i64[B·D]: within-round group ids over the flattened
      mailbox fetch slots — two slots share a group iff they fetch the
      same candidate bucket on the device, i.e. same ``ka`` (the
      recipient for CREATE/explicit-id ops, else the auth identity) and
      same choice column. ``-1`` = padding dummy (no key). Grouping by
      ``ka`` rather than the keyed bucket hash (device-resident
      ``hash_key``) can only *miss* accidental hash collisions between
      distinct ``ka`` — an undercount of same-key pairs, never a false
      SUSPECT.
    - ``rec_keys`` i64[B]: records-round groups; explicit-id non-CREATE
      ops group by ``msg_id`` (one msg_id = one PRP-resolved block).
      CREATE (allocates a fresh block) and zero-id ops (block selected
      inside the oblivious round) are not host-resolvable → ``-1``.
    - ``*_stable``: per-slot cross-round-stable ids (bytes) for the
      repeat tracker, ``None`` where keyless.

    The key material stays in process memory (the monitor's standing —
    same as the position map); only windowed aggregates are exported.
    """
    rt = np.asarray(batch["req_type"]).astype(np.uint32)
    auth = np.asarray(batch["auth"], dtype=np.uint32)
    recipient = np.asarray(batch["recipient"], dtype=np.uint32)
    msg_id = np.asarray(batch["msg_id"], dtype=np.uint32)
    b = rt.shape[0]
    is_real = (rt >= C.REQUEST_TYPE_CREATE) & (rt <= C.REQUEST_TYPE_DELETE)
    is_create = rt == C.REQUEST_TYPE_CREATE
    id_zero = ~msg_id.any(axis=1)
    ka = np.where((is_create | ~id_zero)[:, None], recipient, auth)

    d = mb_choices
    mb_keys = np.full((b * d,), -1, np.int64)
    mb_stable: list[bytes | None] = [None] * (b * d)
    mb_groups: dict[bytes, int] = {}
    rec_keys = np.full((b,), -1, np.int64)
    rec_stable: list[bytes | None] = [None] * b
    rec_groups: dict[bytes, int] = {}
    for j in range(b):
        if not is_real[j]:
            continue
        kb = ka[j].tobytes()
        g = mb_groups.setdefault(kb, len(mb_groups))
        for c in range(d):
            mb_keys[j * d + c] = g * d + c
            mb_stable[j * d + c] = kb + bytes([c])
        if not is_create[j] and not id_zero[j]:
            mid = msg_id[j].tobytes()
            rec_keys[j] = rec_groups.setdefault(mid, len(rec_groups))
            rec_stable[j] = mid
    return (mb_keys, mb_stable), (rec_keys, rec_stable)


def engine_round_step(ecfg: EngineConfig, state: EngineState, batch: dict,
                      draws: RoundDraws | None = None, fast_ok: bool | None = None,
                      mesh=None):
    """Process one batch as three phase-major ORAM rounds.

    ``batch``: int32 tensors ``req_type[B]``, ``auth[B,8]``,
    ``msg_id[B,4]``, ``recipient[B,8]``, ``payload[B,234]`` and 0-dim
    ``now``/``now_hi`` (u64 clock lanes). Returns ``(state', responses,
    transcripts int32[B, 2D+1])`` (``[B, 2(2D+1)]`` under a recursive
    map: the internal ORAMs' columns appended in the same layout). The
    input ``state``'s tree tensors are updated in place (consumed, like a
    donated buffer).

    ``fast_ok`` is the quota admission branch, the reference's ``lax.cond``
    predicate ``free_top >= B and recipients + B <= max_recipients`` on the
    input state. ``None`` reads it from the state (a host read, which
    waits for every round still running); the facade passes the value
    when its host-side bound already decides it (``engine/batcher.py``),
    and a caller that passes it must pass exactly that predicate.

    ``mesh`` (the reference's ``axis_name``; ``parallel/mesh.py``) runs
    the three ORAM rounds over a state whose tree planes are sharded;
    ``parallel.make_sharded_step`` is the entry point that passes it."""
    rt = batch["req_type"]
    b = rt.shape[0]
    dev = rt.device
    now = batch["now"]
    now_hi = batch["now_hi"]
    auth, msg_id = batch["auth"], batch["msg_id"]
    recipient, payload = batch["recipient"], batch["payload"]
    d = ecfg.mb_choices
    if draws is None:
        draws = round_draws(ecfg, state.rng, b, dev)
    recursive = ecfg.posmap_impl == "recursive"
    pm = draws.pm
    if recursive and pm is None:
        pm = pm_draws(ecfg, state.pm_rng, b, dev)
    simpl = ecfg.sort_impl

    is_create = rt == C.REQUEST_TYPE_CREATE
    is_read = rt == C.REQUEST_TYPE_READ
    is_update = rt == C.REQUEST_TYPE_UPDATE
    is_delete = rt == C.REQUEST_TYPE_DELETE
    is_real = is_create | is_read | is_update | is_delete
    id_zero = is_zero_words(msg_id)
    zero_recip = is_zero_words(recipient)

    ka = torch.where((is_create | ~id_zero)[:, None], recipient, auth)
    # D candidate buckets per op; every op fetches ALL candidates
    bucket2 = torch.stack(
        [mb_bucket_hash(state.hash_key, ka, ecfg.mb_table_buckets, salt=c)
         for c in range(d)], dim=1,
    )  # [B,D]
    idxs_mb2 = torch.where(is_real[:, None], bucket2, ecfg.mb.dummy_index).to(I32)
    idxs_mb_flat = idxs_mb2.reshape(b * d)

    # allocation candidates: the top B free blocks
    ks = torch.arange(b, dtype=I32, device=dev)
    mm_mask = ecfg.max_messages - 1
    cand_pos = torch.where(ks < state.free_top, (state.free_top + mm_mask - ks) & mm_mask, 0)
    cand_idx = state.freelist[cand_pos.long()]

    if fast_ok is None:
        # quota admission branch: a host read of public aggregates (one sync)
        fast_ok = admission_fast_ok(
            ecfg, *torch.stack([state.free_top, state.recipients]).tolist(), b)

    # ---- round A: mailbox (capacity, append, zero-id select/pop) ------
    ctx = {
        "is_real": is_real, "is_create": is_create, "is_read": is_read,
        "is_update": is_update, "is_delete": is_delete, "id_zero": id_zero,
        "zero_recip": zero_recip, "ka": ka, "idxs_mb2": idxs_mb2,
        "cand_idx": cand_idx, "id_key": state.id_key,
        "id_rand": draws.id_rand, "free_top0": state.free_top,
        "recipients0": state.recipients, "seq0": state.seq, "now": now,
        "now_hi": now_hi, "auth": auth, "recipient": recipient,
        "msg_id": msg_id, "payload": payload, "fast_ok": fast_ok,
    }
    with record_function("round_a_mailbox"):
        mb1, out_a, leaf_a = oram_round(
            ecfg.mb, state.mb, idxs_mb_flat, draws.nl_a, draws.dl_a,
            phase_a_batch(ecfg, ctx), simpl,
            *((pm.new_a, pm.dummy_a) if recursive else ()),
            occ_impl=ecfg.vphases_impl, mesh=mesh,
        )
    free_top = torch.clamp(state.free_top - out_a["n_allocs"], max=ecfg.max_messages)
    recipients = state.recipients + out_a["n_claims"]
    seq_lo, seq_hi = u64_add_u32(state.seq[0], state.seq[1], b)
    seq = torch.stack([seq_lo, seq_hi])

    # ---- round B: records (verify, insert, mutate, remove) ------------
    create_ok = out_a["create_ok"]
    enc_w0 = torch.where(id_zero, out_a["sel_blk"], msg_id[:, 0])
    enc_w1 = torch.where(id_zero, out_a["sel_idw"], msg_id[:, 1])
    dec_blk = prp2_decrypt(state.id_key, enc_w0, enc_w1, ecfg.id_bits)
    lookup_blk = torch.where(create_ok, out_a["alloc_idx"], dec_blk)
    real_b = is_real & (create_ok | (~is_create & (~id_zero | out_a["sel_found"])))
    idx_b = torch.where(
        real_b, lookup_blk & (ecfg.rec.blocks - 1), ecfg.rec.dummy_index
    ).to(I32)
    ctx_b = {
        **ctx, "idx_b": idx_b, "real_b": real_b, "create_ok": create_ok,
        "new_id": out_a["new_id"], "sel_blk": out_a["sel_blk"],
        "sel_idw": out_a["sel_idw"],
    }
    with record_function("round_b_records"):
        rec1, out_b, leaf_b = oram_round(
            ecfg.rec, state.rec, idx_b, draws.nl_b, draws.dl_b,
            phase_b_batch(ecfg, ctx_b), simpl,
            *((pm.new_b, pm.dummy_b) if recursive else ()),
            occ_impl=ecfg.vphases_impl, mesh=mesh,
        )

    # freed blocks return to the freelist in slot order (next batch)
    dels = out_b["del_ok"]
    push_pos = torch.where(dels, free_top + rank_of(dels), ecfg.max_messages)
    freelist = scatter_drop(state.freelist, push_pos.long(), idx_b)
    free_top = (free_top + dels.to(I32).sum()).to(I32)

    # ---- round C: mailbox finalization --------------------------------
    ctx_c = {**ctx, "del_ok": out_b["del_ok"], "upd_ok": out_b["upd_ok"],
             "rm_a": out_a["rm_a"]}
    with record_function("round_c_mailbox"):
        mb2, _out_c, leaf_c = oram_round(
            ecfg.mb, mb1, idxs_mb_flat, draws.nl_c, draws.dl_c,
            phase_c_batch(ecfg, ctx_c), simpl,
            *((pm.new_c, pm.dummy_c) if recursive else ()),
            occ_impl=ecfg.vphases_impl, mesh=mesh,
        )

    responses = assemble_responses(
        is_real=is_real, is_create=is_create, is_update=is_update,
        is_delete=is_delete, id_zero=id_zero, status_a=out_a["status_a"],
        create_ok=create_ok, out_b=out_b, new_id=out_a["new_id"], auth=auth,
        recipient=recipient, payload=payload, now2=torch.stack([now, now_hi]),
    )
    # transcript: [B, 2D+1] columns (a_0..a_{D-1}, b, c_0..c_{D-1});
    # a recursive map appends the internal ORAMs' in the same layout
    def cols(a, bb, c):
        return [a.reshape(b, d), bb[:, None], c.reshape(b, d)]

    if recursive:
        transcripts = torch.cat(
            cols(leaf_a[:, 0], leaf_b[:, 0], leaf_c[:, 0])
            + cols(leaf_a[:, 1], leaf_b[:, 1], leaf_c[:, 1]), dim=1)
    else:
        transcripts = torch.cat(cols(leaf_a, leaf_b, leaf_c), dim=1)
    new_state = EngineState(
        rec=rec1, mb=mb2, freelist=freelist, free_top=free_top,
        recipients=recipients.to(I32), seq=seq, hash_key=state.hash_key,
        id_key=state.id_key, rng=state.rng, pm_rng=state.pm_rng,
    )
    return new_state, responses, transcripts


def engine_flush_step(ecfg: EngineConfig, state: EngineState, mesh=None) -> EngineState:
    """One delayed-eviction flush over both trees (``evict_every`` > 1).

    The engine calls it every ``evict_every`` rounds on the round-count
    cadence — never on buffer contents. Deterministic given the state
    (no random draws); the trees are updated in place. A recursive map's
    internal trees flush inside the same call. ``mesh`` as in
    :func:`engine_round_step` (``parallel.make_sharded_flush``)."""
    with record_function("engine_flush"):
        rec = oram_flush(ecfg.rec, state.rec, ecfg.sort_impl, mesh)
        mb = oram_flush(ecfg.mb, state.mb, ecfg.sort_impl, mesh)
    return state._replace(rec=rec, mb=mb)
