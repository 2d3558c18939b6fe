"""The op-major engine step (port of ``grapevine_tpu/engine/step.py``):
uniform [mailbox, records, mailbox] accesses, one op at a time.

Every op commits its three ORAM accesses (``oram/path_oram.py:
oram_access``) before the next op starts, in slot order: the reference's
``lax.scan`` is a Python loop here, and each op is one branchless
program, so the loop reads nothing back to the host. This is the
reference's differential-oracle engine (``GrapevineConfig(commit="op")``:
one mailbox choice, a flat map, no tree-top cache, per-access eviction,
one device); its CRUD semantics, the three phases and what each decides
are documented in the reference module.

- **Phase A** (the mailbox bucket of the operative key): CREATE's
  capacity checks and append; zero-id READ/DELETE select the oldest
  entry, and zero-id DELETE removes it.
- **Phase B** (the records block): full id verification, the sender-or-
  recipient auth check, the recipient match for UPDATE/DELETE, the
  payload rewrite, removal and insertion.
- **Phase C** (the same mailbox bucket): the sender-authorized DELETE's
  removal and UPDATE's timestamp refresh.

The step's random draws (each access's fresh leaf, the id nonces) come
from :func:`step_draws` on the state's generator; ``engine_step(...,
draws=)`` takes them from the caller instead, which is how the tests feed
both packages the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..oblivious.primitives import (
    argmin_u64_onehot,
    first_true_onehot,
    flag,
    index1,
    is_zero_words,
    onehot_select,
    scatter_drop,
    u64_add_u32,
    words_equal,
)
from ..oblivious.prp import prp2_decrypt, prp2_encrypt
from ..oram.path_oram import oram_access, random_below, random_u32
from ..wire import constants as C
from .responses import assemble_responses
from .state import (
    ENT_BLK,
    ENT_IDW,
    ENT_SEQ,
    ENT_SEQH,
    ENT_TS,
    ENT_TSH,
    REC_ID,
    REC_PAYLOAD,
    REC_RECIPIENT,
    REC_SENDER,
    REC_TS,
    REC_TSH,
    EngineConfig,
    EngineState,
    mb_bucket_hash,
    mb_pack,
    mb_parse,
)

I32 = torch.int32


class StepDraws(NamedTuple):
    """One step's private random draws (the reference's
    ``step.py:306-310``): the fresh leaf of each op's three accesses, each
    below its tree's leaf count, and ``id_rand`` int32[B, 3]."""

    leaves_a: torch.Tensor  # int32[B] < mb.leaves
    leaves_b: torch.Tensor  # int32[B] < rec.leaves
    leaves_c: torch.Tensor  # int32[B] < mb.leaves
    id_rand: torch.Tensor  # int32[B, 3] u32 words


def step_draws(ecfg: EngineConfig, gen: torch.Generator, b: int, device) -> StepDraws:
    """Draw one step's randomness from ``gen``."""
    mbl, recl = ecfg.mb.leaves, ecfg.rec.leaves
    return StepDraws(random_below(gen, mbl, (b,), device),
                     random_below(gen, recl, (b,), device),
                     random_below(gen, mbl, (b,), device),
                     random_u32(gen, (b, 3), device))


def _phase_a(ecfg: EngineConfig, value, present, o):
    keys, entries = mb_parse(ecfg, value)
    key_valid = ~is_zero_words(keys)
    slot_match = key_valid & words_equal(keys, o["ka"][None, :])
    found = torch.any(slot_match)
    has_free_slot = torch.any(~key_valid)
    tgt_oh = torch.where(found, slot_match, first_true_onehot(~key_valid))

    tgt_entries = onehot_select(tgt_oh, entries)  # [cap, ENTRY_WORDS]
    ent_valid = (tgt_entries[:, ENT_SEQ] | tgt_entries[:, ENT_SEQH]) != 0
    count = ent_valid.to(I32).sum()

    # --- CREATE decision tree (status precedence as the oracle's) -------
    room_for_new_recipient = has_free_slot & (o["recipients"] < ecfg.max_recipients)
    cap_ok = count < ecfg.mailbox_cap
    create_ok = (o["is_create"] & ~o["zero_recip"] & o["can_alloc"]
                 & (found | room_for_new_recipient) & cap_ok)
    status_a = torch.where(
        o["zero_recip"], C.STATUS_CODE_INVALID_RECIPIENT,
        torch.where(
            ~o["can_alloc"], C.STATUS_CODE_TOO_MANY_MESSAGES,
            torch.where(
                ~found & ~room_for_new_recipient, C.STATUS_CODE_TOO_MANY_RECIPIENTS,
                torch.where(~cap_ok, C.STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT,
                            C.STATUS_CODE_SUCCESS),
            ),
        ),
    ).to(I32)

    # --- zero-id selection: the oldest entry (min seq) ------------------
    sel_oh, sel_found = argmin_u64_onehot(
        ent_valid, tgt_entries[:, ENT_SEQH], tgt_entries[:, ENT_SEQ])
    sel_entry = onehot_select(sel_oh, tgt_entries)
    sel_found = sel_found & found

    # --- zero-id DELETE ("pop next") removal: only the zero-id case acts
    # here (its record is live with recipient == the caller by the
    # mailbox invariant); explicit-id deletes wait for phase B's full id
    # and auth checks and are finalized in phase C
    rm_a = o["is_delete"] & o["id_zero"] & sel_found

    # --- apply the append / removal to the target mailbox ---------------
    append_oh = first_true_onehot(~ent_valid) & create_ok
    new_entry = torch.stack([o["new_id"][0], o["new_id"][1], o["seq"][0], o["seq"][1],
                             o["now"], o["now_hi"]])
    ent_mod = torch.where(append_oh[:, None], new_entry[None, :], tgt_entries)
    ent_mod = torch.where((sel_oh & rm_a)[:, None], 0, ent_mod)

    # sticky mailbox slots: a drained mailbox keeps its key slot until
    # the expiry sweep reclaims it
    new_key = torch.where(create_ok & ~found, o["ka"], onehot_select(tgt_oh, keys))
    keys_out = torch.where(tgt_oh[:, None], new_key[None, :], keys)
    entries_out = torch.where(tgt_oh[:, None, None], ent_mod[None, :, :], entries)

    out = {
        "sel_blk": sel_entry[ENT_BLK],
        "sel_idw": sel_entry[ENT_IDW],
        "sel_found": sel_found,
        "create_ok": create_ok,
        "status_a": status_a,
        "rm_a": rm_a,
        "recip_delta": (create_ok & ~found).to(I32),
    }
    # keep: mailbox blocks persist until the sweep
    return (mb_pack(ecfg, keys_out, entries_out), flag(True, value),
            create_ok & ~present, out)


def _phase_b(ecfg: EngineConfig, value, present, o):
    stored_id = value[REC_ID]
    sender = value[REC_SENDER]
    recip_st = value[REC_RECIPIENT]
    ts2 = value[REC_TS:REC_TSH + 1]  # (lo, hi)

    match2 = (stored_id[0] == o["sel_blk"]) & (stored_id[1] == o["sel_idw"])
    match4 = words_equal(stored_id, o["msg_id"])
    match_ok = present & torch.where(o["id_zero"], match2, match4) & ~o["is_create"]

    auth_ok = words_equal(o["auth"], sender) | words_equal(o["auth"], recip_st)
    recip_match = words_equal(o["recipient"], recip_st)

    read_ok = o["is_read"] & match_ok & auth_ok
    upd_ok = o["is_update"] & match_ok & auth_ok & recip_match
    del_ok = o["is_delete"] & match_ok & auth_ok & (o["id_zero"] | recip_match)

    now2 = torch.stack([o["now"], o["now_hi"]])
    new_rec = torch.cat([o["new_id"], o["auth"], o["recipient"], now2, o["payload"]])
    # ts, ts_hi and the payload are the block's tail (REC_TS = 20)
    updated = torch.cat([value[:REC_TS], now2, o["payload"]])
    new_value = torch.where(o["create_ok"], new_rec,
                            torch.where(upd_ok, updated, value))
    out = {
        "read_ok": read_ok,
        "upd_ok": upd_ok,
        "del_ok": del_ok,
        "match_ok": match_ok,
        "auth_ok": auth_ok,
        "recip_match": recip_match,
        "resp_id": stored_id,
        "resp_sender": sender,
        "resp_recipient": recip_st,
        "resp_ts": torch.where(upd_ok, now2, ts2),
        "resp_payload": torch.where(upd_ok, o["payload"], value[REC_PAYLOAD]),
    }
    return new_value, ~del_ok, o["create_ok"], out


def _phase_c(ecfg: EngineConfig, value, present, o):
    keys, entries = mb_parse(ecfg, value)
    key_valid = ~is_zero_words(keys)
    slot_match = key_valid & words_equal(keys, o["ka"][None, :])
    found = torch.any(slot_match)
    tgt_entries = onehot_select(slot_match, entries)
    ent_valid = (tgt_entries[:, ENT_SEQ] | tgt_entries[:, ENT_SEQH]) != 0
    ent_match = (ent_valid & (tgt_entries[:, ENT_BLK] == o["msg_id"][0])
                 & (tgt_entries[:, ENT_IDW] == o["msg_id"][1]))

    # the sender-authorized delete's removal (B proved del_ok; A did not act)
    rm_c = o["del_ok"] & ~o["rm_a"] & found
    ent_mod = torch.where((ent_match & rm_c)[:, None], 0, tgt_entries)
    # an update refreshes the entry's expiry timestamp (B moved the record's)
    refresh = o["upd_ok"] & found
    refreshed = torch.cat([ent_mod[:, :ENT_TS],
                           torch.stack([o["now"], o["now_hi"]]).expand(ent_mod.shape[0], 2),
                           ent_mod[:, ENT_TSH + 1:]], dim=1)
    ent_mod = torch.where((ent_match & refresh)[:, None], refreshed, ent_mod)

    # sticky mailbox slots: keys are never cleared here (the sweep does)
    entries_out = torch.where(slot_match[:, None, None], ent_mod[None, :, :], entries)
    return (mb_pack(ecfg, keys, entries_out), flag(True, value), flag(False, value),
            {"recip_delta": torch.zeros((), dtype=I32, device=value.device)})


def engine_step(ecfg: EngineConfig, state: EngineState, batch: dict,
                draws: StepDraws | None = None):
    """Process one fixed-size batch of (already authenticated) requests,
    op by op in slot order.

    ``batch``: req_type int32[B] (0 = padding dummy), auth int32[B,8],
    msg_id int32[B,4], recipient int32[B,8], payload int32[B,234], now and
    now_hi int32 scalars (u32 words). ``draws`` defaults to
    :func:`step_draws` on ``state.rng``.

    Returns ``(state', responses, transcript)``: responses as the
    phase-major step's (status 0 for dummies); the transcript int32[B, 3]
    is each op's public leaf triple (mailbox, records, mailbox), the same
    in distribution for every op type. The trees are updated in place."""
    rt = batch["req_type"]
    b = rt.shape[0]
    dev = rt.device
    now, now_hi = batch["now"], batch["now_hi"]
    auth, msg_id = batch["auth"], batch["msg_id"]
    recipient, payload = batch["recipient"], batch["payload"]
    if draws is None:
        draws = step_draws(ecfg, state.rng, b, dev)

    # the batch's columns, decided for every op at once (functions of
    # the batch alone, not of the state)
    is_create = rt == C.REQUEST_TYPE_CREATE
    is_read = rt == C.REQUEST_TYPE_READ
    is_update = rt == C.REQUEST_TYPE_UPDATE
    is_delete = rt == C.REQUEST_TYPE_DELETE
    is_real = is_create | is_read | is_update | is_delete
    id_zero = is_zero_words(msg_id)
    zero_recip = is_zero_words(recipient)
    # the operative mailbox key: the recipient for create / explicit-id
    # ops, the caller for zero-id next-message ops
    ka = torch.where((is_create | ~id_zero)[:, None], recipient, auth)
    idx_mb = torch.where(is_real, mb_bucket_hash(state.hash_key, ka, ecfg.mb_table_buckets),
                         ecfg.mb.dummy_index).to(I32)

    rec, mb = state.rec, state.mb
    freelist, free_top = state.freelist, state.free_top
    recipients, seq = state.recipients, state.seq
    per_op = []
    with record_function("engine_step"):
        for i in range(b):
            can_alloc = free_top > 0
            alloc_pos = torch.where(can_alloc, free_top - 1, 0)
            alloc_idx = freelist[index1(alloc_pos)][0]
            # id words 0-1 = the PRP of (nonce, block index); word 3 odd,
            # so a real id is never all-zero
            idr = draws.id_rand[i]
            w0, w1 = prp2_encrypt(state.id_key, alloc_idx, idr[0], ecfg.id_bits)
            new_id = torch.stack([w0, w1, idr[1], idr[2] | 1])
            o = {
                "ka": ka[i], "auth": auth[i], "msg_id": msg_id[i],
                "recipient": recipient[i], "payload": payload[i], "now": now,
                "now_hi": now_hi, "seq": seq, "recipients": recipients,
                "alloc_idx": alloc_idx, "new_id": new_id,
                "is_create": is_create[i], "is_read": is_read[i],
                "is_update": is_update[i], "is_delete": is_delete[i],
                "id_zero": id_zero[i], "zero_recip": zero_recip[i],
                "can_alloc": can_alloc,
            }

            # -- phase A: mailbox ---------------------------------------
            mb1, out_a, leaf_a = oram_access(
                ecfg.mb, mb, idx_mb[i], draws.leaves_a[i], o,
                lambda v, p, oo: _phase_a(ecfg, v, p, oo))
            o.update(out_a)

            # -- phase B: records ---------------------------------------
            enc_w0 = torch.where(o["id_zero"], out_a["sel_blk"], o["msg_id"][0])
            enc_w1 = torch.where(o["id_zero"], out_a["sel_idw"], o["msg_id"][1])
            create_ok = out_a["create_ok"]
            lookup_blk = torch.where(
                create_ok, alloc_idx,
                prp2_decrypt(state.id_key, enc_w0, enc_w1, ecfg.id_bits))
            real_b = is_real[i] & (create_ok | (~o["is_create"]
                                                & (~o["id_zero"] | out_a["sel_found"])))
            idx_b = torch.where(real_b, lookup_blk & (ecfg.rec.blocks - 1),
                                ecfg.rec.dummy_index).to(I32)
            rec, out_b, leaf_b = oram_access(
                ecfg.rec, rec, idx_b, draws.leaves_b[i], o,
                lambda v, p, oo: _phase_b(ecfg, v, p, oo))
            o.update(del_ok=out_b["del_ok"], upd_ok=out_b["upd_ok"])

            # -- freelist bookkeeping (private memory) ------------------
            free_top1 = free_top - create_ok.to(I32)
            push_pos = torch.where(out_b["del_ok"], free_top1, ecfg.max_messages)
            freelist = scatter_drop(freelist, index1(push_pos), idx_b.reshape(1))
            free_top = free_top1 + out_b["del_ok"].to(I32)

            # -- phase C: the mailbox again -----------------------------
            mb, out_c, leaf_c = oram_access(
                ecfg.mb, mb1, idx_mb[i], draws.leaves_c[i], o,
                lambda v, p, oo: _phase_c(ecfg, v, p, oo))

            recipients = recipients + out_a["recip_delta"] + out_c["recip_delta"]
            seq = torch.stack(u64_add_u32(seq[0], seq[1], create_ok.to(I32)))
            per_op.append(dict(out_b, status_a=out_a["status_a"], create_ok=create_ok,
                               new_id=new_id,
                               transcript=torch.stack([leaf_a, leaf_b, leaf_c])))

    cols = {k: torch.stack([x[k] for x in per_op]) for k in per_op[0]}
    responses = assemble_responses(
        is_real=is_real, is_create=is_create, is_update=is_update,
        is_delete=is_delete, id_zero=id_zero, status_a=cols["status_a"],
        create_ok=cols["create_ok"], out_b=cols, new_id=cols["new_id"], auth=auth,
        recipient=recipient, payload=payload, now2=torch.stack([now, now_hi]),
    )
    new_state = state._replace(rec=rec, mb=mb, freelist=freelist, free_top=free_top,
                               recipients=recipients, seq=seq)
    return new_state, responses, cols["transcript"]
