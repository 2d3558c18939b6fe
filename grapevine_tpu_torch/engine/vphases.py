"""Vectorized phase semantics, ``vphases_impl="dense"`` (port of
``grapevine_tpu/engine/vphases.py``: ``_DenseGroups``, the shared
admission machinery and the three phase callbacks).

Same-key chains inside one round (ops on one recipient / bucket /
record) are resolved in parallel with [B,B] masks; OR/sum aggregates over
row vectors are matrix products. The reference's are float32, exact
while sums stay below 2^24; here they are float64, exact below 2^53 on
every device with no process-wide setting (TF32 and the float32 matmul
precision touch only float32 products), so the port never changes a
global flag. Every sum here is at most B, so both give the same integers.

Admission couples ops across groups. When bus and recipient headroom
cover the whole batch the vectorized fast path is exact; otherwise the
exact sequential walk runs. The reference picks between them with
``lax.cond``; here the predicate is read on the host — one device sync
per round, on a public aggregate (bus or recipient table within B of
full) — and the sequential walk is a Python loop over B run on the host.
"""

from __future__ import annotations

import torch

from ..oblivious.primitives import (
    is_zero_words,
    lex_argsort,
    rank_of,
    scatter_drop,
    u64_add_u32,
    words_equal,
)
from ..oblivious.prp import prp2_encrypt
from ..oblivious.segmented import (
    group_sort,
    sat_apply,
    segmented_exclusive_sat_scan,
)
from ..u32 import narrow
from ..wire import constants as C
from .state import (
    ENT_BLK,
    ENT_IDW,
    ENT_SEQ,
    ENT_SEQH,
    ENT_TS,
    ENT_TSH,
    ENTRY_WORDS,
    KEY_WORDS,
    REC_ID,
    REC_PAYLOAD,
    REC_RECIPIENT,
    REC_SENDER,
    REC_TS,
    REC_TSH,
    EngineConfig,
)

I32 = torch.int32
_INF = -1  # u32 0xFFFFFFFF


def _earlier(b: int, device, strict: bool = True):
    """bool[B,B]: column slot before (or, non-strict, at) the row slot."""
    iota = torch.arange(b, device=device)
    return iota[None, :] < iota[:, None] if strict else iota[None, :] <= iota[:, None]


def _exact_matmul(m, u):
    """Integer-valued product m @ u in float64 (exact below 2^53)."""
    return torch.matmul(m.double(), u.double())


def _bool_matmul(m, u):
    """OR-aggregate u's rows over m's True columns."""
    return _exact_matmul(m, u) > 0.5


def _narrow_sum(x, dim):
    """Sum of u32 lanes keeping u32 wraparound (int64 sum, low 32 bits)."""
    return narrow(x.sum(dim=dim, dtype=torch.int64))


class _DenseGroups:
    """[B,B]-mask group aggregations (the reference's ``_DenseGroups``)."""

    def __init__(self, same):
        b = same.shape[0]
        self.b = b
        self.dev = same.device
        self.m = same | torch.eye(b, dtype=torch.bool, device=same.device)
        self._same = same

    def counts_before(self, flags):
        return torch.sum(
            self._same & _earlier(self.b, self.dev) & flags[None, :], dim=1
        ).to(I32)

    def any_before(self, flags):
        return torch.any(self._same & _earlier(self.b, self.dev) & flags[None, :], dim=1)

    def total_sum(self, flags):
        return torch.sum(self.m & flags[None, :], dim=1).to(I32)

    def total_or(self, flags):
        return torch.any(self.m & flags[None, :], dim=1)

    def total_sum_rows(self, u):
        return _exact_matmul(self.m, u).to(I32)

    def total_or_rows(self, u):
        return _bool_matmul(self.m, u)

    def group_first(self):
        return torch.argmax(self.m.to(I32), dim=1).to(I32)

    def group_last(self):
        iota = torch.arange(self.b, dtype=I32, device=self.dev)
        return torch.amax(torch.where(self.m, iota[None, :], 0), dim=1)

    def first_flag_index(self, flags):
        oh = self.m & flags[None, :]
        return torch.argmax(oh.to(I32), dim=1).to(I32), torch.any(oh, dim=1)

    def last_flag_index_upto(self, flags):
        iota = torch.arange(self.b, dtype=I32, device=self.dev)
        wm = self.m & flags[None, :] & _earlier(self.b, self.dev, strict=False)
        return torch.amax(torch.where(wm, iota[None, :], -1), dim=1)

    def last_flag_index(self, flags):
        iota = torch.arange(self.b, dtype=I32, device=self.dev)
        wm = self.m & flags[None, :]
        return torch.amax(torch.where(wm, iota[None, :], -1), dim=1)

    def select_by_rank(self, flags, vals, q):
        rank = self.counts_before(flags)
        oh = self.m & flags[None, :] & (rank[None, :] == q[:, None])
        return _narrow_sum(oh[:, :, None].to(I32) * vals[None, :, :], dim=1)


def _recipient_groups(ka, is_real):
    requal = (
        words_equal(ka[:, None, :], ka[None, :, :])
        & is_real[:, None]
        & is_real[None, :]
    )
    return _DenseGroups(requal)


def _index_groups(idx, is_real):
    eq = (idx[:, None] == idx[None, :]) & is_real[:, None] & is_real[None, :]
    return _DenseGroups(eq)


def _mb_parse_batch(ecfg: EngineConfig, vals):
    """[B, Vmb] → keys [B,K,8], entries [B,K,cap,ENTRY_WORDS]."""
    b = vals.shape[0]
    k, cap, ew = ecfg.mb_slots, ecfg.mailbox_cap, ENTRY_WORDS
    v = vals.reshape(b, k, KEY_WORDS + ew * cap)
    return v[:, :, :KEY_WORDS], v[:, :, KEY_WORDS:].reshape(b, k, cap, ew)


def _mb_pack_batch(ecfg: EngineConfig, keys, entries):
    b = keys.shape[0]
    k, cap, ew = ecfg.mb_slots, ecfg.mailbox_cap, ENTRY_WORDS
    flat = torch.cat([keys, entries.reshape(b, k, cap * ew)], dim=2)
    return flat.reshape(b, k * (KEY_WORDS + ew * cap))


# ----------------------------------------------------------------------
# admission: who gets to create / claim / pop, exactly, in slot order
# ----------------------------------------------------------------------


def _admission_fast(ecfg, *, is_create_cand, is_pop_cand, found0, first_create,
                    free_slots0, init_count, groups_r, groups_g, rslot):
    """Quota-decoupled admission (bus + recipient headroom ≥ B)."""
    b = rslot.shape[0]
    cap = ecfg.mailbox_cap
    dev = rslot.device
    claim_cand = first_create & ~found0
    claim_rank = groups_g.counts_before(claim_cand)
    claim_ok = claim_cand & (claim_rank < free_slots0)
    claimed_r = groups_r.total_or(claim_ok)
    active = found0 | claimed_r

    # saturating occupancy walk per recipient, segmented by first-occ slot
    create_elem = is_create_cand & active
    pop_elem = is_pop_cand & active
    add = torch.where(create_elem, 1, torch.where(pop_elem, -1, 0)).to(I32)
    lo = torch.zeros(b, dtype=I32, device=dev)
    hi = torch.full((b,), cap, dtype=I32, device=dev)
    # rslot is a slot index (< B), bounded, so the walk's grouping sort
    # follows the sort_impl knob
    perm, inv, seg = group_sort(rslot, sort_impl=ecfg.sort_impl,
                                key_bits=max(1, (b - 1).bit_length()))
    pre = segmented_exclusive_sat_scan((add[perm], lo[perm], hi[perm]), seg)
    count_before = sat_apply(pre, init_count[perm])[inv]

    return dict(
        create_ok=create_elem & (count_before < cap),
        pop_ok=pop_elem & (count_before > 0),
        claim_ok=claim_ok,
        count_before=count_before,
        can_alloc=torch.ones(b, dtype=torch.bool, device=dev),
        active=active,
    )


def _admission_slow(ecfg, *, is_create_cand, is_pop_cand, found0, first_create,
                    free_slots0, init_count, rslot, gslot, free_top0,
                    recipients0):
    """Exact sequential admission for the near-saturation regime: the
    reference's ``lax.scan`` over counters, as a Python loop over B on the
    host (one copy of a few [B] vectors each way)."""
    b = rslot.shape[0]
    cap = ecfg.mailbox_cap
    dev = rslot.device
    crt, pop, fnd, fc, r_, g_, ic, fs0 = (
        t.cpu().tolist() for t in (
            is_create_cand, is_pop_cand, found0, first_create, rslot, gslot,
            init_count, free_slots0,
        )
    )
    counts = [ic[i] if r_[i] == i else 0 for i in range(b)]
    frees = [fs0[i] if g_[i] == i else 0 for i in range(b)]
    claimed = [False] * b
    n_alloc = 0
    recips = int(recipients0)
    free_top = int(free_top0)
    out = {k: [] for k in ("create_ok", "pop_ok", "claim_ok", "count_before",
                           "can_alloc", "active")}
    for j in range(b):
        r, g = r_[j], g_[j]
        cnt, fs = counts[r], frees[g]
        can_alloc = n_alloc < free_top
        room = recips < ecfg.max_recipients
        claim_ok = fc[j] and not fnd[j] and fs > 0 and room and can_alloc
        active = fnd[j] or claimed[r] or claim_ok
        create_ok = crt[j] and can_alloc and active and cnt < cap
        pop_ok = pop[j] and active and cnt > 0
        counts[r] = cnt + int(create_ok) - int(pop_ok)
        frees[g] = fs - int(claim_ok)
        claimed[r] = claimed[r] or claim_ok
        n_alloc += int(create_ok)
        recips += int(claim_ok)
        for k, val in (("create_ok", create_ok), ("pop_ok", pop_ok),
                       ("claim_ok", claim_ok), ("count_before", cnt),
                       ("can_alloc", can_alloc), ("active", active)):
            out[k].append(val)
    return {
        k: torch.tensor(vals, dtype=I32 if k == "count_before" else torch.bool,
                        device=dev)
        for k, vals in out.items()
    }


# ----------------------------------------------------------------------
# phase A: mailbox round (capacity, append, zero-id select/pop)
# ----------------------------------------------------------------------


def phase_a_batch(ecfg: EngineConfig, ctx: dict):
    """Build the round-A ``apply_batch`` callback (semantics in the
    reference's ``phase_a_batch`` docstring). ``ctx["fast_ok"]`` is the
    host-side admission predicate."""
    b = ctx["ka"].shape[0]
    d = ecfg.mb_choices
    k, cap = ecfg.mb_slots, ecfg.mailbox_cap
    is_real = ctx["is_real"]
    is_create_cand = ctx["is_create"] & is_real & ~ctx["zero_recip"]
    is_pop_cand = ctx["is_delete"] & ctx["id_zero"] & is_real
    is_zsel = (ctx["is_read"] | ctx["is_delete"]) & ctx["id_zero"] & is_real
    ka = ctx["ka"]
    idxs_mb2 = ctx["idxs_mb2"]  # int32[B,D]
    now = ctx["now"]
    dev = ka.device
    m_sentinel = ecfg.mb_table_buckets
    iota = torch.arange(b, dtype=I32, device=dev)

    groups_r = _recipient_groups(ka, is_real)
    rslot = groups_r.group_first()

    def apply_batch(vals0, present0):
        # --- candidate choice: [B*D] rows → per-op chosen views -------
        keys_c, entries_c = _mb_parse_batch(ecfg, vals0)
        keys_c = keys_c.reshape(b, d, k, KEY_WORDS)
        entries_c = entries_c.reshape(b, d, k, cap, ENTRY_WORDS)
        key_valid_c = ~is_zero_words(keys_c)  # [B,D,K]
        match_c = key_valid_c & words_equal(keys_c, ka[:, None, None, :])
        found_c = torch.any(match_c, dim=2)  # [B,D]
        free_c = (k - key_valid_c.sum(dim=2)).to(I32)  # [B,D]
        if d == 1:
            chosen = torch.zeros(b, dtype=torch.int64, device=dev)
        else:
            emptier = torch.argmax(free_c, dim=1)  # ties → 0
            chosen = torch.where(
                torch.any(found_c, dim=1),
                torch.argmax(found_c.to(I32), dim=1),
                emptier,
            )
        bi = torch.arange(b, device=dev)
        keys0 = keys_c[bi, chosen]  # [B,K,8]
        entries0 = entries_c[bi, chosen]  # [B,K,cap,EW]
        eff_idx = idxs_mb2[bi, chosen]
        eff_idx = torch.where(is_real, eff_idx, m_sentinel + 1 + iota)

        groups_g = _index_groups(eff_idx, is_real)
        gslot = groups_g.group_first()
        glast = groups_g.group_last()

        key_valid0 = ~is_zero_words(keys0)  # [B,K]
        slot_match0 = key_valid0 & words_equal(keys0, ka[:, None, :])  # [B,K]
        found0 = torch.any(slot_match0, dim=1) & is_real
        free_slots0 = (k - key_valid0.sum(dim=1)).to(I32)
        # my recipient's entries (zeros when mailbox absent)
        ent_r = _narrow_sum(entries0 * slot_match0[:, :, None, None].to(I32), dim=1)
        ent_valid = (ent_r[:, :, ENT_SEQ] | ent_r[:, :, ENT_SEQH]) != 0
        init_count = ent_valid.sum(dim=1).to(I32)

        first_create = is_create_cand & ~groups_r.any_before(is_create_cand)

        common = dict(
            is_create_cand=is_create_cand,
            is_pop_cand=is_pop_cand,
            found0=found0,
            first_create=first_create,
            free_slots0=free_slots0,
            init_count=init_count,
            rslot=rslot,
        )
        if ctx["fast_ok"]:
            adm = _admission_fast(ecfg, **common, groups_r=groups_r,
                                  groups_g=groups_g)
        else:
            adm = _admission_slow(
                ecfg, **common, gslot=gslot, free_top0=ctx["free_top0"],
                recipients0=ctx["recipients0"],
            )
        create_ok = adm["create_ok"]
        pop_ok = adm["pop_ok"]
        claim_ok = adm["claim_ok"]
        count_before = adm["count_before"]
        can_alloc = adm["can_alloc"]
        active = adm["active"]

        # --- allocation + ids (n-th successful create takes candidate n)
        grank = rank_of(create_ok)
        cand_cap = ctx["cand_idx"].shape[0] - 1
        alloc_idx = ctx["cand_idx"][grank.clamp(max=cand_cap).long()]
        idr = ctx["id_rand"]
        w0, w1 = prp2_encrypt(ctx["id_key"], alloc_idx, idr[:, 0], ecfg.id_bits)
        new_id = torch.stack([w0, w1, idr[:, 1], idr[:, 2] | 1], dim=1)

        # --- zero-id selection: p-th oldest of [initial sorted ++ creates]
        pops_before = groups_r.counts_before(pop_ok)
        crank = groups_r.counts_before(create_ok)
        sk_lo = torch.where(ent_valid, ent_r[:, :, ENT_SEQ], _INF)
        sk_hi = torch.where(ent_valid, ent_r[:, :, ENT_SEQH], _INF)
        order = lex_argsort(sk_lo, sk_hi, dim=1)
        sorted_ent = torch.gather(ent_r, 1, order[:, :, None].expand(-1, -1, ENTRY_WORDS))
        p = pops_before
        sel_from_init = p < init_count
        pi = p.clamp(0, cap - 1).long()
        init_sel = sorted_ent[bi, pi]  # [B, ENTRY_WORDS]
        q = p - init_count
        created = groups_r.select_by_rank(create_ok, new_id[:, :2], q)
        sel_blk = torch.where(sel_from_init, init_sel[:, ENT_BLK], created[:, 0])
        sel_idw = torch.where(sel_from_init, init_sel[:, ENT_IDW], created[:, 1])
        sel_found = is_zsel & active & (count_before > 0)
        rm_a = pop_ok

        # --- status (precedence documented in the reference) ------------
        status_a = torch.where(
            ctx["zero_recip"], C.STATUS_CODE_INVALID_RECIPIENT,
            torch.where(
                ~can_alloc, C.STATUS_CODE_TOO_MANY_MESSAGES,
                torch.where(
                    ~active, C.STATUS_CODE_TOO_MANY_RECIPIENTS,
                    torch.where(
                        count_before >= cap,
                        C.STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT,
                        C.STATUS_CODE_SUCCESS,
                    ),
                ),
            ),
        ).to(I32)

        # --- final block assembly (committed at each group's last op) --
        free_m = ~key_valid0
        free_rank = (torch.cumsum(free_m.to(I32), dim=1) - free_m.to(I32)).to(I32)
        claim_rank = groups_g.counts_before(claim_ok)
        claim_slot_oh = free_m & (free_rank == claim_rank[:, None]) & claim_ok[:, None]
        claim_slot_r = groups_r.total_or_rows(claim_slot_oh)  # [B,K]
        mslot_oh = torch.where(found0[:, None], slot_match0, claim_slot_r)
        mslot_idx = torch.argmax(mslot_oh.to(I32), dim=1).to(I32)
        has_mslot = torch.any(mslot_oh, dim=1)

        # keys: scatter claims into their group-representative rows (at
        # most one claim per group → in-bounds targets unique)
        ktgt = torch.where(
            claim_ok,
            glast.long() * k + torch.argmax(claim_slot_oh.to(I32), dim=1),
            b * k,
        )
        keys_fin = scatter_drop(
            keys0.reshape(b * k, KEY_WORDS), ktgt, ka
        ).reshape(b, k, KEY_WORDS)

        # initial entries: survivors shift down by popped_init per slot
        pop_sl = mslot_oh & pop_ok[:, None]  # [B,K]
        T = groups_g.total_sum_rows(pop_sl)  # [B,K]
        valid_all = (entries0[:, :, :, ENT_SEQ] | entries0[:, :, :, ENT_SEQH]) != 0
        icount_sl = valid_all.sum(dim=2).to(I32)
        popped_init_sl = torch.minimum(T, icount_sl)
        sk_lo_all = torch.where(valid_all, entries0[:, :, :, ENT_SEQ], _INF)
        sk_hi_all = torch.where(valid_all, entries0[:, :, :, ENT_SEQH], _INF)
        order_all = lex_argsort(sk_lo_all, sk_hi_all, dim=2)
        sorted_all = torch.gather(
            entries0, 2, order_all[:, :, :, None].expand(-1, -1, -1, ENTRY_WORDS)
        )
        e_iota = torch.arange(cap, dtype=I32, device=dev)[None, None, :]
        src = e_iota + popped_init_sl[:, :, None]  # [B,K,cap]
        keepm = src < icount_sl[:, :, None]
        ents_fin = torch.where(
            keepm[:, :, :, None],
            torch.gather(
                sorted_all, 2,
                src.clamp(0, cap - 1).long()[:, :, :, None].expand(-1, -1, -1, ENTRY_WORDS),
            ),
            0,
        )

        # created entries: survivors append after the surviving initials
        T_r = groups_r.total_sum(pop_ok)
        popped_init_r = torch.minimum(T_r, init_count)
        popped_created_r = T_r - popped_init_r
        surv = create_ok & (crank >= popped_created_r) & has_mslot
        pos = torch.clamp(
            (init_count - popped_init_r) + (crank - popped_created_r), min=0
        )
        sq_lo, sq_hi = u64_add_u32(ctx["seq0"][0], ctx["seq0"][1], iota)
        new_entry = torch.stack(
            [new_id[:, 0], new_id[:, 1], sq_lo, sq_hi,
             now.expand(b), ctx["now_hi"].expand(b)], dim=1,
        )
        # distinct (group row, slot, rank) per surviving create — unique;
        # a rank past the mailbox drops, as the reference's 3-D index does
        etgt = torch.where(
            surv & (pos < cap),
            (glast.long() * k + mslot_idx.long()) * cap + pos.long(),
            b * k * cap,
        )
        ents_fin = scatter_drop(
            ents_fin.reshape(b * k * cap, ENTRY_WORDS), etgt, new_entry
        ).reshape(b, k, cap, ENTRY_WORDS)

        assembled = _mb_pack_batch(ecfg, keys_fin, ents_fin)  # [B,V]
        assembled_alive = torch.any(~is_zero_words(keys_fin), dim=1)

        # --- row commit: every fetched row of a bucket carries the
        # bucket's final state (dense bucket → last-choosing-op map)
        op_map = torch.full((m_sentinel + 2,), -1, dtype=I32, device=dev)
        op_map = op_map.scatter_reduce_(
            0, torch.where(is_real, eff_idx, m_sentinel + 1).long(), iota,
            reduce="amax",
        )[: m_sentinel + 1]
        rows_idx = idxs_mb2.reshape(b * d)
        g = op_map[rows_idx.clamp(max=m_sentinel).long()]  # -1 = none
        has_g = (g >= 0) & (rows_idx < m_sentinel)
        gc = g.clamp(0, b - 1).long()
        final_val = torch.where(has_g[:, None], assembled[gc], vals0)
        final_alive = torch.where(has_g, assembled_alive[gc], present0)

        out_a = {
            "create_ok": create_ok,
            "status_a": status_a,
            "sel_blk": sel_blk,
            "sel_idw": sel_idw,
            "sel_found": sel_found,
            "rm_a": rm_a,
            "alloc_idx": alloc_idx,
            "new_id": new_id,
            "n_claims": claim_ok.to(I32).sum().to(I32),
            "n_allocs": create_ok.to(I32).sum().to(I32),
        }
        return out_a, final_val, final_alive

    return apply_batch


# ----------------------------------------------------------------------
# phase B: records round (verify, insert, mutate, remove)
# ----------------------------------------------------------------------


def phase_b_batch(ecfg: EngineConfig, ctx: dict):
    """Round-B callback (the reference's ``phase_b_batch``)."""
    b = ctx["idx_b"].shape[0]
    realb = ctx["real_b"]
    groups_k = _index_groups(ctx["idx_b"], realb)
    now = ctx["now"]
    create_ev = ctx["is_create"] & ctx["create_ok"] & realb

    def apply_batch(vals0, present0):
        init_id = vals0[:, REC_ID]
        init_sender = vals0[:, REC_SENDER]
        init_recip = vals0[:, REC_RECIPIENT]
        init_ts = vals0[:, REC_TS:REC_TSH + 1]
        init_payload = vals0[:, REC_PAYLOAD]

        # identity fields are fixed per key: creation (in-round) or initial
        c_idx, has_c = groups_k.first_flag_index(create_ev)
        c_idx = c_idx.long()
        sid = torch.where(has_c[:, None], ctx["new_id"][c_idx], init_id)
        ssender = torch.where(has_c[:, None], ctx["auth"][c_idx], init_sender)
        srecip = torch.where(has_c[:, None], ctx["recipient"][c_idx], init_recip)

        match4 = words_equal(sid, ctx["msg_id"])
        match2 = (sid[:, 0] == ctx["sel_blk"]) & (sid[:, 1] == ctx["sel_idw"])
        mtc = torch.where(ctx["id_zero"], match2, match4) & ~ctx["is_create"] & realb
        auth_ok = words_equal(ctx["auth"], ssender) | words_equal(ctx["auth"], srecip)
        recip_match = words_equal(ctx["recipient"], srecip)

        del_pred = ctx["is_delete"] & mtc & auth_ok & (ctx["id_zero"] | recip_match)
        created_before = groups_k.any_before(create_ev)
        base_alive = (present0 & realb) | created_before
        killed_before = groups_k.any_before(del_pred & base_alive)
        alive = base_alive & ~killed_before

        match_ok = alive & mtc
        read_ok = ctx["is_read"] & match_ok & auth_ok
        upd_ok = ctx["is_update"] & match_ok & auth_ok & recip_match
        del_ok = del_pred & alive

        # last payload/ts writer at-or-before me
        W = create_ev | upd_ok
        lw = groups_k.last_flag_index_upto(W)
        has_w = lw >= 0
        lwc = lw.clamp(0, b - 1).long()
        resp_payload = torch.where(has_w[:, None], ctx["payload"][lwc], init_payload)
        now2 = torch.stack([now, ctx["now_hi"]])
        resp_ts = torch.where(has_w[:, None], now2[None, :], init_ts)

        out_b = {
            "read_ok": read_ok,
            "upd_ok": upd_ok,
            "del_ok": del_ok,
            "match_ok": mtc & alive,
            "auth_ok": auth_ok,
            "recip_match": recip_match,
            "resp_id": sid,
            "resp_sender": ssender,
            "resp_recipient": srecip,
            "resp_ts": resp_ts,
            "resp_payload": resp_payload,
        }

        # final per-key state
        any_create = groups_k.total_or(create_ev)
        any_del = groups_k.total_or(del_ok)
        final_alive = ((present0 & realb) | any_create) & ~any_del
        lwf = groups_k.last_flag_index(W)
        has_wf = lwf >= 0
        lwfc = lwf.clamp(0, b - 1).long()
        fin_payload = torch.where(has_wf[:, None], ctx["payload"][lwfc], init_payload)
        fin_ts = torch.where(has_wf[:, None], now2[None, :], init_ts)
        final_val = torch.cat([sid, ssender, srecip, fin_ts, fin_payload], dim=1)
        return out_b, final_val, final_alive

    return apply_batch


# ----------------------------------------------------------------------
# phase C: mailbox finalization (explicit-delete removal, update refresh)
# ----------------------------------------------------------------------


def phase_c_batch(ecfg: EngineConfig, ctx: dict):
    """Round-C callback (the reference's ``phase_c_batch``, dense
    aggregation: a [B·D, B] one-hot matmul)."""
    b = ctx["ka"].shape[0]
    d = ecfg.mb_choices
    k, cap = ecfg.mb_slots, ecfg.mailbox_cap
    is_real = ctx["is_real"]
    idxs_mb2 = ctx["idxs_mb2"]
    m_sentinel = ecfg.mb_table_buckets
    rm_c = ctx["del_ok"] & ~ctx["rm_a"] & is_real
    refresh = ctx["upd_ok"] & is_real
    now = ctx["now"]

    def apply_batch(vals0, present0):
        dev = vals0.device
        keys_c, entries_c = _mb_parse_batch(ecfg, vals0)
        keys_c = keys_c.reshape(b, d, k, KEY_WORDS)
        entries_c = entries_c.reshape(b, d, k, cap, ENTRY_WORDS)
        key_valid_c = ~is_zero_words(keys_c)
        match_c = key_valid_c & words_equal(keys_c, ctx["ka"][:, None, None, :])
        found_c = torch.any(match_c, dim=2)  # [B,D]
        chosen = (
            torch.zeros(b, dtype=torch.int64, device=dev)
            if d == 1
            else torch.argmax(found_c.to(I32), dim=1)
        )
        bi = torch.arange(b, device=dev)
        slot_match = match_c[bi, chosen]  # [B,K]
        entries0 = entries_c[bi, chosen]  # [B,K,cap,EW]
        eff_idx = idxs_mb2[bi, chosen]
        mutating = (rm_c | refresh) & torch.any(found_c, dim=1)
        eff_idx = torch.where(mutating, eff_idx, m_sentinel)

        ent_valid = (entries0[:, :, :, ENT_SEQ] | entries0[:, :, :, ENT_SEQH]) != 0
        em = (
            ent_valid
            & (entries0[:, :, :, ENT_BLK] == ctx["msg_id"][:, 0, None, None])
            & (entries0[:, :, :, ENT_IDW] == ctx["msg_id"][:, 1, None, None])
            & slot_match[:, :, None]
        )  # [B,K,cap]
        u_clear = (em & rm_c[:, None, None]).reshape(b, k * cap)
        u_refresh = (em & refresh[:, None, None]).reshape(b, k * cap)

        rows_idx = idxs_mb2.reshape(b * d)
        row_op = (rows_idx[:, None] == eff_idx[None, :]) & mutating[None, :]
        clear = _bool_matmul(row_op, u_clear).reshape(b * d, k, cap)
        refr = _bool_matmul(row_op, u_refresh).reshape(b * d, k, cap)

        rows_entries = entries_c.reshape(b * d, k, cap, ENTRY_WORDS)
        rows_keys = keys_c.reshape(b * d, k, KEY_WORDS)
        refreshed = rows_entries.clone()
        refreshed[:, :, :, ENT_TS] = now
        refreshed[:, :, :, ENT_TSH] = ctx["now_hi"]
        ents = torch.where(refr[:, :, :, None], refreshed, rows_entries)
        ents = torch.where(clear[:, :, :, None], 0, ents)
        final_val = _mb_pack_batch(ecfg, rows_keys, ents)
        return {}, final_val, present0  # sticky slots: blocks persist

    return apply_batch
