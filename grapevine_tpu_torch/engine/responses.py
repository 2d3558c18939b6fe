"""Response/status assembly (port of ``grapevine_tpu/engine/responses.py``,
the batched form: ``[B]`` masks, multi-word fields with a trailing word
axis)."""

from __future__ import annotations

import torch
from torch.profiler import record_function

from ..wire import constants as C

I32 = torch.int32


def assemble_responses(*, is_real, is_create, is_update, is_delete, id_zero,
                       status_a, create_ok, out_b, new_id, auth, recipient,
                       payload, now2):
    """The constant-shape response dict; ``now2`` is the u64 clock as
    int32[2] (lo, hi)."""
    with record_function("respond"):
        ok_rud = out_b["read_ok"] | out_b["upd_ok"] | out_b["del_ok"]
        bad_recip = (
            (is_update | is_delete) & ~id_zero & out_b["match_ok"]
            & out_b["auth_ok"] & ~out_b["recip_match"]
        )
        status = torch.where(
            ~is_real, 0,
            torch.where(
                is_create, status_a,
                torch.where(
                    ok_rud, C.STATUS_CODE_SUCCESS,
                    torch.where(bad_recip, C.STATUS_CODE_INVALID_RECIPIENT,
                                C.STATUS_CODE_NOT_FOUND),
                ),
            ),
        ).to(I32)
        created = is_create & create_ok
        cr = created[:, None]
        okr = ok_rud[:, None]

        def pick(on_create, on_ok):
            return torch.where(cr, on_create, torch.where(okr, on_ok, 0))

        return {
            "status": status,
            "msg_id": pick(new_id, out_b["resp_id"]),
            "sender": pick(auth, out_b["resp_sender"]),
            "recipient": pick(recipient, out_b["resp_recipient"]),
            "timestamp": torch.where(
                (created | ok_rud)[:, None],
                torch.where(cr, now2[None, :], out_b["resp_ts"]),
                torch.where(is_real[:, None], now2[None, :], 0),
            ),
            "payload": pick(payload, out_b["resp_payload"]),
        }
