"""Census equality of the port's engine round at the reference's smoke
combination: captured in real mode from one state and one set of draws
at adversarially different batches (all padding, all creates, every op
on one recipient and one id, a mix), the round is one program, output
shapes included; and the check has teeth."""

from __future__ import annotations

import torch

from grapevine_tpu_torch.analysis import check_oblivious as co
from grapevine_tpu_torch.analysis.oblint import census_equal
from _torch_threads import one_torch_thread  # noqa: F401


def test_round_censuses_equal_over_adversarial_batches():
    ecfg = co.small_engine(*co.SMOKE_COMBO)
    assert co.census_equal_engine(ecfg, co.combo_name(co.SMOKE_COMBO), device="cpu") == []


def test_census_equal_catches_a_batch_dependent_program():
    """The check has teeth: a program shaped by a batch value read on the
    host beforehand (a count of creates) captures two programs; the same
    read inside the capture stops it."""
    def fn(req_type, x):
        return x[: int((req_type == 1).sum())] * 2

    create, read = torch.ones(4, dtype=torch.int32), torch.full((4,), 2, dtype=torch.int32)
    out = census_equal({
        v: (lambda x, k=int((rt == 1).sum()): x[:k] * 2, (torch.zeros(4),))
        for v, rt in (("create", create), ("read", read))
    })
    assert [v.kind for v in out] == ["program-mismatch"]
    out = census_equal({"create": (fn, (create, torch.zeros(4)))})
    assert [v.kind for v in out] == ["trace-dependence"]
