"""The port's taint audit over the reference's default knob sweep
(``check_oblivious.DEFAULT_COMBOS``, each with the bucket cipher of
``DEFAULT_CIPHER_IMPLS`` so every kernel's address operands are
audited): the engine round at both admission branches, the sweep, the
flush, and the ORAM sub-rounds on one device and on a 2-shard virtual
mesh are free of violations, and every allowlist entry is reached
somewhere (a dead entry fails). One process per combination."""

from __future__ import annotations

from grapevine_tpu_torch.analysis import check_oblivious as co
from grapevine_tpu_torch.analysis.allowlist import ENGINE_ALLOWLIST
from _torch_threads import one_torch_thread  # noqa: F401


def test_default_sweep_is_violation_free_and_reaches_every_entry():
    problems, hits = co.run_audit(co.DEFAULT_COMBOS, with_census=False,
                                  cipher_impls=co.DEFAULT_CIPHER_IMPLS,
                                  jobs=len(co.DEFAULT_COMBOS), device="cpu")
    assert problems == []
    assert co.check_allowlist_reachability(hits) == []
    assert set(hits) == {e.key for e in ENGINE_ALLOWLIST}
    # the kernel ops' address operands were audited
    assert {k.split("@")[0] for k in hits if k.startswith("gv.")} == {
        "gv.gather_decrypt_rows", "gv.gather_decrypt_rows_tiled",
        "gv.scatter_encrypt_rows_tiled"}
