"""The port's kernels as graph nodes (``torch.ops.gv``, entered only
under a capture): a CPU capture of each ``pallas*`` round or flush shows
one node per launch, as many as an eager call of that impl launches; an
address operand derived from a secret is a gather/scatter-index finding
(B2 has none); outside a capture the op is never entered."""

from __future__ import annotations

import collections

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from grapevine_tpu_torch.analysis import check_oblivious as co
from grapevine_tpu_torch.analysis import fx_walk
from grapevine_tpu_torch.analysis.allowlist import ENGINE_ALLOWLIST
from grapevine_tpu_torch.analysis.oblint import analyze
from grapevine_tpu_torch.engine import round_step
from grapevine_tpu_torch.engine.state import init_engine
from grapevine_tpu_torch.oblivious import cipher_kernels as ck
from grapevine_tpu_torch.oblivious import gather_kernels as gk
from _torch_threads import one_torch_thread  # noqa: F401

#: (impl, evict_every, program): the kernel launches of one eager call
CASES = {
    ("pallas_fused_tiled", 1, "round"): {"gather_decrypt_rows_tiled": 3,
                                         "scatter_encrypt_rows_tiled": 3},
    ("pallas_fused", 2, "round"): {"gather_decrypt_rows": 3},
    ("pallas_fused", 2, "flush"): {"scatter_encrypt_rows": 2},
    ("pallas", 1, "round"): {"cipher_rows_pallas": 6},
}


def _wrapper_calls(monkeypatch) -> collections.Counter:
    """Count every call that would launch a kernel on the card: on the
    CPU a wrapper runs its plain version, one call per launch."""
    calls = collections.Counter()
    for mod, impl in ((gk, "_gather_impl"), (gk, "_scatter_impl")):
        orig = getattr(mod, impl)

        def counted(kernel, *a, _orig=orig, **k):
            calls[kernel] += 1
            return _orig(kernel, *a, **k)

        monkeypatch.setattr(mod, impl, counted)
    orig_c = ck._cipher_impl

    def counted_c(*a, **k):
        calls["cipher_rows_pallas"] += 1
        return orig_c(*a, **k)

    monkeypatch.setattr(ck, "_cipher_impl", counted_c)
    return calls


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: "_".join(map(str, c)))
def test_capture_shows_one_node_per_eager_launch(case, monkeypatch):
    impl, ee, prog = case
    ecfg = co.small_engine("dense", "xla", "flat", 0, ee, bucket_cipher_impl=impl)
    state = init_engine(ecfg, 0, device="cpu")
    rep = (co.audit_engine_round(ecfg, ENGINE_ALLOWLIST, impl, state=state, device="cpu")
           if prog == "round" else co.audit_engine_flush(ecfg, ENGINE_ALLOWLIST, impl,
                                                          state=state, device="cpu"))
    assert rep.ok, rep.summary()
    nodes = dict(fx_walk.kernel_nodes(rep.capture.gm))
    assert nodes == CASES[case]
    calls = _wrapper_calls(monkeypatch)
    if prog == "round":
        round_step.engine_round_step(ecfg, state, co.batch_spec(ecfg, "cpu"),
                                     draws=co.engine_draws(ecfg, state, "cpu"), fast_ok=True)
    else:
        round_step.engine_flush_step(ecfg, state)
    assert dict(calls) == nodes


def _tree(n=8, z=2, v=3):
    t = lambda *s: torch.zeros(s, dtype=torch.int32)  # noqa: E731
    return dict(key=t(8), tree_idx=t(n * z), tree_val=t(n, z * v), nonces=t(n, 2))


def test_secret_flat_b_into_b3_is_a_gather_index_finding():
    def fn(s, key, tree_idx, tree_val, nonces):
        return gk.gather_decrypt_rows(key, tree_idx, tree_val, nonces, s % 8, 2, 8)

    rep = analyze(fn, {"s": torch.zeros(3, dtype=torch.int32), **_tree()}, secrets=("s",))
    assert [(v.kind, v.prim) for v in rep.violations] == [
        ("gather-index", "gv.gather_decrypt_rows")]
    # the same program with a public flat_b and a secret key: clean
    rep = analyze(fn, {"s": torch.zeros(3, dtype=torch.int32), **_tree()},
                  secrets=("key",))
    assert rep.ok, rep.summary()


def test_secret_owner_into_b6_is_a_scatter_index_finding():
    def fn(s, key, tree_idx, tree_val, nonces):
        flat_b = torch.arange(3, dtype=torch.int32)
        out = gk.scatter_encrypt_rows_tiled(
            key, tree_idx, tree_val, nonces, flat_b, s > 0, torch.zeros(2, dtype=torch.int32),
            torch.zeros(3, 2, dtype=torch.int32), torch.zeros(3, 6, dtype=torch.int32), 2, 8)
        return out

    rep = analyze(fn, {"s": torch.zeros(3, dtype=torch.int32), **_tree()}, secrets=("s",))
    assert [(v.kind, v.prim) for v in rep.violations] == [
        ("scatter-index", "gv.scatter_encrypt_rows_tiled")]


def test_b2_has_no_address_operand():
    def fn(s, key):
        z = torch.zeros(3, 2, dtype=torch.int32)
        return ck.cipher_rows_pallas(key, s, torch.zeros(3, 2, dtype=torch.int32), z,
                                     torch.zeros(3, 6, dtype=torch.int32), 8)

    rep = analyze(fn, {"s": torch.zeros(3, dtype=torch.int32),
                       "key": torch.zeros(8, dtype=torch.int32)}, secrets=("s", "key"))
    assert rep.ok and dict(fx_walk.kernel_nodes(rep.capture.gm)) == {"cipher_rows_pallas": 1}


def test_outside_a_capture_the_op_is_never_entered():
    seen = collections.Counter()

    class Ops(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen[str(func).split(".")[0]] += 1
            return func(*args, **(kwargs or {}))

    ecfg = co.small_engine("dense", "xla", "flat", 0, 1, bucket_cipher_impl="pallas_fused_tiled")
    state = init_engine(ecfg, 0, device="cpu")
    with Ops():
        assert not gk.capturing()
        round_step.engine_round_step(ecfg, state, co.batch_spec(ecfg, "cpu"),
                                     draws=co.engine_draws(ecfg, state, "cpu"), fast_ok=True)
    assert seen["aten"] > 100 and seen["gv"] == 0, dict(seen)
