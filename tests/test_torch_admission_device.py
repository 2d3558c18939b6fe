"""The exact admission walk on the device (``engine/vphases.py:
_admission_slow``): the reference's scan over counters as a loop of
fixed-shape tensor ops, with no host read of the per-op vectors it walks
(their values — which ops create, which share a recipient — are secret).

Pinned three ways: a fake capture of a ``fast_ok=False`` round completes
(a host read would stop it on a data-dependent guard) and audits clean;
no host read happens while the walk runs; and the walk equals the
reference's jitted ``_admission_slow`` at tolerance 0 on near-saturation
inputs (free blocks and recipient room both within B of full)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grapevine_tpu.config import GrapevineConfig as JaxConfig
from grapevine_tpu.engine import vphases as jvp
from grapevine_tpu.engine.state import EngineConfig as JaxEngineConfig
from grapevine_tpu_torch.analysis import check_oblivious as co
from grapevine_tpu_torch.analysis import fx_walk
from grapevine_tpu_torch.analysis.allowlist import ENGINE_ALLOWLIST
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine import vphases
from grapevine_tpu_torch.engine.state import EngineConfig
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

GEOMETRIES = [dict(max_messages=64, max_recipients=16, batch_size=8),
              dict(max_messages=256, max_recipients=32, batch_size=32)]
NAMES = ("create_ok", "pop_ok", "claim_ok", "count_before", "can_alloc", "active")


def _walk_inputs(seed: int, b: int, cap: int, slots: int, max_recipients: int) -> dict:
    """Near-saturation admission inputs with the structure a round gives
    them: recipient groups (``rslot`` = the group's first slot) inside
    bucket groups (``gslot``), per-group found/count/free-slot values,
    creates and pops, the first create of each recipient group."""
    rng = np.random.default_rng(seed)
    n_rcp = max(2, b // 3)
    rg = rng.integers(0, n_rcp, b)
    bg = rg % max(1, n_rcp // 2)

    def first_slot(g):
        return np.array([int(np.argmax(g == g[j])) for j in range(b)], np.int32)

    found_g = rng.random(n_rcp) < 0.4
    count_g = np.where(found_g, rng.integers(0, cap + 1, n_rcp), 0)
    free_g = rng.integers(0, slots + 1, n_rcp)
    kind = rng.integers(0, 3, b)
    create = kind == 1
    first_create = np.array([create[j] and not create[:j][rg[:j] == rg[j]].any()
                             for j in range(b)])
    return dict(
        is_create_cand=create, is_pop_cand=kind == 2, found0=found_g[rg],
        first_create=first_create, free_slots0=free_g[bg].astype(np.int32),
        init_count=count_g[rg].astype(np.int32), rslot=first_slot(rg),
        gslot=first_slot(bg), free_top0=np.int32(rng.integers(0, b)),
        recipients0=np.int32(max_recipients - rng.integers(1, b + 1) // 2),
    )


def _reference(jecfg, inp: dict) -> dict:
    u32 = ("rslot", "gslot", "free_top0", "recipients0")
    args = {k: jnp.asarray(v.astype(np.uint32) if k in u32 else v)
            for k, v in inp.items()}
    out = jax.jit(lambda a: jvp._admission_slow(jecfg, **a))(args)
    return {k: np.asarray(out[k]) for k in NAMES}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("geo", range(len(GEOMETRIES)))
def test_device_walk_equals_the_reference(geo, seed):
    kw = GEOMETRIES[geo]
    ecfg = EngineConfig.from_config(GrapevineConfig(**kw))
    jecfg = JaxEngineConfig.from_config(JaxConfig(**kw))
    inp = _walk_inputs(seed, kw["batch_size"], ecfg.mailbox_cap, ecfg.mb_slots,
                       ecfg.max_recipients)
    out = vphases._admission_slow(ecfg, **{k: torch.as_tensor(v) for k, v in inp.items()})
    ref = _reference(jecfg, inp)
    assert out["count_before"].dtype == torch.int32
    assert all(out[k].dtype == torch.bool for k in NAMES if k != "count_before")
    for k in NAMES:
        np.testing.assert_array_equal(out[k].numpy(), ref[k].astype(out[k].numpy().dtype),
                                      err_msg=k)
    # the inputs really are near saturation: the walk refused something
    assert not ref["can_alloc"].all() or not (ref["claim_ok"] | ~inp["first_create"]).all()


def test_device_walk_reads_nothing_back():
    reads = []

    class Spy(torch.overrides.TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            name = getattr(func, "__name__", "")
            if name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                        "__index__"):
                reads.append(name)
            return func(*args, **(kwargs or {}))

    ecfg = EngineConfig.from_config(GrapevineConfig(**GEOMETRIES[0]))
    inp = _walk_inputs(3, 8, ecfg.mailbox_cap, ecfg.mb_slots, ecfg.max_recipients)
    with Spy():
        vphases._admission_slow(ecfg, **{k: torch.as_tensor(v) for k, v in inp.items()})
    assert reads == []


def test_slow_branch_round_captures_and_audits_clean():
    """The whole ``fast_ok=False`` round captures (no host read stops
    it), its graph holds no read of a value by the host, and the walk's
    sinks are the reviewed ones."""
    ecfg = co.small_engine(*co.SMOKE_COMBO)
    rep = co.audit_engine_round(ecfg, ENGINE_ALLOWLIST, "slow", fast_ok=False,
                                 device="cpu")
    assert rep.capture.gm is not None and rep.ok, rep.summary()
    ops = {fx_walk.op_name(n.target) for n in fx_walk.walk_nodes(rep.capture.gm)}
    assert not ops & {"gv_analysis.host_read.default", "aten._local_scalar_dense.default"}
    walk = {k for k in rep.allowed if k.endswith("engine/vphases.py:_admission_slow")}
    assert walk == {"aten.index@engine/vphases.py:_admission_slow",
                    "aten.index_put@engine/vphases.py:_admission_slow"}
