"""The port's op-major engine step (``grapevine_tpu_torch/engine/step.py:
engine_step``) held against ``grapevine_tpu/engine/step.py:engine_step``
at tolerance 0.

A multi-round CRUD campaign goes through both packages from one state
carried across (``convert.from_jax_state``), each round fed the same
batch and the same random draws: the port's ``draws=`` are the JAX
step's own (``jax.random.split(state.rng, 5)`` … ``bits``, as
``step.py:306-310`` draws them). After every round the responses, the
``[B, 3]`` transcripts and every state leaf must be equal. The rounds mix
creates, reads, updates and deletes by id, zero-id reads and deletes
(pops), stale ids, a delete whose id matches on words 0-1 only (it must
change nothing), padding, and a round of creates to one recipient past
the mailbox cap. This file: geometry ``g1`` under the plain ``"jnp"``
cipher; ``test_torch_engine_step2.py``: ``g2`` under ``"pallas"`` (the
reference in Pallas interpret mode, the port's kernel wrapper taking its
plain version on CPU tensors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.state import EngineConfig as JEcfg, init_engine
from grapevine_tpu.engine.step import engine_step as jax_engine_step
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import batch_to_device
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.state import EngineConfig
from grapevine_tpu_torch.engine.step import StepDraws, engine_step
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.u32 import to_numpy as t2n
from grapevine_tpu_torch.wire import constants as C
from test_torch_engine import crud_batches, jax_leaves
from _torch_jax_cache import shared_jax_compile_cache  # noqa: F401

U32 = jnp.uint32

#: two op-major geometries (one mailbox choice and no tree-top cache, as
#: ``commit="op"`` resolves): a minimal engine, and a taller records tree
#: with two blocks a leaf and a wider mailbox
GEOMETRIES = {
    "g1": dict(max_messages=64, max_recipients=8, mailbox_cap=4, batch_size=8,
               stash_size=64),
    "g2": dict(max_messages=256, max_recipients=16, mailbox_cap=6, batch_size=12,
               stash_size=80, tree_density=2),
}

#: jitted once per geometry, as the reference's facade jits its step
_jax_step = jax.jit(jax_engine_step, static_argnums=(0,), donate_argnums=(1,))


def jax_step_draws(ecfg, rng, b) -> list:
    """The reference step's draws, exactly as ``step.py:306-310``."""
    k_a, k_b, k_c, k_id, _ = jax.random.split(rng, 5)
    mbm, recm = U32(ecfg.mb.leaves - 1), U32(ecfg.rec.leaves - 1)
    return [np.asarray(x) for x in (
        jax.random.bits(k_a, (b,), U32) & mbm,
        jax.random.bits(k_b, (b,), U32) & recm,
        jax.random.bits(k_c, (b,), U32) & mbm,
        jax.random.bits(k_id, (b, 3), U32),
    )]


def _half_guessed(mid: bytes) -> bytes:
    """Words 0-1 of a real id (its block and nonce), words 2-3 wrong."""
    return mid[:8] + bytes(x ^ 0xFF for x in mid[8:])


def op_batches(b, n_rounds, seed, created):
    """``crud_batches`` plus, in every round after the first, a DELETE of
    a known message by its recipient under a half-guessed id, and one
    round of creates to a single recipient past the mailbox cap."""
    rng = np.random.default_rng(seed + 1000)
    for rnd, batch in enumerate(crud_batches(b, n_rounds, seed, lambda: created)):
        if rnd == 2:
            who = np.frombuffer(bytes([9]) * 32, "<u4")
            batch["req_type"][:] = C.REQUEST_TYPE_CREATE
            batch["recipient"][:] = who
            batch["auth"][:] = np.frombuffer(bytes([1]) * 32, "<u4")
        elif rnd > 0 and created:
            mid, _snd, rcp = created[rng.integers(len(created))]
            i = b - 1
            batch["req_type"][i] = C.REQUEST_TYPE_DELETE
            batch["auth"][i] = np.frombuffer(rcp, "<u4")
            batch["recipient"][i] = np.frombuffer(rcp, "<u4")
            batch["msg_id"][i] = np.frombuffer(_half_guessed(mid), "<u4")
        yield batch


def run_step_campaign(geo: str, seed: int, impl: str, n_rounds: int = 5) -> dict:
    kw = dict(GEOMETRIES[geo], commit="op", bucket_cipher_impl=impl)
    jecfg = JEcfg.from_config(JConfig(**kw))
    tecfg = EngineConfig.from_config(GrapevineConfig(**kw))
    assert tecfg.rec.top_cache_levels == tecfg.mb.top_cache_levels == 0
    assert tecfg.mb_choices == jecfg.mb_choices == 1
    jst = init_engine(jecfg, seed)
    tst = from_jax_state(tecfg, jax_leaves(jst), device="cpu")
    created: list = []  # (msg_id bytes, sender, recipient) from the reference
    seen: dict = {}
    b = tecfg.batch_size
    for rnd, batch in enumerate(op_batches(b, n_rounds, seed, created)):
        draws = StepDraws(*(from_numpy(x, "cpu") for x in jax_step_draws(jecfg, jst.rng, b)))
        jst, jresp, jtr = _jax_step(jecfg, jst, {k: jnp.asarray(v) for k, v in batch.items()})
        tst, tresp, ttr = engine_step(tecfg, tst, batch_to_device(batch, "cpu"), draws=draws)
        where = f"{geo}/{impl}/seed {seed} round {rnd}"
        for k in jresp:
            np.testing.assert_array_equal(t2n(tresp[k]), np.asarray(jresp[k]),
                                          f"{where}: response {k}")
        assert tuple(ttr.shape) == (b, 3)
        np.testing.assert_array_equal(t2n(ttr), np.asarray(jtr), f"{where}: transcript")
        diff = first_difference(to_numpy(tst), jax_leaves(jst), mask_junk=False)
        assert diff is None, f"{where}: state differs at {diff}"
        st = np.asarray(jresp["status"])
        for i, (t, s) in enumerate(zip(batch["req_type"], st)):
            seen.setdefault((int(t), int(s)), 0)
            seen[(int(t), int(s))] += 1
            if t == C.REQUEST_TYPE_CREATE and s == C.STATUS_CODE_SUCCESS:
                created.append((np.asarray(jresp["msg_id"])[i].tobytes(),
                                batch["auth"][i].tobytes(), batch["recipient"][i].tobytes()))
    assert int(np.asarray(jst.rec.overflow)) == int(np.asarray(jst.mb.overflow)) == 0
    return seen


def _check_coverage(seen: dict) -> None:
    """The campaign reached the cases it is meant to hold."""
    assert seen.get((C.REQUEST_TYPE_CREATE, C.STATUS_CODE_SUCCESS))
    assert seen.get((C.REQUEST_TYPE_CREATE, C.STATUS_CODE_TOO_MANY_MESSAGES_FOR_RECIPIENT))
    assert seen.get((C.REQUEST_TYPE_DELETE, C.STATUS_CODE_NOT_FOUND))
    assert seen.get((C.REQUEST_TYPE_DELETE, C.STATUS_CODE_SUCCESS))
    assert seen.get((C.REQUEST_TYPE_READ, C.STATUS_CODE_SUCCESS))


@pytest.mark.parametrize("seed", [3, 4])
def test_engine_step_matches_jax_g1_jnp(seed):
    _check_coverage(run_step_campaign("g1", seed, "jnp"))
