"""The 2048-byte record option of the port (``GRAPEVINE_RECORD_SIZE``, read
once at import by ``grapevine_tpu_torch/wire/constants.py``; the
reference's ``tests/test_record_2048.py`` is the model).

Each case runs in a subprocess started with ``GRAPEVINE_RECORD_SIZE=2048``:
the wire layer's constant-size property at the 2 KB geometry (1960-byte
payloads, 2052-byte responses, 512-word record rows), then a CRUD campaign
of the port's engine on the CPU through each ``bucket_cipher_impl`` (its
kernels' plain versions on the CPU) against a dict model: creates into
two mailboxes, reads by id, an update, a delete, a read of the deleted id
and a zero-id read and pop, every status and payload checked. A size other than
1024 or 2048 is refused at import.

The port's engine round at 2 KB records is also held against the JAX
package's, which reads the same variable: from one carried-across
initial state, fed the same random draws and the same random CRUD
rounds (``test_torch_engine.crud_batches``: payloads random word by word),
the port's round under each ``bucket_cipher_impl`` gives the responses,
the transcript and the state of the JAX round under ``"jnp"`` (8 ChaCha
rounds), leaf for leaf after every round, at tolerance 0; the junk
bucket is masked where a kernel's plain version writes it.
"""

import os
import subprocess
import sys

import pytest
from _torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WIRE = r"""
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, QueryResponse, Record, RequestRecord
from grapevine_tpu_torch.engine.state import PAYLOAD_WORDS, REC_WORDS

assert C.RECORD_SIZE == 2048 and C.PAYLOAD_SIZE == 1960
sizes = set()
for fill in (b"\x00", b"\xaa", b"\xff"):
    req = QueryRequest(
        request_type=C.REQUEST_TYPE_CREATE, auth_identity=fill * 32,
        auth_signature=fill * 64,
        record=RequestRecord(msg_id=fill * 16, recipient=fill * 32,
                             payload=fill * C.PAYLOAD_SIZE))
    sizes.add(len(req.pack()))
    assert RequestRecord.unpack(req.pack()[4 + 32 + 64:]).payload == fill * C.PAYLOAD_SIZE
assert sizes == {C.QUERY_REQUEST_WIRE_SIZE}
resp = QueryResponse(record=Record(payload=b"\x07" * C.PAYLOAD_SIZE),
                     status_code=C.STATUS_CODE_SUCCESS)
assert len(resp.pack()) == C.QUERY_RESPONSE_WIRE_SIZE == 2052
assert QueryResponse.unpack(resp.pack()).record.payload == b"\x07" * C.PAYLOAD_SIZE
assert (PAYLOAD_WORDS, REC_WORDS) == (490, 512)
print("RECORD2048_OK")
"""

_ENGINE = r"""
import sys
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import GrapevineEngine
from grapevine_tpu_torch.wire import constants as C
from grapevine_tpu_torch.wire.records import QueryRequest, RequestRecord

impl = sys.argv[1]
cfg = GrapevineConfig(bucket_cipher_rounds=8, max_messages=64, max_recipients=8,
                      mailbox_cap=4, batch_size=4, stash_size=64,
                      bucket_cipher_impl=impl, evict_every=2 if impl == "pallas_fused" else 1)
e = GrapevineEngine(cfg, seed=1, device="cpu")
assert (e.ecfg.rec.value_words, e.ecfg.rec.row_words) == (512, 4 + 4 * 512)
NOW = 1_700_000_000
A, B, X = b"\x11" * 32, b"\x22" * 32, b"\x33" * 32


def q(rt, auth, mid=bytes(16), rcp=bytes(32), fill=0):
    return QueryRequest(request_type=rt, auth_identity=auth, record=RequestRecord(
        msg_id=mid, recipient=rcp, payload=bytes([fill]) * C.PAYLOAD_SIZE))


model = {}  # msg_id -> (sender, recipient, payload byte)
r = e.handle_queries([q(C.REQUEST_TYPE_CREATE, A, rcp=B, fill=9),
                      q(C.REQUEST_TYPE_CREATE, A, rcp=B, fill=10),
                      q(C.REQUEST_TYPE_CREATE, B, rcp=X, fill=11),
                      q(C.REQUEST_TYPE_CREATE, X, rcp=X, fill=12)], NOW)
for resp, (snd, rcp, fill) in zip(r, [(A, B, 9), (A, B, 10), (B, X, 11), (X, X, 12)]):
    assert resp.status_code == C.STATUS_CODE_SUCCESS, resp.status_code
    assert resp.record.msg_id != bytes(16)
    model[resp.record.msg_id] = (snd, rcp, fill)
ids = list(model)
r = e.handle_queries([q(C.REQUEST_TYPE_READ, model[m][1], mid=m) for m in ids], NOW + 1)
for resp, m in zip(r, ids):
    assert resp.status_code == C.STATUS_CODE_SUCCESS
    assert resp.record.payload == bytes([model[m][2]]) * C.PAYLOAD_SIZE
    assert resp.record.recipient == model[m][1]
r = e.handle_queries([q(C.REQUEST_TYPE_UPDATE, A, mid=ids[0], rcp=B, fill=0x44),
                      q(C.REQUEST_TYPE_DELETE, B, mid=ids[1], rcp=B)], NOW + 2)
assert [x.status_code for x in r] == [C.STATUS_CODE_SUCCESS] * 2
assert r[1].record.payload == bytes([10]) * C.PAYLOAD_SIZE
model[ids[0]] = (A, B, 0x44)
del model[ids[1]]
r = e.handle_queries([q(C.REQUEST_TYPE_READ, B, mid=ids[0]),
                      q(C.REQUEST_TYPE_READ, B, mid=ids[1]),
                      q(C.REQUEST_TYPE_READ, X),
                      q(C.REQUEST_TYPE_DELETE, X)], NOW + 3)
assert r[0].status_code == C.STATUS_CODE_SUCCESS
assert r[0].record.payload == bytes([0x44]) * C.PAYLOAD_SIZE
assert r[1].status_code == C.STATUS_CODE_NOT_FOUND
# a zero-id read returns mailbox X's oldest message, a zero-id delete pops it
assert [x.status_code for x in r[2:]] == [C.STATUS_CODE_SUCCESS] * 2
assert [x.record.payload for x in r[2:]] == [bytes([11]) * C.PAYLOAD_SIZE] * 2
assert e.message_count() == 2, e.message_count()
print("RECORD2048_ENGINE_OK", impl)
"""


_HELD = r"""
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_disable_most_optimizations", True)
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, "tests")
import test_torch_engine as te
from grapevine_tpu.config import GrapevineConfig as JConfig
from grapevine_tpu.engine.state import REC_WORDS as J_REC_WORDS
from grapevine_tpu.engine.state import EngineConfig as JEcfg, init_engine
from grapevine_tpu_torch.config import GrapevineConfig
from grapevine_tpu_torch.engine.batcher import batch_to_device
from grapevine_tpu_torch.engine.convert import first_difference, from_jax_state, to_numpy
from grapevine_tpu_torch.engine.round_step import RoundDraws, engine_round_step
from grapevine_tpu_torch.engine.state import REC_WORDS, EngineConfig
from grapevine_tpu_torch.u32 import from_numpy
from grapevine_tpu_torch.u32 import to_numpy as t2n
from grapevine_tpu_torch.wire import constants as C

assert J_REC_WORDS == REC_WORDS == 512
impls = sys.argv[1:]
kw = dict(te.GEOMETRIES["g1"], vphases_impl="dense")
jecfg = JEcfg.from_config(JConfig(**kw, bucket_cipher_impl="jnp"))
tecfg = {i: EngineConfig.from_config(GrapevineConfig(**kw, bucket_cipher_impl=i))
         for i in impls}
jst = init_engine(jecfg, 3)
tst = {i: from_jax_state(c, te.jax_leaves(jst), device="cpu") for i, c in tecfg.items()}
created, reads = [], 0
b = jecfg.batch_size
for rnd, batch in enumerate(te.crud_batches(b, 4, 3, lambda: created)):
    draws = te.jax_draws(jecfg, jst.rng, b)
    jst, jresp, jtr = te._jax_step(jecfg, jst, {k: jnp.asarray(v) for k, v in batch.items()})
    want = te.jax_leaves(jst)
    for i in impls:
        tst[i], tresp, ttr = engine_round_step(
            tecfg[i], tst[i], batch_to_device(batch, "cpu"),
            draws=RoundDraws(*(from_numpy(x, "cpu") for x in draws)))
        for k in jresp:
            np.testing.assert_array_equal(t2n(tresp[k]), np.asarray(jresp[k]),
                                          f"{i} round {rnd}: response {k}")
        np.testing.assert_array_equal(t2n(ttr), np.asarray(jtr),
                                      f"{i} round {rnd}: transcript")
        diff = first_difference(to_numpy(tst[i]), want, mask_junk=i != "jnp")
        assert diff is None, f"{i} round {rnd}: state differs at {diff}"
    st, pay = np.asarray(jresp["status"]), np.asarray(jresp["payload"])
    ok = st == C.STATUS_CODE_SUCCESS
    for j in np.flatnonzero((batch["req_type"] == C.REQUEST_TYPE_CREATE) & ok):
        created.append((np.asarray(jresp["msg_id"])[j].tobytes(),
                        batch["auth"][j].tobytes(), batch["recipient"][j].tobytes()))
    # reads that returned a record whose bytes vary along the row
    read = (batch["req_type"] == C.REQUEST_TYPE_READ) & ok
    reads += int(sum(len(np.unique(pay[j].view(np.uint8))) > 200
                     for j in np.flatnonzero(read)))
assert created and reads, (len(created), reads)
print("RECORD2048_JAX_OK", " ".join(impls))
"""


def _run(code: str, *argv: str, size: str = "2048"):
    env = dict(os.environ, GRAPEVINE_RECORD_SIZE=size)
    return subprocess.run([sys.executable, "-c", code, *argv], env=env,
                          capture_output=True, text=True, timeout=300, cwd=REPO)


def test_2048_byte_wire_layer():
    out = _run(_WIRE)
    assert "RECORD2048_OK" in out.stdout, out.stderr[-2000:]


@pytest.mark.parametrize("impl", ["jnp", "pallas", "pallas_fused", "pallas_fused_tiled"])
def test_2048_byte_engine_crud_matches_the_model(impl):
    out = _run(_ENGINE, impl)
    assert f"RECORD2048_ENGINE_OK {impl}" in out.stdout, out.stderr[-3000:]


def test_2048_byte_engine_round_equals_jax():
    impls = ("jnp", "pallas", "pallas_fused", "pallas_fused_tiled")
    out = _run(_HELD, *impls)
    assert f"RECORD2048_JAX_OK {' '.join(impls)}" in out.stdout, out.stderr[-3000:]


def test_invalid_record_size_rejected():
    out = _run("from grapevine_tpu_torch.wire import constants", size="1536")
    assert out.returncode != 0 and "1024 or 2048" in out.stderr
