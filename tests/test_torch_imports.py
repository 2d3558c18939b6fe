"""Package boundary of the PyTorch port: no module of
``grapevine_tpu_torch`` (nor ``chip_smoke.py``, ``chip_ab.py``) imports ``jax`` or the
JAX package ``grapevine_tpu``, and entry points never fall back to the
CPU silently."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "grapevine_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources():
    files = sorted((ROOT / "grapevine_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
    return files


def test_port_imports_no_jax_and_no_reference_package():
    files = _sources()
    assert len(files) > 15
    bad = [
        (str(p.relative_to(ROOT)), mod)
        for p in files
        for mod in _imports(p)
        if mod.split(".")[0] in FORBIDDEN
    ]
    assert bad == []


def test_import_scan_covers_the_expiry_and_durability_modules():
    """The sweep, the durability layer, the replication standby, the
    telemetry and their helpers are port modules of their own (own copies
    of the reference's jax-free journal, replication, fault injection, obs
    registry/exporter/httpd, the leak monitor and its statistics, the
    flight recorder, round tracer, SLO, workload, cost and profiler
    observers, the fleet aggregator, the adaptive window and the analytic
    cost model, and engine metrics) and the recursive position map and
    radix sort are too (own ports of ``oram/posmap.py`` and
    ``oblivious/radix.py``), and so are the scan vphases, the load
    harness and the checkpoint seal scan (own copies of ``load/`` and of
    the seal scan), and the op-major engine and its oracle (own copies of
    the reference's jax-free ``testing/reference.py``, ``ref_oram.py``,
    ``fixtures.py``, a torch port of ``compare.py``), and so is the device
    mesh (a port of ``parallel/``), so the boundary scan reads each of
    them."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for mod in ("engine/expiry.py", "engine/checkpoint.py", "engine/journal.py",
                "engine/replication.py",
                "oblivious/radix.py", "testing/faults.py", "engine/metrics.py",
                "obs/__init__.py", "obs/registry.py", "obs/phases.py",
                "obs/exporter.py", "obs/httpd.py",
                "obs/flightrec.py", "obs/tracer.py", "obs/slo.py", "obs/workload.py",
                "obs/costmon.py", "obs/profiler.py", "obs/leakmon.py", "obs/fleet.py",
                "analysis/__init__.py", "analysis/costmodel.py", "testing/leakcheck.py",
                "server/adaptive.py", "oram/posmap.py", "oram/round.py",
                "oblivious/segmented.py", "load/__init__.py", "load/generators.py",
                "load/capacity.py", "load/harness.py", "testing/checkpoint_seal.py",
                "engine/vphases.py", "oblivious/prp.py", "engine/step.py",
                "testing/reference.py", "testing/ref_oram.py", "testing/fixtures.py",
                "testing/compare.py", "parallel/__init__.py", "parallel/mesh.py"):
        path = f"grapevine_tpu_torch/{mod}"
        assert path in scanned, path
        assert not [m for m in _imports(ROOT / path) if m.split(".")[0] in FORBIDDEN]


def test_import_scan_covers_the_serving_tier():
    """The wire codec, the session layer, the native loader and the
    serving tier are port modules of their own (own copies of the
    reference's jax-free ``wire/protowire.py``, ``session/``, ``native/``
    and ``server/``), so the boundary scan reads each of them."""
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    mods = ["wire/protowire.py", "native/__init__.py"]
    mods += [f"session/{m}.py" for m in ("__init__", "stdcrypto", "chacha", "merlin",
                                         "ristretto", "schnorrkel", "channel")]
    mods += [f"server/{m}.py" for m in ("__init__", "uri", "scheduler", "service", "client",
                                        "tier", "hostpipe", "cli")]
    for mod in mods:
        path = f"grapevine_tpu_torch/{mod}"
        assert path in scanned, path
        assert not [m for m in _imports(ROOT / path) if m.split(".")[0] in FORBIDDEN]


def test_native_loader_compiles_only_the_ports_own_source():
    """``native/__init__.py`` builds the ``r255.c`` beside it (the port's
    copy) into the repository's ``build/``, never the reference's source or
    shared object."""
    from grapevine_tpu_torch import native

    here = ROOT / "grapevine_tpu_torch" / "native"
    assert native._SRC == here / "r255.c" and native._SRC.exists()
    assert native.BUILD_DIR == ROOT / "build"
    assert native.library_path().parent == ROOT / "build"
    assert native.library_path().name.startswith("libgv_r255-")
    text = (here / "__init__.py").read_text()
    assert "grapevine_tpu/" not in text.replace("``grapevine_tpu/native/__init__.py``", "")
    assert "_r255.so" not in text


def test_serving_modules_import_no_torch_at_the_top():
    """The client, the session layer, the wire codec, the CLI module and
    the host-pipeline worker's imports stay torch-free (a client process
    and a host-pipeline worker need no device runtime)."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import grapevine_tpu_torch.server.client, grapevine_tpu_torch.server.cli\n"
            "import grapevine_tpu_torch.server.hostpipe, grapevine_tpu_torch.server.scheduler\n"
            "import grapevine_tpu_torch.wire.protowire, grapevine_tpu_torch.wire.validate\n"
            "import grapevine_tpu_torch.session.schnorrkel, grapevine_tpu_torch.session.channel\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'grapevine_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True)


def test_import_scan_sees_forbidden_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\nfrom grapevine_tpu.config import X\n")
    assert [m.split(".")[0] for m in _imports(p)] == ["jax", "grapevine_tpu"]


def test_engine_without_cuda_raises(monkeypatch, tmp_path):
    """Every entry point that places state (the facade, ``init_engine``,
    ``from_jax_state``, the durability manager that loads checkpoints)
    defaults to the card and raises without one."""
    from grapevine_tpu_torch.config import DurabilityConfig, GrapevineConfig
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine
    from grapevine_tpu_torch.engine.checkpoint import DurabilityManager
    from grapevine_tpu_torch.engine.convert import from_jax_state, to_numpy
    from grapevine_tpu_torch.engine.state import EngineConfig, init_engine

    cfg = GrapevineConfig(max_messages=64, max_recipients=8)
    ecfg = EngineConfig.from_config(cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GrapevineEngine(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_engine(ecfg, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        DurabilityManager(DurabilityConfig(state_dir=str(tmp_path)), ecfg)
    eng = GrapevineEngine(cfg, device="cpu")
    assert eng.state.freelist.device.type == "cpu"
    leaves = to_numpy(eng.state)
    with pytest.raises(RuntimeError, match="CUDA"):
        from_jax_state(ecfg, leaves)
    st = init_engine(ecfg, 0, device="cpu")
    assert st.rec.tree_val.device.type == "cpu"
    assert from_jax_state(ecfg, leaves, device="cpu").mb.nonces.device.type == "cpu"


def test_pipelined_engine_without_cuda_raises(monkeypatch):
    """``pipeline_depth=2`` is ported, and a pipelined facade still
    defaults to the card and raises without one; on the CPU only when
    asked, where the depth is the configured one (auto: 1)."""
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GrapevineEngine(GrapevineConfig(max_messages=64, pipeline_depth=2))
    eng = GrapevineEngine(GrapevineConfig(max_messages=64, pipeline_depth=2), device="cpu")
    assert eng.pipeline_depth == 2
    assert GrapevineEngine(GrapevineConfig(max_messages=64), device="cpu").pipeline_depth == 1


@pytest.mark.parametrize("knob", [
    dict(vphases_impl="scan", shards=2), dict(commit="phase", shards=4),
    # the scan vphases, the recursive map and the radix sort run on a
    # mesh as on one device
    dict(vphases_impl="scan", posmap_impl="recursive", sort_impl="radix", shards=2),
    dict(evict_every=2, posmap_impl="recursive", shards=2), dict(shards=2),
    # the kernel impls too (the fused kernels give way to B2 on a mesh)
    dict(bucket_cipher_impl="pallas", shards=2),
    dict(bucket_cipher_impl="pallas_fused", evict_every=2, shards=2),
])
def test_unported_knobs_name_their_roadmap_item(knob):
    """Every knob value once refused for a later slice (the last were
    ``shards > 1``, ROADMAP.md queue A item 15) now resolves, and a CPU
    facade with it builds: at ``shards`` N on a virtual mesh of N CPU
    shards, with ``shards`` kept out of the engine config."""
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine.batcher import GrapevineEngine
    from grapevine_tpu_torch.engine.state import EngineConfig
    from grapevine_tpu_torch.oram.path_oram import ShardedPlane

    cfg = GrapevineConfig(max_messages=64, **knob)
    ecfg = EngineConfig.from_config(cfg)
    assert ecfg == EngineConfig.from_config(GrapevineConfig(max_messages=64, **dict(
        knob, shards=1)))
    eng = GrapevineEngine(cfg, device="cpu")
    assert eng.ecfg == ecfg and eng._mesh.size == knob["shards"]
    assert eng._mesh.devices == (torch.device("cpu"),) * knob["shards"]
    for tree in (eng.state.rec, eng.state.mb):
        assert isinstance(tree.tree_val, ShardedPlane)
        assert len(tree.nonces.shards) == knob["shards"]


@pytest.mark.parametrize("knob", [
    dict(evict_every=2), dict(evict_every=4, evict_buffer_slots=50),
    dict(bucket_cipher_impl="pallas"), dict(bucket_cipher_impl="pallas_fused"),
    dict(bucket_cipher_impl="pallas_fused_tiled", evict_every=3),
    dict(pipeline_depth=2), dict(sort_impl="radix"), dict(posmap_impl="recursive"),
    dict(evict_every=2, posmap_impl="recursive", sort_impl="radix",
         bucket_cipher_impl="pallas_fused"),
    dict(vphases_impl="scan"),
    dict(vphases_impl="scan", posmap_impl="recursive", sort_impl="radix"),
    dict(commit="op"), dict(commit="op", bucket_cipher_impl="pallas"),
])
def test_ported_knobs_are_accepted(knob):
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine.state import EngineConfig

    ecfg = EngineConfig.from_config(GrapevineConfig(max_messages=64, **knob))
    assert ecfg.evict_every == knob.get("evict_every", 1)
    assert ecfg.rec.cipher_impl == knob.get("bucket_cipher_impl", "jnp")
    assert ecfg.sort_impl == knob.get("sort_impl", "xla")
    assert ecfg.posmap_impl == knob.get("posmap_impl", "flat")
    assert ecfg.vphases_impl == knob.get("vphases_impl", "dense")
    assert (ecfg.rec.posmap is not None) == (ecfg.posmap_impl == "recursive")


def test_op_commit_resolves_as_the_reference():
    """``commit="op"`` builds (the op-major engine): no tree-top cache, one
    mailbox choice, and at the production point 8192 mailbox buckets
    (load 0.125), the reference's geometry; the phase-major engine keeps
    k=4 and two choices over 2048."""
    from grapevine_tpu_torch.config import GrapevineConfig
    from grapevine_tpu_torch.engine.state import EngineConfig

    prod = dict(max_messages=2**20, max_recipients=2**12)
    op = EngineConfig.from_config(GrapevineConfig(**prod, commit="op"))
    assert op.rec.top_cache_levels == op.mb.top_cache_levels == 0
    assert op.mb_choices == 1 and op.mb_table_buckets == 8192
    assert op.mb.height == 12 and op.rec.path_len == 20 and op.mb.path_len == 13
    assert (op.rec.row_words, op.mb.row_words) == (1028, 6084)
    phase = EngineConfig.from_config(GrapevineConfig(**prod))
    assert phase.rec.top_cache_levels == 4 and phase.mb_choices == 2
    assert phase.mb_table_buckets == 2048
