"""The port's checkpoint seal scan (``testing/checkpoint_seal.py``): a
durable port engine fed marked plaintext in payload, recipient and
identity leaves no marker and no root key in any file under its state
dir, and the scan does see a marker where one is planted."""

import os

from grapevine_tpu_torch.testing import checkpoint_seal as cs
from _torch_threads import one_torch_thread  # noqa: F401


def test_port_checkpoint_seal_scan_is_clean(capsys):
    assert cs.main(["--device", "cpu"]) == 0
    assert "clean" in capsys.readouterr().out


def test_seal_scan_flags_planted_plaintext(tmp_path):
    patterns = cs.run_fixture(str(tmp_path), device="cpu")
    files = cs.state_files(str(tmp_path))
    assert any(n.startswith("ckpt-") for n in files)
    assert any(n.startswith("journal-") for n in files)
    assert len(patterns["root seal key"]) == 32
    assert cs.scan(str(tmp_path), patterns) == []
    # the key file itself is skipped; a copy of the key anywhere else,
    # or a plaintext marker, is a violation
    with open(tmp_path / "leak.bin", "wb") as fh:
        fh.write(b"xx" + cs.PAYLOAD_MARKER + patterns["root seal key"])
    found = cs.scan(str(tmp_path), patterns)
    assert len(found) == 2 and all(v.startswith("leak.bin") for v in found)
    os.remove(tmp_path / "leak.bin")
