"""Checkpoint and journal seal scan for the port's durability layer (the
port's counterpart of the reference's ``tools/check_checkpoint_seal.py``).

Drives a durable engine whose every request carries a loud plaintext
marker in its payload, recipient and auth identity, runs a sweep and a
checkpoint, then scans every file the durability layer wrote for:

- the payload marker bytes (message content must be sealed);
- the fixture's recipient/auth identity bytes (metadata must be sealed);
- the 32-byte root seal key (key material must never reach a data file;
  the key lives only in its own 0600 key file, which the scan skips).

Run it (the card by default; ``--device cpu`` for the plain path)::

    python -m grapevine_tpu_torch.testing.checkpoint_seal --device cpu

Exit code 0 = clean, 1 = a violation or nothing to scan.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

#: recognizable, high-redundancy plaintext: a sealing slip of even a
#: few bytes of keystream reuse would still leave a whole marker copy
PAYLOAD_MARKER = b"GRAPEVINE-SEAL-CHECK-PLAINTEXT-MARKER/"


def _ident(n: int) -> bytes:
    base = b"SEALCHECK-IDENT-%02d/" % n
    return (base + b"\xaa" * 32)[:32]


def run_fixture(state_dir: str, device=None) -> dict:
    """Six rounds of marked creates, a sweep and a checkpoint against
    ``state_dir``; returns the byte patterns that must NOT appear in any
    sealed file."""
    from ..config import DurabilityConfig, GrapevineConfig
    from ..engine.batcher import GrapevineEngine
    from ..wire import constants as C
    from ..wire.records import QueryRequest, RequestRecord

    cfg = GrapevineConfig(
        max_messages=64, max_recipients=8, mailbox_cap=4,
        batch_size=4, stash_size=64, bucket_cipher_rounds=0,
    )
    dcfg = DurabilityConfig(state_dir=state_dir, checkpoint_every_rounds=3)
    engine = GrapevineEngine(cfg, seed=9, device=device, durability=dcfg)
    reps = C.PAYLOAD_SIZE // len(PAYLOAD_MARKER) + 1
    payload = (PAYLOAD_MARKER * reps)[: C.PAYLOAD_SIZE]
    now = 1_700_000_000
    for i in range(6):
        reqs = [
            QueryRequest(
                request_type=C.REQUEST_TYPE_CREATE,
                auth_identity=_ident(i % 4),
                auth_signature=b"\x01" * C.SIGNATURE_SIZE,
                record=RequestRecord(
                    msg_id=C.ZERO_MSG_ID,
                    recipient=_ident((i + 1) % 4),
                    payload=payload,
                ),
            )
            for _ in range(3)
        ]
        engine.handle_queries(reqs, now + i)
    engine.expire(now + 10, period=10_000)
    engine.checkpoint_now()
    root_key = engine.durability.root_key
    engine.close()
    return {
        "payload marker": PAYLOAD_MARKER,
        "recipient/auth identity": _ident(0)[:16],
        "root seal key": root_key,
    }


def state_files(state_dir: str) -> list[str]:
    """The regular files under ``state_dir``, sorted."""
    return sorted(n for n in os.listdir(state_dir)
                  if os.path.isfile(os.path.join(state_dir, n)))


def scan(state_dir: str, patterns: dict) -> list[str]:
    """One line per (file, pattern) found; the key file is skipped."""
    violations = []
    for name in state_files(state_dir):
        if name == "root.key":
            continue  # the key file is the key; everything else is data
        with open(os.path.join(state_dir, name), "rb") as fh:
            blob = fh.read()
        for label, pattern in patterns.items():
            if pattern in blob:
                violations.append(
                    f"{name}: contains plaintext {label} "
                    f"({len(pattern)} marker bytes found in a sealed file)")
    return violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="sealcheck-") as state_dir:
        patterns = run_fixture(state_dir, args.device)
        files = state_files(state_dir)
        if not any(n.startswith("ckpt-") for n in files) or not any(
                n.startswith("journal-") for n in files):
            print(f"SEAL SCAN BROKEN: the fixture wrote no checkpoint/journal "
                  f"files to scan (saw {files})", file=sys.stderr)
            return 1
        violations = scan(state_dir, patterns)
    for v in violations:
        print(f"CHECKPOINT SEAL VIOLATION: {v}", file=sys.stderr)
    if not violations:
        print(f"checkpoint seal: clean — {len(files)} state file(s) hold "
              "no plaintext payload, identity, or key material")
    return 1 if violations else 0


if __name__ == "__main__":
    raise SystemExit(main())
