"""A/B two checkouts of the port on one NVIDIA card, with one kernel timer.

    python3 chip_ab.py OTHER_DIR [--out DIR]

Runs ``chip_smoke.py`` four times in turns — OTHER_DIR, this checkout,
this checkout, OTHER_DIR — each in its own process from its own
checkout (its own package and kernel build), but every run's kernel
times read with THIS checkout's ``chip_smoke.cuda_ms``, so a change of
the timer cannot pass for a change of a kernel. Each run's whole output
goes to ``--out`` (default ``chiprun_out/ab``); the summary prints one
JSON line per kernel (time per call at each shape and per path, the
four runs in order), one line of the slices' medians, the card, and
last ``{"ok": true}``. Any run that fails fails the script.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent

#: run OTHER's chip_smoke.main() with this checkout's cuda_ms; the
#: checkout's own directory comes first on sys.path ('' for ``-c``)
DRIVER = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("timer_source", {timer!r})
timer = importlib.util.module_from_spec(spec)
spec.loader.exec_module(timer)
import chip_smoke
chip_smoke.cuda_ms = timer.cuda_ms
sys.exit(chip_smoke.main())
"""


def run(tree: Path, out: Path) -> list[dict]:
    res = subprocess.run(
        [sys.executable, "-c", DRIVER.format(timer=str(ROOT / "chip_smoke.py"))],
        cwd=tree, capture_output=True, text=True)
    out.write_text(res.stdout + "\n# stderr\n" + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"chip_smoke in {tree} exited {res.returncode}; see {out}")
    return [json.loads(line) for line in res.stdout.splitlines() if line.startswith("{")]


def summary(lines: list[dict]) -> tuple[dict, dict, str]:
    """(kernel → {"per_path": ms, "<tree> <shape>": ms}, slice medians, card)."""
    kern = next(x["kernels"] for x in lines if "kernels" in x)
    times = {k["name"]: dict({f"{s['tree']} {s['shape']}": s["ms"] for s in k["shapes"]},
                             per_path=k["ms"]) for k in kern}
    e1 = next(x for x in lines if "slice" in x)
    e4 = next(x["evict_slice"] for x in lines if "evict_slice" in x)
    pallas = next(x["pallas_slice"] for x in lines if "pallas_slice" in x)
    med = {"e1_median_round_ms": e1["median_round_ms"],
           "e4_median_fetch_round_ms": e4["median_fetch_round_ms"],
           "e4_median_flush_ms": e4["median_flush_ms"],
           "pallas_median_round_ms": pallas["median_round_ms"]}
    return times, med, next(x["card"] for x in lines if "card" in x)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path, default=ROOT / "chiprun_out" / "ab")
    args = ap.parse_args()
    args.out.mkdir(parents=True, exist_ok=True)
    order = [("other", args.other.resolve()), ("this", ROOT),
             ("this", ROOT), ("other", args.other.resolve())]
    runs = [summary(run(tree, args.out / f"{i}-{label}.jsonl"))
            for i, (label, tree) in enumerate(order)]
    labels = [label for label, _ in order]
    for name in runs[0][0]:
        print(json.dumps({"kernel": name, "runs": labels,
                          "ms": {k: [r[0][name][k] for r in runs]
                                 for k in runs[0][0][name]}}))
    print(json.dumps({"medians": {k: [r[1][k] for r in runs] for k in runs[0][1]},
                      "runs": labels}))
    print(json.dumps({"cards": [r[2] for r in runs]}))
    print(json.dumps({"ok": True}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
